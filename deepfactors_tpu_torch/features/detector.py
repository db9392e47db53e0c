"""Feature detection: Harris-scored corners with oriented binary descriptors.

PyTorch port of ``deepfactors_tpu/features/detector.py`` (replacement for
the reference's BRISK/ORB detectors, sources/core/features/
feature_detection.h:47-120). Static keypoint capacity with validity masks:

  Harris response (Sobel products + box filter)
  -> non-max suppression (max-pool equality)
  -> top-K scores (a stable descending sort: among equal scores the lower
     index comes first, as ``lax.top_k`` orders them)
  -> intensity-centroid orientation (ORB-style)
  -> rotated-BRIEF 256-bit descriptors packed into 8 32-bit words

Descriptors are stored as ``int32`` holding the bits of the JAX package's
``uint32`` words (PyTorch has few ``uint32`` operators): carrying them
across is ``np.asarray(desc).view(np.int32)``, which
``features_from_numpy`` / ``features_to_numpy`` do.

Plain PyTorch on the device of its input: no hand-written kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.image import _conv2d_clamped, bilinear_sample

Tensor = torch.Tensor


class Features(NamedTuple):
    """Fixed-capacity keypoint set (df::Features, feature_detection.h:33-45)."""

    xy: Tensor          # [K, 2] float pixel coords (x, y)
    score: Tensor       # [K]
    angle: Tensor       # [K] radians
    descriptor: Tensor  # [K, 8] int32 (the bits of 256-bit binary words)
    valid: Tensor       # [K] bool


class DetectorConfig(NamedTuple):
    max_keypoints: int = 400
    harris_k: float = 0.04
    nms_radius: int = 2
    border: int = 16           # keep descriptors inside the image
    # validity: score > max(score_threshold, rel_threshold * best_score)
    score_threshold: float = 1e-9
    rel_threshold: float = 1e-5
    patch_radius: int = 15     # BRIEF pattern radius
    octaves: int = 3           # scale-space levels used by detect_pyramid
    # spatial-uniformity grid cell in level-0 pixels; 0 disables
    uniformity_cell: int = 10


def _brief_pattern(n_bits: int = 256, radius: int = 15, seed: int = 7):
    """Fixed Gaussian-distributed test-pair pattern (BRIEF-style), numpy:
    the same draws as the JAX package's, bit for bit."""
    rng = np.random.RandomState(seed)
    sigma = radius / 2.5
    pts = np.clip(rng.randn(n_bits, 4) * sigma, -radius, radius)
    return pts.astype(np.float32)  # [256, 4] = (x1, y1, x2, y2)


_PATTERN = _brief_pattern()
_SOBEL_X8 = np.array([[-1., 0., 1.], [-2., 0., 2.], [-1., 0., 1.]]) / 8.0
_SOBEL_Y8 = np.array([[-1., -2., -1.], [0., 0., 0.], [1., 2., 1.]]) / 8.0
_BOX = np.ones((3, 3), np.float32) / 9.0


def _orientation_offsets(radius: int = 7) -> np.ndarray:
    offs = [(dx, dy) for dy in range(-radius, radius + 1)
            for dx in range(-radius, radius + 1)
            if dx * dx + dy * dy <= radius * radius]
    return np.asarray(offs, np.float32)   # [O, 2]


_ORIENT_OFFS = _orientation_offsets()
_DEVICE_CONSTS: dict = {}


def _consts(device):
    """(orientation offsets, BRIEF pattern) on ``device``, uploaded once: a
    copy from pageable host memory synchronises the stream."""
    key = str(device)
    if key not in _DEVICE_CONSTS:
        _DEVICE_CONSTS[key] = (torch.as_tensor(_ORIENT_OFFS, device=device),
                               torch.as_tensor(_PATTERN, device=device))
    return _DEVICE_CONSTS[key]


def harris_response(img: Tensor, k: float = 0.04) -> Tensor:
    """Harris corner response via Sobel products + 3x3 box filter."""
    gx = _conv2d_clamped(img, _SOBEL_X8)
    gy = _conv2d_clamped(img, _SOBEL_Y8)
    sxx = _conv2d_clamped(gx * gx, _BOX)
    syy = _conv2d_clamped(gy * gy, _BOX)
    sxy = _conv2d_clamped(gx * gy, _BOX)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


def _nms(score: Tensor, radius: int) -> Tensor:
    """Keep only local maxima within a (2r+1)^2 window (max-pooling pads
    with -inf, as the JAX package's ``reduce_window`` does)."""
    k = 2 * radius + 1
    pooled = F.max_pool2d(score[None], k, stride=1, padding=radius)[0]
    return torch.where(score >= pooled, score, torch.full_like(score, -np.inf))


def _top_k(x: Tensor, k: int):
    """(values, indices) of the k largest entries of a 1-D tensor, the lower
    index first among equal values (``lax.top_k``'s order)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _orientation(img: Tensor, xy: Tensor) -> Tensor:
    """Intensity-centroid orientation (ORB): theta = atan2(m01, m10)."""
    offs = _consts(img.device)[0]
    vals = bilinear_sample(img, xy[:, None, :] + offs[None])   # [K, O]
    m10 = torch.sum(vals * offs[None, :, 0], dim=-1)
    m01 = torch.sum(vals * offs[None, :, 1], dim=-1)
    return torch.atan2(m01, m10)


def _pack_bits(bits: Tensor) -> Tensor:
    """[..., 256] bool -> [..., 8] int32 words, bit j of word w = bits[32w+j]
    (the JAX package's uint32 words, reinterpreted)."""
    b = bits.reshape(bits.shape[:-1] + (8, 32)).to(torch.int64)
    w = torch.sum(b << torch.arange(32, device=bits.device), dim=-1)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def _descriptors(img: Tensor, xy: Tensor, angle: Tensor) -> Tensor:
    """Rotated-BRIEF 256-bit descriptors packed into int32 [K, 8]."""
    ca, sa = torch.cos(angle), torch.sin(angle)
    p = _consts(img.device)[1]

    def rot(px, py):
        return (ca[:, None] * px[None, :] - sa[:, None] * py[None, :],
                sa[:, None] * px[None, :] + ca[:, None] * py[None, :])

    r1x, r1y = rot(p[:, 0], p[:, 1])
    r2x, r2y = rot(p[:, 2], p[:, 3])
    pts1 = torch.stack([xy[:, None, 0] + r1x, xy[:, None, 1] + r1y], dim=-1)
    pts2 = torch.stack([xy[:, None, 0] + r2x, xy[:, None, 1] + r2y], dim=-1)
    v1 = bilinear_sample(img, pts1)   # [K, 256]
    v2 = bilinear_sample(img, pts2)
    return _pack_bits(v1 < v2)


def detect(img: Tensor, cfg: DetectorConfig = DetectorConfig()) -> Features:
    """Detect up to cfg.max_keypoints oriented corners with descriptors."""
    H, W = img.shape
    score = harris_response(img, cfg.harris_k)
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    b = cfg.border
    inb = (xs >= b) & (xs < W - b) & (ys >= b) & (ys < H - b)
    score = torch.where(inb, score, torch.full_like(score, -np.inf))
    score = _nms(score, cfg.nms_radius)
    top_scores, top_idx = _top_k(score.reshape(-1), cfg.max_keypoints)
    xy = torch.stack([(top_idx % W).to(torch.float32),
                      (top_idx // W).to(torch.float32)], dim=-1)
    valid = top_scores > torch.clamp(cfg.rel_threshold * top_scores[0],
                                     min=cfg.score_threshold)
    angle = _orientation(img, xy)
    return Features(xy=xy, score=top_scores, angle=angle,
                    descriptor=_descriptors(img, xy, angle), valid=valid)


def _select_uniform(xy: Tensor, score: Tensor, valid: Tensor, W0: int,
                    H0: int, cell: int, K: int):
    """Spatial-uniformity selection: the best keypoint of every grid cell is
    prioritised over all others, then remaining capacity fills by score
    (reference BRISK uniformity_rad, feature_detection.h:75-82, as a
    static-shape cell maximum)."""
    ncx = (W0 + cell - 1) // cell
    ncy = (H0 + cell - 1) // cell
    cx = torch.clamp(torch.floor(xy[:, 0] / cell).to(torch.int64), 0, ncx - 1)
    cy = torch.clamp(torch.floor(xy[:, 1] / cell).to(torch.int64), 0, ncy - 1)
    cid = cy * ncx + cx
    ninf = torch.full_like(score, -np.inf)
    s = torch.where(valid, score, ninf)
    cell_max = torch.full((ncx * ncy,), -np.inf, device=xy.device).scatter_reduce(
        0, cid, s, "amax", include_self=True)
    is_best = valid & (s >= cell_max[cid]) & torch.isfinite(s)
    boost = torch.where(is_best, torch.full_like(s, 1e6), torch.zeros_like(s))
    rank = torch.where(valid, s + boost, ninf)
    top_rank, idx = _top_k(rank, K)
    return idx, torch.isfinite(top_rank)


def detect_pyramid(img_pyr, cfg: DetectorConfig = DetectorConfig()) -> Features:
    """Scale-space detection over ``cfg.octaves`` pyramid levels with
    spatial-uniformity selection, capacity cfg.max_keypoints. Each octave
    runs the single-scale pipeline on its level image; keypoint coordinates
    are mapped back to level 0 (the reference's BRISK octaves,
    feature_detection.h:75-82)."""
    octaves = min(cfg.octaves, len(img_pyr))
    H0, W0 = img_pyr[0].shape
    cands = []
    for o in range(octaves):
        f = detect(img_pyr[o], cfg)
        cands.append(f._replace(xy=f.xy * float(2 ** o)))
    cat = Features(*(torch.cat([getattr(f, n) for f in cands])
                     for n in Features._fields))
    if cfg.uniformity_cell > 0:
        idx, valid = _select_uniform(cat.xy, cat.score, cat.valid, W0, H0,
                                     cfg.uniformity_cell, cfg.max_keypoints)
    else:
        s = torch.where(cat.valid, cat.score,
                        torch.full_like(cat.score, -np.inf))
        top, idx = _top_k(s, cfg.max_keypoints)
        valid = torch.isfinite(top)
    return Features(xy=cat.xy[idx], score=cat.score[idx], angle=cat.angle[idx],
                    descriptor=cat.descriptor[idx],
                    valid=valid & cat.valid[idx])


# ----------------------------------------------------------------------------
# Carrying keypoints across from numpy (the JAX package's host arrays)
# ----------------------------------------------------------------------------

def features_from_numpy(f, device="cpu"):
    """A keypoint set or a reprojection-factor pool given as numpy arrays
    (the JAX package's ``Features`` after ``np.asarray``, with ``uint32``
    descriptors, or its host ``RepPool``) -> the port's: ``Features`` of
    tensors on ``device`` with ``int32`` descriptors, or a
    ``mapping.mapper_pools.RepPool`` of numpy copies."""
    if hasattr(f, "descriptor"):
        t = lambda a, dt: torch.as_tensor(np.array(a), device=device).to(dt)
        return Features(
            xy=t(f.xy, torch.float32), score=t(f.score, torch.float32),
            angle=t(f.angle, torch.float32),
            descriptor=torch.as_tensor(
                np.ascontiguousarray(np.asarray(f.descriptor, np.uint32))
                .view(np.int32), device=device),
            valid=t(f.valid, torch.bool))
    from ..mapping.mapper_pools import RepPool

    return RepPool(*(np.array(getattr(f, n)) for n in RepPool._fields))


def features_to_numpy(f):
    """The inverse of ``features_from_numpy``: numpy arrays, descriptors as
    ``uint32`` words (``Features``), or a ``RepPool`` of numpy copies."""
    if hasattr(f, "descriptor"):
        n = lambda a: a.detach().cpu().numpy()
        return Features(xy=n(f.xy), score=n(f.score), angle=n(f.angle),
                        descriptor=n(f.descriptor).view(np.uint32),
                        valid=n(f.valid))
    return type(f)(*(np.array(getattr(f, n)) for n in type(f)._fields))
