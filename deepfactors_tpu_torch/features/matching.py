"""Binary descriptor matching and 8-point RANSAC, batched.

PyTorch port of ``deepfactors_tpu/features/matching.py`` (the reference's
BFMatcher/Hamming + OpenGV CentralRelativePose RANSAC,
sources/core/features/matching.cpp:25-128). Fixed capacity, masked:

  - Hamming distances: XOR + popcount over 32-bit words, the full
    [K0, K1] distance matrix at once. Descriptors are ``int32`` words
    holding the JAX package's ``uint32`` bits; the bits are counted in
    ``int64``, where the SWAR shifts are logical.
  - Matching: nearest neighbour with a distance cut
    (PruneMatchesByThreshold, matching.cpp:29-37).
  - PruneMatchesEightPoint (matching.cpp:75-128): hypothesise and verify on
    bearing vectors; every hypothesis is one 8-point essential-matrix solve
    of one batched SVD, inliers scored by a Sampson-like epipolar error.

Every function takes optional leading batch axes (the mapper matches all
directions of a keyframe event at once). The RANSAC draws are an input
(``idx``): ``draw_hypotheses`` makes them from a ``torch.Generator``; the
JAX package draws them from its own PRNG, which a caller can replay.

Plain PyTorch on the device of its input: no hand-written kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..geometry.camera import PinholeCamera

Tensor = torch.Tensor


class Matches(NamedTuple):
    idx0: Tensor    # [..., M] index into features0
    idx1: Tensor    # [..., M] index into features1
    dist: Tensor    # [..., M] hamming distance
    valid: Tensor   # [..., M] bool


def popcount32(x: Tensor) -> Tensor:
    """Bits set in each 32-bit word of an int32 (or int64 < 2^32) tensor,
    as int32."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) >> 24) & 0xFF).to(torch.int32)


def hamming_matrix(desc0: Tensor, desc1: Tensor) -> Tensor:
    """[..., K0, 8] x [..., K1, 8] words -> [..., K0, K1] int32 Hamming
    distances."""
    x = torch.bitwise_xor(desc0[..., :, None, :], desc1[..., None, :, :])
    return torch.sum(popcount32(x), dim=-1, dtype=torch.int32)


def match(desc0: Tensor, valid0: Tensor, desc1: Tensor, valid1: Tensor,
          max_dist: int = 64) -> Matches:
    """Nearest-neighbour match 0->1 with a distance threshold: one candidate
    per query keypoint (masked). Among equally near candidates the lowest
    index wins."""
    D = hamming_matrix(desc0, desc1)
    D = torch.where(valid1[..., None, :], D, torch.full_like(D, 1 << 30))
    best = torch.argmin(D, dim=-1)           # the first minimum
    bestd = torch.gather(D, -1, best[..., None])[..., 0]
    ok = valid0 & (bestd <= max_dist)
    idx0 = torch.arange(desc0.shape[-2], dtype=torch.int32,
                        device=desc0.device).expand(ok.shape)
    return Matches(idx0=idx0, idx1=best.to(torch.int32), dist=bestd, valid=ok)


def bearing_vectors(cam: PinholeCamera, xy: Tensor) -> Tensor:
    """Pixels [..., 2] -> normalised bearing vectors [..., 3]
    (matching.cpp:39-58)."""
    x = (xy[..., 0] - cam.u0) / cam.fx
    y = (xy[..., 1] - cam.v0) / cam.fy
    v = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def _essential_from_8(b0: Tensor, b1: Tensor) -> Tensor:
    """8-point essential matrices from bearing pairs [..., 8, 3] each ->
    [..., 3, 3]: the null vector of the epipolar system, projected onto the
    essential manifold (two equal singular values, one zero)."""
    A = (b1[..., :, :, None] * b0[..., :, None, :]).reshape(
        b0.shape[:-2] + (8, 9))                   # rows: kron(b1, b0)
    A = torch.where(torch.isfinite(A), A, torch.zeros_like(A))
    _, _, vt = torch.linalg.svd(A, full_matrices=True)
    E = vt[..., -1, :].reshape(b0.shape[:-2] + (3, 3))
    u, _, vt2 = torch.linalg.svd(E)
    # singular values set to (1, 1, 0)
    return u[..., :, :2] @ vt2[..., :2, :]


def _epipolar_error(E: Tensor, b0: Tensor, b1: Tensor) -> Tensor:
    """Squared 'angular' epipolar residual of every correspondence under
    every hypothesis: E [..., I, 3, 3], b0/b1 [..., N, 3] -> [..., I, N]."""
    Eb0 = torch.einsum("...ijk,...nk->...inj", E, b0)     # E·b0
    Etb1 = torch.einsum("...nj,...ijk->...ink", b1, E)    # b1ᵀ·E
    x = torch.sum(b1[..., None, :, :] * Eb0, dim=-1)
    denom = (Eb0[..., 0] ** 2 + Eb0[..., 1] ** 2 + Etb1[..., 0] ** 2
             + Etb1[..., 1] ** 2)
    return (x * x) / torch.clamp(denom, min=1e-12)


def draw_hypotheses(valid: Tensor, iterations: int,
                    generator: Optional[torch.Generator] = None) -> Tensor:
    """RANSAC sample indices [..., I, 8], drawn with replacement uniformly
    over the valid matches of each row of ``valid`` [..., M], or over all M
    where a row has none (as the JAX package's all -1e9 logits do)."""
    lead, M = valid.shape[:-1], valid.shape[-1]
    v = valid.reshape(-1, M)
    w = torch.where(v.any(dim=-1, keepdim=True), v.to(torch.float32),
                    torch.ones_like(v, dtype=torch.float32))
    idx = torch.multinomial(w, iterations * 8, replacement=True,
                            generator=generator)
    return idx.reshape(lead + (iterations, 8))


def prune_matches_eight_point(
    xy0: Tensor,           # [..., M, 2] matched pixels in frame 0
    xy1: Tensor,           # [..., M, 2] matched pixels in frame 1
    valid: Tensor,         # [..., M]
    cam: PinholeCamera,
    idx: Optional[Tensor] = None,   # [..., I, 8] hypothesis draws
    threshold: float = 1e-4,
    max_iterations: int = 256,
    generator: Optional[torch.Generator] = None,
) -> Tensor:
    """RANSAC inlier mask [..., M] (PruneMatchesEightPoint semantics): every
    hypothesis solved in one batched SVD, the best by inlier count (the
    first among equal counts). Without ``idx``, ``max_iterations``
    hypotheses are drawn by ``draw_hypotheses`` from ``generator``."""
    if idx is None:
        idx = draw_hypotheses(valid, max_iterations, generator)
    idx = idx.to(torch.int64)
    b0 = bearing_vectors(cam, xy0)
    b1 = bearing_vectors(cam, xy1)
    lead, I = idx.shape[:-2], idx.shape[-2]
    gather = lambda b: torch.gather(
        b[..., None, :, :].expand(lead + (I,) + b.shape[-2:]), -2,
        idx[..., None].expand(lead + (I, 8, 3)))
    Es = _essential_from_8(gather(b0), gather(b1))          # [..., I, 3, 3]
    inl = (_epipolar_error(Es, b0, b1) < threshold) & valid[..., None, :]
    best = torch.argmax(torch.sum(inl, dim=-1), dim=-1)     # [...]
    return torch.gather(inl, -2, best[..., None, None].expand(
        lead + (1, inl.shape[-1])))[..., 0, :]
