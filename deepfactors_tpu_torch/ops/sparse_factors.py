"""Sparse factor operators: keypoint reprojection.

PyTorch port of the reprojection half of
``deepfactors_tpu/ops/sparse_factors.py`` (reference ReprojectionFactor,
sources/core/gtsam/reprojection_factor.cpp:159-269): 2 rows per match over
(pose0, pose1, code0); residual pix1_obs - warp, Cauchy-weighted, scaled
by 1/sigma. The masked weighted Jacobian rows reduce to the GN system in
one matmul, like the dense ops.

Both functions take one factor or a batch of P factors (a leading axis on
every argument but the camera: poses [P], code [P, CS], keypoints
[P, M, 2], images [P, H, W] and [P, CS, H, W]), so the mapper evaluates
its whole reprojection pool at once. With ``src`` [P], the images of
``reprojection_system`` are the keyframe pools ([K, H, W], [K, CS, H, W])
and factor p reads slot src[p]: only the keypoints' pixels are read, no
image is copied. Plain PyTorch: no
hand-written kernel.

The geometric half (SparseGeometricFactor) comes with its own slice.
"""
from __future__ import annotations

import torch

from ..geometry import se3 as se3m
from ..geometry import warping as wp
from ..geometry.camera import PinholeCamera
from ..geometry.m_estimators import cauchy_weight
from ..geometry.se3 import SE3
from .dense_sfm import SystemResult, _masked_system

Tensor = torch.Tensor


def _sample_code_data(prx0: Tensor, jac: Tensor, pix: Tensor, src=None):
    """Nearest-pixel prox/Jacobian lookup at float coords pix [P, M, 2]
    (the reference indexes with an int cast, reprojection_factor.cpp:
    195-198): prx0 [P, H, W], ``jac`` feature-major [P, CS, H, W] (or the
    pools, with factor p reading slot src[p]) -> (prx [P, M],
    jac [P, M, CS])."""
    H, W = prx0.shape[-2:]
    xi = torch.clamp(pix[..., 0].to(torch.int64), 0, W - 1)
    yi = torch.clamp(pix[..., 1].to(torch.int64), 0, H - 1)
    p = (torch.arange(pix.shape[0], device=prx0.device) if src is None
         else src.long())[:, None]
    return prx0[p, yi, xi], jac[p, :, yi, xi]


def _batched(pose0: SE3, pose1: SE3, *arrays):
    """Give a single factor's arguments a leading axis of 1."""
    add = lambda x: x[None]
    return (SE3(add(pose0.q), add(pose0.t)), SE3(add(pose1.q), add(pose1.t)),
            *map(add, arrays))


def _warp(pose0: SE3, pose1: SE3, code0, cam, kp0, prx0_img, jac_img,
          avg_dpt, src=None):
    """Depth at the keypoints of frame 0 from the code, and their
    correspondence in frame 1. Poses [P], keypoints [P, M, 2]."""
    prx0_kp, jac_kp = _sample_code_data(prx0_img, jac_img, kp0, src)
    dpt0 = wp.depth_from_code(code0[:, None, :], jac_kp, prx0_kp, avg_dpt)
    pose_10 = se3m.relative_pose(pose1, pose0)
    pose_10 = SE3(pose_10.q[:, None], pose_10.t[:, None])
    corr = wp.find_correspondence(kp0, dpt0, cam, pose_10, border=1,
                                  min_dpt=0.0, check_bounds=False)
    return jac_kp, dpt0, pose_10, corr


def reprojection_system(
    pose0: SE3,
    pose1: SE3,
    code0: Tensor,        # [(P,) CS]
    cam: PinholeCamera,
    kp0: Tensor,          # [(P,) M, 2] keyframe keypoints (matched)
    kp1: Tensor,          # [(P,) M, 2] target keypoints (matched)
    match_valid: Tensor,  # [(P,) M]
    prx0_img: Tensor,     # [(P,) H, W] zero-code prox (level 0)
    jac_img: Tensor,      # [(P,) CS, H, W] feature-major
    huber_delta: float = 0.1,
    sigma: float = 1.0,
    avg_dpt: float = 2.0,
    src: Tensor = None,   # [P] pool slots of the images
) -> SystemResult:
    """GN system [(P,) 12+CS] from keypoint reprojection; J rows stacked per
    residual component (2 per match)."""
    single = kp0.dim() == 2
    if single:
        pose0, pose1, code0, kp0, kp1, match_valid, prx0_img, jac_img = \
            _batched(pose0, pose1, code0, kp0, kp1, match_valid, prx0_img,
                     jac_img)
    P, CS = kp0.shape[0], jac_img.shape[-3]
    _, j_pose1, j_pose0 = se3m.relative_pose_jacobians(pose1, pose0)
    jac_kp, dpt0, pose_10, corr = _warp(pose0, pose1, code0, cam, kp0,
                                        prx0_img, jac_img, avg_dpt, src)
    valid = match_valid & (corr.tpt[..., 2] > 0)
    cJp = wp.correspondence_jacobian_pose(corr, dpt0, cam, pose_10)  # [P,M,2,6]
    cJc = wp.correspondence_jacobian_code(corr, dpt0, cam, pose_10, jac_kp,
                                          avg_dpt)                   # [P,M,2,CS]
    # residual r = kp1 - corr.pix1; dr/dtheta = -dcorr/dtheta
    J = torch.cat([-(cJp @ j_pose0[:, None]), -(cJp @ j_pose1[:, None]), -cJc],
                  dim=-1)                                            # [P,M,2,D]
    diff = kp1 - corr.pix1
    w = cauchy_weight(torch.linalg.norm(diff, dim=-1), huber_delta) / sigma
    twice = lambda x: x[..., None].expand(x.shape + (2,)).reshape(P, -1)
    sys = _masked_system(J.reshape(P, -1, 12 + CS), diff.reshape(P, -1),
                         twice(w), twice(valid))
    if single:
        return SystemResult(*(x[0] for x in sys))
    return sys


def reprojection_error(
    pose0: SE3, pose1: SE3, code0: Tensor, cam: PinholeCamera,
    kp0: Tensor, kp1: Tensor, match_valid: Tensor,
    prx0_img: Tensor, jac_img: Tensor,
    huber_delta: float = 0.1, sigma: float = 1.0, avg_dpt: float = 2.0,
) -> Tensor:
    """0.5 * sum_i (w_i |r_i|)^2 / sigma^2 (reprojection_factor.cpp:100-149),
    [(P,)]."""
    single = kp0.dim() == 2
    if single:
        pose0, pose1, code0, kp0, kp1, match_valid, prx0_img, jac_img = \
            _batched(pose0, pose1, code0, kp0, kp1, match_valid, prx0_img,
                     jac_img)
    *_, corr = _warp(pose0, pose1, code0, cam, kp0, prx0_img, jac_img,
                     avg_dpt)
    err = torch.linalg.norm(kp1 - corr.pix1, dim=-1)
    werr = err * cauchy_weight(err, huber_delta)
    sq = torch.where(match_valid, werr * werr, torch.zeros_like(werr))
    out = 0.5 * torch.sum(sq, dim=-1) / (sigma * sigma)
    return out[0] if single else out
