"""Batched photometric factor evaluation over the SoA map.

PyTorch port of ``deepfactors_tpu/mapping/factors.py``. Every factor of a
pyramid level is linearised in ONE ``sfm_gram_batch`` call straight from
the keyframe pools (the CUDA kernel on the card, its plain twin on the
CPU), then expanded to the reference's 44-dim systems by
``system_from_gram``; ``photometric_error_batch`` evaluates residuals only,
in one ``sfm_error_batch`` call. The JAX package's one-hot ``take_rows``
gathers are plain indexing here.

The JAX package's ``photometric_batch`` also has an unfused branch
(``dense_sfm.sfm_step_batch`` on gathered rows) that it takes only where an
image size fails the TPU kernels' tile rule. The CUDA Gram kernels have no
such rule, so ``photometric_batch`` here is always fused and that branch has
no counterpart; the unfused linearisation is reached through
``parallel/dist_ba``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3 as se3m
from ..geometry.camera import PinholeCamera
from ..ops import dense_sfm as ds
from ..ops.kernels import sfm_error as se
from ..ops.kernels import sfm_gram as sg
from . import map_state as ms

Tensor = torch.Tensor


class FactorBatch(NamedTuple):
    """Result of evaluating P photometric factors at one level."""

    JtJ: Tensor       # [P, D, D]
    Jtr: Tensor       # [P, D]
    residual: Tensor  # [P] raw sum of squared weighted residuals
    inliers: Tensor   # [P]


def photometric_gram_pools(pose0, pose1, code0, src, dst, cam_level, params,
                           img0_pool, dpt_pool, jacT_pool, img1_pool,
                           gx1_pool, gy1_pool, active=None,
                           grad_mode="sampled", depth_from_code=False,
                           loss="huber") -> FactorBatch:
    """Fused photometric batch straight from pooled keyframe tensors.

    depth_from_code=True: dpt_pool holds prx0 and depth is materialised at
    code0 inside the linearisation (no separate depth-pyramid pass)."""
    CS = jacT_pool.shape[1]
    pose_10, j_pose1, j_pose0 = se3m.relative_pose_jacobians(pose1, pose0)
    kp = sg.make_sfm_params(pose_10, cam_level, params.valid_border,
                            params.min_dpt, params.huber_delta, params.avg_dpt)
    if active is not None:
        active = active.to(torch.int32)
    G = sg.sfm_gram_batch(
        kp, src.to(torch.int32), dst.to(torch.int32), img0_pool, dpt_pool,
        jacT_pool, img1_pool, gx1_pool, gy1_pool, active=active,
        codes=code0.contiguous() if depth_from_code else None,
        grad_mode=grad_mode, loss=loss)
    return FactorBatch(*sg.system_from_gram(G, j_pose0, j_pose1, CS))


def _grad_planes(grad: Tensor, grad_mode: str):
    if grad_mode != "sampled":
        return None, None
    return grad[..., 0].contiguous(), grad[..., 1].contiguous()


def photometric_batch(state: ms.MapState, src: Tensor, dst: Tensor,
                      level: int, cam_level: PinholeCamera,
                      params: ds.SfmParams, active: Tensor = None,
                      grad_mode: str = "sampled",
                      depth_from_code: bool = False,
                      loss: str = "huber") -> FactorBatch:
    """Photometric GN systems for keyframe pairs (src -> dst)."""
    lvl = state.levels[level]
    gx, gy = _grad_planes(lvl.grad, grad_mode)
    return photometric_gram_pools(
        ms.poses_of(state, src), ms.poses_of(state, dst), state.code[src],
        src, dst, cam_level, params, lvl.img,
        lvl.prx0 if depth_from_code else lvl.dpt, lvl.jac, lvl.img, gx, gy,
        active=active, grad_mode=grad_mode, depth_from_code=depth_from_code,
        loss=loss)


def depth_prior_batch(state: ms.MapState, tgt_pyr, sigma: float,
                      avg_dpt: float) -> FactorBatch:
    """Code-only GN systems tying each keyframe's code to a target depth
    pyramid (``tgt_pyr``: per level [K, h, w]), summed over all levels and
    scaled by 1/sigma^2 (DepthPriorFactor::linearize,
    depth_prior_factor.cpp:83-123; step math ``ds.depth_align_step_T``).
    Returns [K, CS, CS] / [K, CS] blocks addressed at each keyframe's code
    slot; residual and inliers are unscaled."""
    total = None
    for tgt, lvl in zip(tgt_pyr, state.levels):
        sys = ds.depth_align_step_T(state.code, tgt, lvl.prx0, lvl.jac,
                                    avg_dpt)
        total = sys if total is None else ds.SystemResult(
            *(a + b for a, b in zip(total, sys)))
    w = 1.0 / (sigma * sigma)
    return FactorBatch(total.JtJ * w, total.Jtr * w, total.residual,
                       total.inliers)


def photometric_error_batch(state: ms.MapState, src: Tensor, dst: Tensor,
                            level: int, cam_level: PinholeCamera,
                            params: ds.SfmParams):
    """Residual-only evaluation of keyframe pairs (src -> dst) at the
    materialised depth ``lvl.dpt`` (for statistics and inspection),
    mirroring PhotometricFactor::error -> RunWarping
    (photometric_factor.cpp:61-81): (residual [P], inliers [P]) from one
    ``sfm_error_batch`` call. The evaluation uses border 1 and min_dpt 0
    whatever ``params`` holds, like ``ds.sfm_evaluate_error``."""
    lvl = state.levels[level]
    pose_10 = se3m.relative_pose(ms.poses_of(state, dst),
                                 ms.poses_of(state, src))
    kp = sg.make_sfm_params(pose_10, cam_level, 1, 0.0, params.huber_delta,
                            params.avg_dpt)
    return se.sfm_error_batch(kp, src.to(torch.int32), dst.to(torch.int32),
                              lvl.img, lvl.dpt, lvl.img)
