"""Fused photometric error evaluation and warp render: the counterpart of
``sfm_error_batch`` and ``se3_warp_batch`` of
``deepfactors_tpu/ops/pallas/sfm_kernel.py``.

Both share the per-pixel work of the Gram kernels (``sfm_gram.py``) minus
the Jacobians: the correspondence of every keyframe pixel under the factor's
params row (border and min_dpt come from the row; the callers pack 1 and
0.0, the evaluation defaults of the reference), and a bilinear sample of the
target image there.

  - ``sfm_error_batch``: (residual [P], inliers [P]) with residual =
    Σ(w·r)², w the Huber √-weight zeroed on invalid pixels, inliers = Σvalid.
  - ``se3_warp_batch``: (warped [P, H, W], residual [P], inliers [P]) with
    warped = valid ? img1(warp) : 0 and the unweighted residual Σr² over
    valid pixels.

One hand-written CUDA source carries both (``csrc/sfm_error.cu``); each has
a plain PyTorch twin here. Dispatch as in ``sfm_gram``: a CUDA tensor
launches the kernel (or raises), a CPU tensor runs the twin, nothing falls
back. Every kernel launch adds one to ``LAUNCHES[name]``. Inactive factors
(``active[p] == 0``) give exact zeros. Each call is one launch, with the
geometry of ``sfm_gram.launch_plan`` and the tickets of ``sfm_gram._tickets``
(the last block of a factor writes its sums).
"""
from __future__ import annotations

import ctypes

import torch

from ..image import bilinear_sample_grad
from . import sfm_gram as sg

Tensor = torch.Tensor

# launch counters of the CUDA kernels (plain-twin calls never count)
LAUNCHES = {"sfm_error_batch": 0, "se3_warp_batch": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ----------------------------------------------------------------------------
# plain PyTorch twins
# ----------------------------------------------------------------------------

def _sample(params, src, dst, img0_pool, dpt_pool, img1_pool):
    """(r [P, N], i1 [P, N], valid [P, N]) in the op order of the kernel."""
    s = sg._clamped(src, img0_pool.shape[0])
    d = sg._clamped(dst, img1_pool.shape[0])
    P = src.shape[0]
    corr = sg._correspondence(params, dpt_pool[s])
    pix = torch.stack([corr.x1, corr.y1], dim=-1)
    i1 = bilinear_sample_grad(img1_pool[d], pix)[0]
    return img0_pool[s].reshape(P, -1) - i1, i1, corr.valid


def _masked_sums(e, valid, active):
    on = active != 0
    zero = torch.zeros((), dtype=e.dtype, device=e.device)
    return (torch.where(on, torch.sum(e * e, dim=1), zero),
            torch.where(on, torch.sum(valid.to(e.dtype), dim=1), zero))


def sfm_error_batch_plain(params, src, dst, img0_pool, dpt_pool, img1_pool,
                          active=None):
    """Plain PyTorch version of ``sfm_error_batch`` (same arguments)."""
    active = sg._default_active(active, src.shape[0], img0_pool.device)
    r, _, valid = _sample(params, src, dst, img0_pool, dpt_pool, img1_pool)
    wv = sg._robust_wv(r, valid, sg._param_col(params, sg._HUBER), "huber")
    return _masked_sums(wv * r, valid, active)


def se3_warp_batch_plain(params, src, dst, img0_pool, dpt_pool, img1_pool,
                         active=None):
    """Plain PyTorch version of ``se3_warp_batch`` (same arguments)."""
    P = src.shape[0]
    H, W = img0_pool.shape[1:]
    active = sg._default_active(active, P, img0_pool.device)
    r, i1, valid = _sample(params, src, dst, img0_pool, dpt_pool, img1_pool)
    zero = torch.zeros_like(i1)
    warped = torch.where(valid & (active != 0)[:, None], i1, zero)
    res, inl = _masked_sums(torch.where(valid, r, zero), valid, active)
    return warped.reshape(P, H, W), res, inl


# ----------------------------------------------------------------------------
# CUDA kernels
# ----------------------------------------------------------------------------

def _launch(name, params, src, dst, img0_pool, dpt_pool, img1_pool, active,
            warp_mode: int):
    dev = img0_pool.device
    P = src.shape[0]
    K, H, W = img0_pool.shape
    K1 = img1_pool.shape[0]
    f32, i32 = torch.float32, torch.int32
    sg._check(params, "params", f32, (P, sg.PARAM_DIM), dev)
    sg._check(src, "src", i32, (P,), dev)
    sg._check(dst, "dst", i32, (P,), dev)
    if active is not None:      # None: the kernel takes every factor as active
        active = active.to(i32)
        sg._check(active, "active", i32, (P,), dev)
    sg._check(img0_pool, "img0_pool", f32, (K, H, W), dev)
    sg._check(dpt_pool, "dpt_pool", f32, (K, H, W), dev)
    sg._check(img1_pool, "img1_pool", f32, (K1, H, W), dev)
    plan = sg.launch_plan(name, P, H, W)
    stream = torch.cuda.current_stream(dev).cuda_stream
    part = torch.empty(plan.part_shape, dtype=f32, device=dev)
    out = torch.empty((P, 2), dtype=f32, device=dev)
    warped = (torch.empty((P, H, W), dtype=f32, device=dev) if warp_mode
              else None)
    lib = sg._lib("sfm_error.cu", "sfm_error_launch",
                  "sfm_error_error_string", 11, 8)
    code = lib.sfm_error_launch(
        sg._ptr(params), sg._ptr(src), sg._ptr(dst), sg._ptr(active),
        sg._ptr(img0_pool), sg._ptr(dpt_pool), sg._ptr(img1_pool),
        sg._ptr(warped), sg._ptr(part), sg._ptr(out),
        sg._ptr(sg._tickets(dev, stream, P)), P, K, K1, H, W,
        plan.px_per_blk, plan.nblk, warp_mode, ctypes.c_void_p(stream))
    if code != 0:
        sg._drop_tickets(dev, stream)
    sg._raise_on(code, lib, "sfm_error_error_string")
    LAUNCHES[name] += 1
    return warped, out[:, 0], out[:, 1]


# ----------------------------------------------------------------------------
# public entry points
# ----------------------------------------------------------------------------

def sfm_error_batch(params, src, dst, img0_pool, dpt_pool, img1_pool,
                    active=None):
    """Fused photometric error evaluation: (residual [P], inliers [P]).

    params [P, PARAM_DIM] (``sfm_gram.make_sfm_params``), src/dst [P] int32
    slots into the pools img0/dpt [K, H, W] and img1 [K1, H, W]; active [P]
    (0 = both outputs are zero)."""
    if sg._route(img0_pool) == "cuda":
        return _launch("sfm_error_batch", params, src, dst, img0_pool,
                       dpt_pool, img1_pool, active, 0)[1:]
    return sfm_error_batch_plain(params, src, dst, img0_pool, dpt_pool,
                                 img1_pool, active)


def se3_warp_batch(params, src, dst, img0_pool, dpt_pool, img1_pool,
                   active=None):
    """Fused warp render: (warped [P, H, W], residual [P], inliers [P]);
    arguments as ``sfm_error_batch``."""
    if sg._route(img0_pool) == "cuda":
        return _launch("se3_warp_batch", params, src, dst, img0_pool,
                       dpt_pool, img1_pool, active, 1)
    return se3_warp_batch_plain(params, src, dst, img0_pool, dpt_pool,
                                img1_pool, active)
