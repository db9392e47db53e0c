"""Dense warp sampling for the unfused photometric linearisation: the
counterpart of ``deepfactors_tpu/ops/pallas/warp_kernel.py``.

  - ``dense_warp_batch``: per factor, the correspondence of every keyframe
    pixel under a packed params row (``make_warp_params``) and clamped
    bilinear samples of img1, gx1, gy1 there:
    (i1, gx, gy, tptx, tpty, tptz, valid), each [P, H, W], valid as 0/1.
  - ``bilinear_warp_planes``: the same sample of C planes at given
    coordinates, sampled [C, H, W].

One hand-written CUDA source carries both (``csrc/dense_warp.cu``); each has
a plain PyTorch twin here, in the kernel's op order. Dispatch as in
``sfm_gram``: a CUDA tensor launches the kernel (or raises), a CPU tensor
runs the twin, nothing falls back. Every kernel launch adds one to
``LAUNCHES[name]``.

The projection divides by tptz with no guard, like the TPU kernel (the fused
kernels of ``sfm_gram`` substitute 1e-12): where tptz is ~0 the coordinates
are huge or not finite and ``valid`` is 0. Both the kernel and the twins
clamp the floored coordinate as a float before it becomes an index, so such
pixels read inside the plane (their samples may be NaN, through the
interpolation weight). The interpolation weight is zeroed at the clamped
last row and column; ``F.grid_sample`` weighs that edge differently and is
not used.
"""
from __future__ import annotations

import ctypes

import torch

from ...geometry import se3 as se3m
from ...geometry.camera import PinholeCamera
from . import sfm_gram as sg

Tensor = torch.Tensor

# launch counters of the CUDA kernels (plain-twin calls never count)
LAUNCHES = {"dense_warp_batch": 0, "bilinear_warp_planes": 0}
_MAX_GRID_Y = 65535


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def make_warp_params(pose_10: se3m.SE3, cam: PinholeCamera, border,
                     min_dpt) -> Tensor:
    """Pack per-factor warp scalars [P, 24]: R(9) t(3) fx fy u0 v0 border
    min_dpt, rest zero: a ``make_sfm_params`` row without the robust-loss
    entries. pose_10 is batched [P]."""
    return sg.make_sfm_params(pose_10, cam, border, min_dpt, 0.0, 0.0)


# ----------------------------------------------------------------------------
# plain PyTorch twins
# ----------------------------------------------------------------------------

def _sample_clamped(planes: Tensor, x: Tensor, y: Tensor) -> Tensor:
    """planes [B, C, H, W] sampled at x, y [B, N] -> [B, C, N], in the op
    order of csrc/sfm_common.cuh::corners and interp_value."""
    B, C, H, W = planes.shape
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    wx = torch.where(x0f >= W - 1, torch.zeros_like(x), x - x0f)
    wy = torch.where(y0f >= H - 1, torch.zeros_like(y), y - y0f)
    # clamp as floats before the cast (NaN goes to 0, as fmaxf does)
    x0 = torch.clamp(torch.nan_to_num(x0f, nan=0.0), 0, W - 1).long()
    y0 = torch.clamp(torch.nan_to_num(y0f, nan=0.0), 0, H - 1).long()
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    flat = planes.reshape(B, C, H * W)
    take = lambda idx: torch.gather(flat, 2, idx[:, None, :].expand(B, C, -1))
    v00, v01 = take(y0 * W + x0), take(y0 * W + x1)
    v10, v11 = take(y1 * W + x0), take(y1 * W + x1)
    wx, wy = wx[:, None, :], wy[:, None, :]
    top = v00 + wx * (v01 - v00)
    bot = v10 + wx * (v11 - v10)
    return top + wy * (bot - top)


def dense_warp_batch_plain(params, dpt0, img1, gx1, gy1):
    """Plain PyTorch version of ``dense_warp_batch`` (same arguments)."""
    P, H, W = dpt0.shape
    dev = dpt0.device
    xs = torch.arange(W, dtype=torch.float32, device=dev).repeat(H)
    ys = torch.arange(H, dtype=torch.float32, device=dev).repeat_interleave(W)
    c = lambda k: params[:, k:k + 1]
    R = [c(k) for k in range(9)]
    fx, fy, u0, v0 = c(sg._FX), c(sg._FY), c(sg._U0), c(sg._V0)
    border, min_dpt = c(sg._BORDER), c(sg._MINDPT)
    d = dpt0.reshape(P, -1)
    u = (xs - u0) / fx
    v = (ys - v0) / fy
    ptx = u * d
    pty = v * d
    tptx = R[0] * ptx + R[1] * pty + R[2] * d + c(sg._T0)
    tpty = R[3] * ptx + R[4] * pty + R[5] * d + c(sg._T0 + 1)
    tptz = R[6] * ptx + R[7] * pty + R[8] * d + c(sg._T0 + 2)
    x1 = fx * tptx / tptz + u0
    y1 = fy * tpty / tptz + v0
    valid = ((tptz > min_dpt) & (x1 >= border) & (x1 < W - border)
             & (y1 >= border) & (y1 < H - border))
    s = _sample_clamped(torch.stack([img1, gx1, gy1], dim=1), x1, y1)
    shape = lambda a: a.reshape(P, H, W)
    return (shape(s[:, 0]), shape(s[:, 1]), shape(s[:, 2]), shape(tptx),
            shape(tpty), shape(tptz), shape(valid.to(torch.float32)))


def bilinear_warp_planes_plain(chans, x1, y1):
    """Plain PyTorch version of ``bilinear_warp_planes`` (same arguments)."""
    C, H, W = chans.shape
    return _sample_clamped(chans[None], x1.reshape(1, -1),
                           y1.reshape(1, -1)).reshape(C, H, W)


# ----------------------------------------------------------------------------
# CUDA kernels
# ----------------------------------------------------------------------------

def _dense_warp_cuda(params, dpt0, img1, gx1, gy1):
    dev = dpt0.device
    P, H, W = dpt0.shape
    if P > _MAX_GRID_Y:
        raise ValueError(f"{P} factors in one call, at most {_MAX_GRID_Y}")
    f32 = torch.float32
    sg._check(params, "params", f32, (P, sg.PARAM_DIM), dev)
    for name, t in (("dpt0", dpt0), ("img1", img1), ("gx1", gx1),
                    ("gy1", gy1)):
        sg._check(t, name, f32, (P, H, W), dev)
    out = torch.empty((7, P, H, W), dtype=f32, device=dev)
    lib = sg._lib("dense_warp.cu", "dense_warp_launch",
                  "dense_warp_error_string", 6, 3)
    code = lib.dense_warp_launch(
        sg._ptr(params), sg._ptr(dpt0), sg._ptr(img1), sg._ptr(gx1),
        sg._ptr(gy1), sg._ptr(out), P, H, W,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    sg._raise_on(code, lib, "dense_warp_error_string")
    LAUNCHES["dense_warp_batch"] += 1
    return out.unbind(0)


def _bilinear_warp_cuda(chans, x1, y1):
    dev = chans.device
    C, H, W = chans.shape
    f32 = torch.float32
    sg._check(chans, "chans", f32, (C, H, W), dev)
    sg._check(x1, "x1", f32, (H, W), dev)
    sg._check(y1, "y1", f32, (H, W), dev)
    out = torch.empty((C, H, W), dtype=f32, device=dev)
    lib = sg._lib("dense_warp.cu", "bilinear_warp_launch",
                  "dense_warp_error_string", 4, 3)
    code = lib.bilinear_warp_launch(
        sg._ptr(chans), sg._ptr(x1), sg._ptr(y1), sg._ptr(out), C, H, W,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    sg._raise_on(code, lib, "dense_warp_error_string")
    LAUNCHES["bilinear_warp_planes"] += 1
    return out


# ----------------------------------------------------------------------------
# public entry points
# ----------------------------------------------------------------------------

def dense_warp_batch(params, dpt0, img1, gx1, gy1):
    """Fused correspondence + bilinear warp for P factors:
    (i1, gx, gy, tptx, tpty, tptz, valid), each [P, H, W].

    params [P, PARAM_DIM] (``make_warp_params``); dpt0 the source depth and
    img1/gx1/gy1 the target image and its gradient planes, per factor
    [P, H, W], float32 and contiguous. ``valid`` (0/1) is the min-depth and
    bounds test of the correspondence."""
    if sg._route(dpt0) == "cuda":
        return _dense_warp_cuda(params, dpt0, img1, gx1, gy1)
    return dense_warp_batch_plain(params, dpt0, img1, gx1, gy1)


def bilinear_warp_planes(chans, x1, y1):
    """Clamped bilinear sample of chans [C, H, W] at coordinates x1, y1
    [H, W]: sampled [C, H, W]. Coordinates are clamped like
    ``ops.image.bilinear_sample``; callers mask validity separately. The TPU
    kernel's second output, its band coverage [H, W], is dropped: every
    pixel is sampled here, so it would be all ones."""
    if sg._route(chans) == "cuda":
        return _bilinear_warp_cuda(chans, x1, y1)
    return bilinear_warp_planes_plain(chans, x1, y1)
