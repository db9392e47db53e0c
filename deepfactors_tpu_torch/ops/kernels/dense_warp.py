"""Dense warp sampling for the unfused photometric linearisation: the
counterpart of ``deepfactors_tpu/ops/pallas/warp_kernel.py``.

  - ``dense_warp_batch``: per factor, the correspondence of every keyframe
    pixel under a packed params row (``make_warp_params``) and clamped
    bilinear samples of img1, gx1, gy1 there:
    (i1, gx, gy, tptx, tpty, tptz, valid), each [P, H, W], valid as 0/1.
  - ``bilinear_warp_planes``: the same sample of C planes at given
    coordinates, sampled [C, H, W]; ``bilinear_warp_plane_list`` is the
    same function over a list of [H, W] planes read in place (each at its
    own element stride, e.g. one channel of an interleaved [H, W, 2]
    gradient), so the caller stacks nothing.

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
# planes a launch of bilinear_warp_planes (csrc/dense_warp.cu's Planes,
# passed by value); a call with more launches once for every 8
MAX_PLANES = 8


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


def bilinear_warp_plane_list_plain(planes, x1, y1):
    """Plain PyTorch version of ``bilinear_warp_plane_list``. Each plane is
    read as the kernel reads it: H * W values at its element stride
    (``_plane_stride``) from its first pixel."""
    H, W = x1.shape
    flat = [torch.as_strided(t, (H * W,), (_plane_stride(t, f"planes[{k}]", H,
                                                         W, x1.device),))
            for k, t in enumerate(planes)]
    return bilinear_warp_planes_plain(torch.stack(flat).reshape(-1, H, W), x1,
                                      y1)


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


def _plane_stride(t: Tensor, name: str, H: int, W: int, device) -> int:
    """The element stride s of an [H, W] float32 plane whose pixels lie s
    elements apart in row-major order (strides (W * s, s)): 1 for a
    contiguous plane, 2 for one channel of a contiguous [H, W, 2]."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} has dtype {t.dtype}, expected torch.float32")
    if tuple(t.shape) != (H, W):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{(H, W)}")
    s = t.stride(1)
    if s < 1 or t.stride(0) != W * s:
        raise ValueError(f"{name} has strides {t.stride()}: expected "
                         f"(W * s, s) for some s >= 1")
    return s


def _bilinear_warp_launch(ptrs, strides, x1, y1, H, W, dev):
    """Launch csrc/dense_warp.cu on [H, W] planes given as device addresses
    and element strides: sampled [C, H, W], one launch a group of
    MAX_PLANES."""
    C = len(ptrs)
    if C == 0:
        raise ValueError("no planes to sample")
    sg._check(x1, "x1", torch.float32, (H, W), dev)
    sg._check(y1, "y1", torch.float32, (H, W), dev)
    plan = sg.launch_plan("bilinear_warp_planes", 1, H, W)
    out = torch.empty((C, H, W), dtype=torch.float32, device=dev)
    lib = sg._lib("dense_warp.cu", "bilinear_warp_launch",
                  "dense_warp_error_string", 5, 5)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    for c0 in range(0, C, MAX_PLANES):
        n = min(MAX_PLANES, C - c0)
        code = lib.bilinear_warp_launch(
            (ctypes.c_void_p * n)(*ptrs[c0:c0 + n]),
            (ctypes.c_int * n)(*strides[c0:c0 + n]), sg._ptr(x1), sg._ptr(y1),
            ctypes.c_void_p(out.data_ptr() + 4 * c0 * H * W), n, H, W,
            plan.px_per_blk, plan.nblk, stream)
        sg._raise_on(code, lib, "dense_warp_error_string")
        LAUNCHES["bilinear_warp_planes"] += 1
    return out


def _bilinear_warp_cuda(chans, x1, y1):
    dev = chans.device
    C, H, W = chans.shape
    sg._check(chans, "chans", torch.float32, (C, H, W), dev)
    base, N = chans.data_ptr(), H * W
    return _bilinear_warp_launch([base + 4 * k * N for k in range(C)],
                                 [1] * C, x1, y1, H, W, dev)


def _bilinear_warp_list_cuda(planes, x1, y1):
    dev = x1.device
    H, W = x1.shape
    strides = [_plane_stride(t, f"planes[{k}]", H, W, dev)
               for k, t in enumerate(planes)]
    return _bilinear_warp_launch([t.data_ptr() for t in planes], strides,
                                 x1, y1, H, W, dev)


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


def bilinear_warp_plane_list(planes, x1, y1):
    """``bilinear_warp_planes`` over a sequence of C planes [H, W], each read
    in place at its own element stride (strides (W * s, s)): e.g. img1 and
    the two channels ``grad1[..., 0]``, ``grad1[..., 1]`` of an interleaved
    [H, W, 2] gradient, with no stacked copy. Sampled [C, H, W]."""
    if sg._route(x1) == "cuda":
        return _bilinear_warp_list_cuda(planes, x1, y1)
    return bilinear_warp_plane_list_plain(planes, x1, y1)
