"""The weighted Jacobian stack of the unfused photometric linearisation
(``dense_sfm.sfm_step_batch``, sampled gradients): per factor, the
feature-major rows [dErr/dpose0 (6) | dErr/dpose1 (6) | dErr/dcode0 (CS)]
of every keyframe pixel times its robust weight, Jw [P, 12 + CS, H * W],
and the weighted residual rw [P, H * W], from ``dense_warp_batch``'s seven
planes. The Gram product that follows (JtJ as one ``bmm``) stays outside.

One hand-written CUDA source (``csrc/jacobian_stack.cu``), which replaces
no Pallas kernel: it is the counterpart of XLA's fusion of this build in
the JAX package. Its plain PyTorch twin here is the eager chain the port
ran before the kernel, op for op; the kernel rounds every op as that chain
does on the card, so the two give the same stack. Dispatch as in
``sfm_gram``: a CUDA tensor launches the kernel (or raises), a CPU tensor
runs the twin, nothing falls back. Every kernel launch adds one to
``LAUNCHES["jacobian_stack"]``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...geometry.m_estimators import robust_weight
from ...geometry.warping import warp_jacobians
from . import sfm_gram as sg

Tensor = torch.Tensor

# launch counter of the CUDA kernel (plain-twin calls never count)
LAUNCHES = {"jacobian_stack": 0}
_MAX_GRID_Y = 65535
_LOSSES = ("huber", "tukey")


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ----------------------------------------------------------------------------
# plain PyTorch twin
# ----------------------------------------------------------------------------

def jacobian_stack_plain(params, warp, dpt0, img0, jac0, j_pose0, j_pose1,
                         u, v, huber_delta, avg_dpt, loss="huber"):
    """Plain PyTorch version of ``jacobian_stack`` (same arguments)."""
    i1, gx, gy, tptx, tpty, tptz, validf = warp
    P, H, W = dpt0.shape
    N = H * W
    CS = jac0.shape[-1]
    flat = lambda x: x.reshape(-1, N)
    col = lambda k: params[:, k:k + 1]
    A, err_J_prx = warp_jacobians(
        flat(tptx), flat(tpty), flat(tptz), u, v, flat(dpt0), flat(gx),
        flat(gy), col(sg._FX), col(sg._FY), params[:, :9].reshape(P, 3, 3),
        params[:, sg._T0:sg._T0 + 3], avg_dpt)
    JT = torch.cat([
        -(j_pose0.transpose(-1, -2) @ A),
        -(j_pose1.transpose(-1, -2) @ A),
        err_J_prx[:, None, :] * jac0.reshape(-1, N, CS).transpose(1, 2),
    ], dim=1)
    r = flat(img0) - flat(i1)
    w = robust_weight(r, huber_delta, loss)
    wv = torch.where(flat(validf) > 0.5, w, torch.zeros_like(w))
    return JT * wv[..., None, :], r * wv


# ----------------------------------------------------------------------------
# CUDA kernel
# ----------------------------------------------------------------------------

def _check_args(params, warp, dpt0, img0, jac0, j_pose0, j_pose1, u, v,
                loss):
    """What the kernel takes, or raise: (P, H, W, CS)."""
    if loss not in _LOSSES:
        raise ValueError(f"unknown loss {loss!r}")
    if len(warp) != 7:
        raise ValueError(f"warp has {len(warp)} planes, expected 7")
    dev = dpt0.device
    f32 = torch.float32
    if dpt0.dim() != 3:
        raise ValueError(f"dpt0 has shape {tuple(dpt0.shape)}, expected "
                         f"[P, H, W]")
    P, H, W = dpt0.shape
    if jac0.dim() != 4:
        raise ValueError(f"jac0 has shape {tuple(jac0.shape)}, expected "
                         f"[P, H, W, CS]")
    CS = jac0.shape[-1]
    if not 1 <= CS <= sg.MAX_CODE_SIZE:
        raise ValueError(f"code size {CS} is not in 1..{sg.MAX_CODE_SIZE}")
    if not 1 <= P <= _MAX_GRID_Y:
        raise ValueError(f"{P} factors in one call, 1 to {_MAX_GRID_Y}")
    sg._check(params, "params", f32, (P, sg.PARAM_DIM), dev)
    names = ("i1", "gx", "gy", "tptx", "tpty", "tptz", "valid")
    for name, t in zip(names, warp):
        sg._check(t, name, f32, (P, H, W), dev)
    sg._check(dpt0, "dpt0", f32, (P, H, W), dev)
    sg._check(img0, "img0", f32, (P, H, W), dev)
    sg._check(jac0, "jac0", f32, (P, H, W, CS), dev)
    sg._check(j_pose0, "j_pose0", f32, (P, 6, 6), dev)
    sg._check(j_pose1, "j_pose1", f32, (P, 6, 6), dev)
    sg._check(u, "u", f32, (H * W,), dev)
    sg._check(v, "v", f32, (H * W,), dev)
    return P, H, W, CS


def _f32_reciprocal(x: float) -> float:
    """1 / x rounded to float32 from x in float32: how PyTorch's CUDA
    division by a Python scalar scales (a product with this value)."""
    return float(np.float32(1.0) / np.float32(x))


def _jacobian_stack_cuda(params, warp, dpt0, img0, jac0, j_pose0, j_pose1,
                         u, v, huber_delta, avg_dpt, loss):
    P, H, W, CS = _check_args(params, warp, dpt0, img0, jac0, j_pose0,
                              j_pose1, u, v, loss)
    dev = dpt0.device
    N = H * W
    plan = sg.launch_plan("jacobian_stack", P, H, W, CS)
    Jw = torch.empty((P, 12 + CS, N), dtype=torch.float32, device=dev)
    rw = torch.empty((P, N), dtype=torch.float32, device=dev)
    vec4 = int(CS % 4 == 0 and jac0.data_ptr() % 16 == 0)
    tukey = loss == "tukey"
    lib = sg._lib("jacobian_stack.cu", "jacobian_stack_launch",
                  "jacobian_stack_error_string", 17, 9, 3)
    code = lib.jacobian_stack_launch(
        sg._ptr(params), *(sg._ptr(t) for t in warp), sg._ptr(dpt0),
        sg._ptr(img0), sg._ptr(jac0), sg._ptr(j_pose0), sg._ptr(j_pose1),
        sg._ptr(u), sg._ptr(v), sg._ptr(Jw), sg._ptr(rw), P, N, CS,
        plan.nblk, plan.px_per_blk, plan.stride, plan.smem_bytes, vec4,
        int(tukey), float(huber_delta),
        _f32_reciprocal(huber_delta) if tukey else 0.0, float(avg_dpt),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    sg._raise_on(code, lib, "jacobian_stack_error_string")
    LAUNCHES["jacobian_stack"] += 1
    return Jw, rw


# ----------------------------------------------------------------------------
# public entry point
# ----------------------------------------------------------------------------

def jacobian_stack(params, warp, dpt0, img0, jac0, j_pose0, j_pose1, u, v,
                   huber_delta, avg_dpt, loss="huber"):
    """The weighted Jacobian stack of P factors: (Jw [P, 12 + CS, H * W],
    rw [P, H * W]), Jw contiguous.

    params [P, PARAM_DIM] (``dense_warp.make_warp_params``: pose_10's R and
    t, fx, fy); warp the seven [P, H, W] planes of ``dense_warp_batch``
    (i1, gx, gy, tptx, tpty, tptz, valid); dpt0 and img0 [P, H, W]; jac0
    [P, H, W, CS]; j_pose0, j_pose1 [P, 6, 6] (``relative_pose_jacobians``);
    u, v [H * W] the pixels' rays (x - u0) / fx, (y - v0) / fy; every tensor
    float32 and contiguous. The rows are -(j_pose0^T A), -(j_pose1^T A) and
    err_J_prx * jac0, each times wv = valid ? w : 0 with w the robust weight
    of r = img0 - i1 (``loss`` 'huber' or 'tukey' at ``huber_delta``), and
    rw = r * wv."""
    if sg._route(dpt0) == "cuda":
        return _jacobian_stack_cuda(params, warp, dpt0, img0, jac0, j_pose0,
                                    j_pose1, u, v, huber_delta, avg_dpt, loss)
    return jacobian_stack_plain(params, warp, dpt0, img0, jac0, j_pose0,
                                j_pose1, u, v, huber_delta, avg_dpt, loss)
