"""Dense alignment operators: photometric SfM (pose0, pose1, code0),
SE(3) Lucas-Kanade tracking, and code-only depth alignment.

PyTorch port of ``deepfactors_tpu/ops/dense_sfm.py`` (reference SfmAligner /
SE3Aligner / DepthAligner, sources/cuda/cu_sfmaligner.cpp:40-97,
cu_se3aligner.cpp:77-113, cu_depthaligner.cpp:30-71, per-pixel math
dense_sfm.h:72-201 and lucas_kanade_se3.h:35-95). Jacobians are built
feature-major ([D, N]) and reduced with one matmul.

``se3_step`` is one factor of ``ops/kernels/sfm_gram.se3_gram_batch`` and
``se3_warp`` one factor of ``ops/kernels/sfm_error.se3_warp_batch``: the
CUDA kernel on a CUDA tensor, its plain twin on the CPU.
``sfm_evaluate_error`` is the eager reference of ``sfm_error_batch``. With
sampled Sobel gradients (``grad_mode="sampled"``) ``sfm_step`` samples
through one ``ops/kernels/dense_warp.bilinear_warp_plane_list`` call
(kernel ``bilinear_warp_planes``, its planes read in place) and
``sfm_step_batch`` warps and samples every factor in one
``dense_warp_batch`` call; the Jacobians and the JtJ reduction stay batched
PyTorch (one ``bmm`` over the factor axis).

Pose convention (cu_sfmaligner.cpp:131-133): pose0/pose1 are camera-to-world
keyframe poses; pose_10 = pose1^-1 * pose0 maps cam0 points into cam1.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3 as se3m
from ..geometry import warping as wp
from ..geometry.camera import PinholeCamera
from ..geometry.m_estimators import huber_weight, tukey_sqrt_weight
from ..geometry.se3 import SE3
from .image import bilinear_sample, bilinear_sample_grad
from .kernels import dense_warp as dw
from .kernels import sfm_error as se
from .kernels import sfm_gram as sg

Tensor = torch.Tensor


def robust_weight(r, delta, loss: str = "huber"):
    """Square-root IRLS weight by loss name: 'tukey' (redescending, finest
    pyramid level) or 'huber'."""
    if loss == "tukey":
        return tukey_sqrt_weight(r, delta)
    return huber_weight(r, delta)


class SfmParams(NamedTuple):
    """Mirror of DenseSfmParams (dense_sfm.h:36-43)."""

    huber_delta: float = 0.1
    avg_dpt: float = 2.0
    min_dpt: float = 0.0
    valid_border: int = 2


class SystemResult(NamedTuple):
    """Gauss-Newton system accumulated over pixels (JTJJrReductionItem,
    sources/cuda/reduction_items.h:80-143), stored dense."""

    JtJ: Tensor       # [..., D, D]
    Jtr: Tensor       # [..., D]
    residual: Tensor  # [...] sum of squared weighted residuals
    inliers: Tensor   # [...] number of valid pixels


class ErrorResult(NamedTuple):
    residual: Tensor
    inliers: Tensor


def _pixel_grid(H: int, W: int, device) -> Tensor:
    """[H, W, 2] grid of (x, y) pixel coordinates."""
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                            torch.arange(W, dtype=torch.float32, device=device),
                            indexing="ij")
    return torch.stack([xs, ys], dim=-1)


def _masked_system(J: Tensor, r: Tensor, w: Tensor, valid: Tensor) -> SystemResult:
    """Weighted masked GN system from ROW-MAJOR Jacobians J [..., N, D] with
    r, w, valid [..., N]: the weight applies to both rows and residual
    (dense_sfm.h:189-199); an invalid row gets weight 0. Leading axes are
    batched."""
    wv = torch.where(valid, w, torch.zeros_like(w))
    Jw = J * wv[..., None]
    rw = r * wv
    return SystemResult(Jw.transpose(-1, -2) @ Jw,
                        (Jw.transpose(-1, -2) @ rw[..., None])[..., 0],
                        torch.sum(rw * rw, dim=-1),
                        torch.sum(valid.to(torch.float32), dim=-1))


def _masked_system_T(JT: Tensor, r: Tensor, w: Tensor, valid: Tensor) -> SystemResult:
    """Weighted masked GN system from FEATURE-MAJOR Jacobians JT [..., D, N]
    with r, w, valid [..., N] (weight on both rows and residual,
    dense_sfm.h:189-199); leading axes are batched."""
    wv = torch.where(valid, w, torch.zeros_like(w))
    Jw = JT * wv[..., None, :]
    rw = r * wv
    return SystemResult(Jw @ Jw.transpose(-1, -2),
                        (Jw @ rw[..., None])[..., 0],
                        torch.sum(rw * rw, dim=-1),
                        torch.sum(valid.to(torch.float32), dim=-1))


class DenseWarp(NamedTuple):
    """Feature-major correspondence fields, each a flat [N] vector."""

    u: Tensor
    v: Tensor
    tptx: Tensor
    tpty: Tensor
    tptz: Tensor
    pix1x: Tensor
    pix1y: Tensor
    valid: Tensor


def _dense_warp_fields(H, W, dpt, cam, pose_10, border, min_dpt) -> DenseWarp:
    """FindCorrespondence over the full image (warping.h:204-241), unrolled."""
    grid = _pixel_grid(H, W, dpt.device).reshape(-1, 2)
    xs, ys = grid[:, 0], grid[:, 1]
    u = (xs - cam.u0) / cam.fx
    v = (ys - cam.v0) / cam.fy
    ptx = u * dpt
    pty = v * dpt
    R = se3m.quat_to_matrix(pose_10.q)
    t = pose_10.t
    tptx = R[0, 0] * ptx + R[0, 1] * pty + R[0, 2] * dpt + t[0]
    tpty = R[1, 0] * ptx + R[1, 1] * pty + R[1, 2] * dpt + t[1]
    tptz = R[2, 0] * ptx + R[2, 1] * pty + R[2, 2] * dpt + t[2]
    pix1x = cam.fx * tptx / tptz + cam.u0
    pix1y = cam.fy * tpty / tptz + cam.v0
    b = float(border)
    valid = ((tptz > min_dpt) & (pix1x >= b) & (pix1x < cam.width - b)
             & (pix1y >= b) & (pix1y < cam.height - b))
    return DenseWarp(u, v, tptx, tpty, tptz, pix1x, pix1y, valid)


def _unrolled_warp_jacobians(warp: DenseWarp, dpt, cam, pose_10, gx, gy,
                             avg_dpt):
    """Gradient-contracted warp Jacobians A [..., 6, N] (w.r.t. pose_10) and
    the prox chain err_J_prx [..., N] (dense_sfm.h:124-201), unrolled. A
    leading factor axis on the fields and the pose is batched; warp.u and
    warp.v may stay [N]."""
    x, y, z = warp.tptx, warp.tpty, warp.tptz
    iz = 1.0 / z
    d00 = cam.fx * iz
    d02 = -cam.fx * x * iz * iz
    d11 = cam.fy * iz
    d12 = -cam.fy * y * iz * iz
    gd0 = gx * d00
    gd1 = gy * d11
    gd2 = gx * d02 + gy * d12
    t10 = pose_10.t[..., None]                    # [..., 3, 1]
    vx = x - t10[..., 0, :]
    vy = y - t10[..., 1, :]
    vz = z - t10[..., 2, :]
    A = torch.stack([gd0, gd1, gd2, -gd1 * vz + gd2 * vy,
                     gd0 * vz - gd2 * vx, -gd0 * vy + gd1 * vx], dim=-2)
    R = se3m.quat_to_matrix(pose_10.q)[..., None]  # [..., 3, 3, 1]
    u, v = warp.u, warp.v
    m0 = R[..., 0, 0, :] * u + R[..., 0, 1, :] * v + R[..., 0, 2, :]
    m1 = R[..., 1, 0, :] * u + R[..., 1, 1, :] * v + R[..., 1, 2, :]
    m2 = R[..., 2, 0, :] * u + R[..., 2, 1, :] * v + R[..., 2, 2, :]
    pjd0 = d00 * m0 + d02 * m2
    pjd1 = d11 * m1 + d12 * m2
    dpt_J_prx = wp.depth_jacobian_prx(dpt, avg_dpt)
    err_J_prx = -(gx * pjd0 + gy * pjd1) * dpt_J_prx
    return A, err_J_prx


def _sample_img_grad_xy(img1, grad1, x1, y1, grad_mode):
    """Sample (img, gx, gy) at warped coords [N]: the exact gradient of the
    bilinear interpolant ('interp'), or img1 and its Sobel planes in one
    ``bilinear_warp_plane_list`` call ('sampled'), which reads img1 and the
    two channels of the interleaved grad1 [H, W, 2] in place."""
    if grad_mode == "interp":
        return bilinear_sample_grad(img1, torch.stack([x1, y1], dim=-1))
    H, W = img1.shape
    s = dw.bilinear_warp_plane_list(
        (img1, grad1[..., 0], grad1[..., 1]),
        x1.reshape(H, W).contiguous(), y1.reshape(H, W).contiguous())
    return s[0].reshape(-1), s[1].reshape(-1), s[2].reshape(-1)


def sfm_step(pose0: SE3, pose1: SE3, code0: Tensor, cam: PinholeCamera,
             img0: Tensor, img1: Tensor, dpt0: Tensor, std0: Tensor,
             prx_jac0: Tensor, grad1: Tensor, params: SfmParams,
             grad_mode: str = "sampled", loss: str = "huber"):
    """One SfM linearisation: (SystemResult [12+CS], valid0 [H, W]) with the
    J-row layout [dErr/dpose0 | dErr/dpose1 | dErr/dcode0] (dense_sfm.h:
    124-201). prx_jac0 is [H, W, CS]."""
    H, W = img0.shape
    CS = prx_jac0.shape[-1]
    pose_10, j_pose1, j_pose0 = se3m.relative_pose_jacobians(pose1, pose0)
    dpt = dpt0.reshape(-1)
    warp = _dense_warp_fields(H, W, dpt, cam, pose_10, params.valid_border,
                              params.min_dpt)
    i1, gx, gy = _sample_img_grad_xy(img1, grad1, warp.pix1x, warp.pix1y,
                                     grad_mode)
    A, err_J_prx = _unrolled_warp_jacobians(warp, dpt, cam, pose_10, gx, gy,
                                            params.avg_dpt)
    Jp0T = -(j_pose0.T @ A)
    Jp1T = -(j_pose1.T @ A)
    JcT = err_J_prx[None, :] * prx_jac0.reshape(-1, CS).T
    JT = torch.cat([Jp0T, Jp1T, JcT], dim=0)
    r = img0.reshape(-1) - i1
    w = robust_weight(r, params.huber_delta, loss)
    sys = _masked_system_T(JT, r, w, warp.valid)
    return sys, warp.valid.reshape(H, W).to(img0.dtype)


# Factors linearised at once in ``sfm_step_batch``: the [chunk, 12 + CS, N]
# Jacobian stack and its weighted copy are held to this many bytes each.
_JT_CHUNK_BYTES = 1 << 30


def sfm_step_batch(poses0: SE3, poses1: SE3, codes0: Tensor,
                   cam: PinholeCamera, img0s, img1s, dpt0s, std0s, jacs0,
                   grad1s, params: SfmParams, grad_mode: str = "sampled",
                   loss: str = "huber") -> SystemResult:
    """Batched SfM linearisation over P factors ([P, ...] inputs, jacs0
    [P, H, W, CS]).

    With sampled gradients the correspondence and the samples of every
    factor come from ONE ``dense_warp_batch`` call (per chunk of factors,
    when the Jacobian stack of all P would pass ``_JT_CHUNK_BYTES``), and
    the Jacobians and the JtJ reduction are batched over the factor axis.
    ``grad_mode="interp"`` is a loop over ``sfm_step``."""
    P, H, W = img0s.shape
    if grad_mode == "interp":
        out = [sfm_step(se3m.index(poses0, p), se3m.index(poses1, p),
                        codes0[p], cam, img0s[p], img1s[p], dpt0s[p],
                        std0s[p], jacs0[p], grad1s[p], params, grad_mode,
                        loss)[0] for p in range(P)]
        return SystemResult(*(torch.stack(x) for x in zip(*out)))

    CS = jacs0.shape[-1]
    N = H * W
    pose_10, j_pose1, j_pose0 = se3m.relative_pose_jacobians(poses1, poses0)
    wparams = dw.make_warp_params(pose_10, cam, params.valid_border,
                                  params.min_dpt)
    grid = _pixel_grid(H, W, img0s.device).reshape(-1, 2)
    u = (grid[:, 0] - cam.u0) / cam.fx
    v = (grid[:, 1] - cam.v0) / cam.fy
    chunk = max(1, _JT_CHUNK_BYTES // ((12 + CS) * N * 4))
    out = []
    for a in range(0, P, chunk):
        c = slice(a, a + chunk)
        dpt = dpt0s[c].contiguous()
        i1, gx, gy, tptx, tpty, tptz, validf = dw.dense_warp_batch(
            wparams[c], dpt, img1s[c].contiguous(),
            grad1s[c, ..., 0].contiguous(), grad1s[c, ..., 1].contiguous())
        flat = lambda x: x.reshape(-1, N)
        warp = DenseWarp(u, v, flat(tptx), flat(tpty), flat(tptz), None, None,
                         flat(validf) > 0.5)
        A, err_J_prx = _unrolled_warp_jacobians(
            warp, flat(dpt), cam, se3m.index(pose_10, c), flat(gx), flat(gy),
            params.avg_dpt)
        JT = torch.cat([
            -(j_pose0[c].transpose(-1, -2) @ A),
            -(j_pose1[c].transpose(-1, -2) @ A),
            err_J_prx[:, None, :] * jacs0[c].reshape(-1, N, CS).transpose(1, 2),
        ], dim=1)
        r = flat(img0s[c]) - flat(i1)
        w = robust_weight(r, params.huber_delta, loss)
        out.append(_masked_system_T(JT, r, w, warp.valid))
    return SystemResult(*(torch.cat(x) for x in zip(*out)))


def sfm_evaluate_error(pose0: SE3, pose1: SE3, cam: PinholeCamera,
                       img0: Tensor, img1: Tensor, dpt0: Tensor, std0: Tensor,
                       grad1: Tensor, params: SfmParams) -> ErrorResult:
    """Residual + inlier evaluation only (dense_sfm.h:72-119), with the eval
    kernel's border=1 / min_dpt=0."""
    H, W = img0.shape
    pose_10 = se3m.relative_pose(pose1, pose0)
    pix0 = _pixel_grid(H, W, img0.device).reshape(-1, 2)
    corresp = wp.find_correspondence(pix0, dpt0.reshape(-1), cam, pose_10,
                                     border=1, min_dpt=0.0)
    i1 = bilinear_sample(img1, corresp.pix1)
    r = img0.reshape(-1) - i1
    w = huber_weight(r, params.huber_delta)
    rw = torch.where(corresp.valid, r * w, torch.zeros_like(r))
    return ErrorResult(residual=torch.sum(rw * rw),
                       inliers=torch.sum(corresp.valid.to(torch.float32)))


def normalized_residual(residual: Tensor, inliers: Tensor, H: int, W: int):
    """residual / inliers * W * H, inf on zero inliers
    (photometric_factor.cpp:203-216)."""
    return torch.where(inliers > 0,
                       residual / torch.clamp(inliers, min=1.0) * (W * H),
                       torch.full_like(residual, float("inf")))


def se3_step(pose_10: SE3, cam: PinholeCamera, img0: Tensor, img1: Tensor,
             dpt0: Tensor, grad1: Tensor, huber_delta: float,
             grad_mode: str = "sampled") -> SystemResult:
    """One tracking GN linearisation (lucas_kanade_se3.h:35-77). pose_10 maps
    keyframe (cam0) points into the live frame (cam1)."""
    kp = sg.make_sfm_params(SE3(pose_10.q[None], pose_10.t[None]), cam,
                            1, 0.0, huber_delta, 2.0)
    z = torch.zeros((1,), dtype=torch.int32, device=img0.device)
    gxy = (None, None)
    if grad_mode == "sampled":
        gxy = (grad1[..., 0][None].contiguous(),
               grad1[..., 1][None].contiguous())
    G = sg.se3_gram_batch(kp, z, z, img0[None], dpt0[None], img1[None],
                          *gxy, grad_mode=grad_mode)[0]
    JtJ = 0.5 * (G[:6, :6] + G[:6, :6].T)
    return SystemResult(JtJ=JtJ, Jtr=G[:6, 6], residual=G[6, 6],
                        inliers=G[7, 7])


def se3_warp(pose_10: SE3, cam: PinholeCamera, img0: Tensor, img1: Tensor,
             dpt0: Tensor):
    """Render img1 warped into cam0's frame, with residual and inlier
    statistics (cu_se3aligner.cpp kernel_warp_calculate :37-75): one factor
    of ``se3_warp_batch``. Returns (warped [H, W], ErrorResult)."""
    kp = sg.make_sfm_params(SE3(pose_10.q[None], pose_10.t[None]), cam,
                            1, 0.0, 0.1, 2.0)
    z = torch.zeros((1,), dtype=torch.int32, device=img0.device)
    warped, res, inl = se.se3_warp_batch(kp, z, z, img0[None].contiguous(),
                                         dpt0[None].contiguous(),
                                         img1[None].contiguous())
    return warped[0], ErrorResult(residual=res[0], inliers=inl[0])


def depth_align_step(code: Tensor, target_dpt: Tensor, prx_orig: Tensor,
                     prx_jac: Tensor, avg_dpt: float = 2.0) -> SystemResult:
    """GN system of depth-vs-target over the code only (code [CS],
    target_dpt/prx_orig [H, W], prx_jac [H, W, CS]), with the reference's
    own Jacobian weighting (cu_depthaligner.cpp:46-68):
    J = -2|diff| * dDpt/dPrx * prx_J_cde."""
    CS = prx_jac.shape[-1]
    prx = prx_orig + torch.einsum("hwc,c->hw", prx_jac, code)
    dpt = wp.prox_to_depth(prx, avg_dpt)
    diff = (target_dpt - dpt).reshape(-1)
    dJp = wp.depth_jacobian_prx(dpt, avg_dpt).reshape(-1)
    JT = (-2.0 * diff.abs() * dJp)[None, :] * prx_jac.reshape(-1, CS).T
    return _masked_system_T(JT, diff, torch.ones_like(diff),
                            torch.ones_like(diff, dtype=torch.bool))


def depth_align_step_T(code: Tensor, target_dpt: Tensor, prx_orig: Tensor,
                       prx_jacT: Tensor, avg_dpt: float = 2.0) -> SystemResult:
    """``depth_align_step`` on the feature-major Jacobian layout (prx_jacT
    [..., CS, H, W], as ``map_state.LevelData.jac``); leading axes on every
    argument are batched. Unlike ``depth_align_step`` (whose GN steps have a
    magnitude independent of |diff| and do not converge), J is the true
    residual Jacobian d(tgt - dpt)/d code = -dDpt/dPrx * prx_J."""
    CS = prx_jacT.shape[-3]
    lead = prx_jacT.shape[:-3]
    prx = prx_orig + torch.einsum("...chw,...c->...hw", prx_jacT, code)
    dpt = wp.prox_to_depth(prx, avg_dpt)
    diff = (target_dpt - dpt).reshape(lead + (-1,))
    dJp = wp.depth_jacobian_prx(dpt, avg_dpt).reshape(lead + (-1,))
    JT = (-dJp)[..., None, :] * prx_jacT.reshape(lead + (CS, -1))
    return _masked_system_T(JT, diff, torch.ones_like(diff),
                            torch.ones_like(diff, dtype=torch.bool))


def _cholesky_nan(A: Tensor) -> Tensor:
    """Cholesky factor, NaN where a block is not positive definite (the JAX
    semantics; ``torch.linalg.cholesky`` would raise and sync)."""
    L, info = torch.linalg.cholesky_ex(A)
    bad = (info != 0).reshape(info.shape + (1, 1))
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def se3_solve_and_update(JtJ: Tensor, Jtr: Tensor, pose: SE3,
                         damping=0.0) -> SE3:
    """Solve the 6x6 normal equations and retract with the decoupled update
    (lucas_kanade_se3.h:84-95)."""
    A = JtJ + damping * torch.eye(6, dtype=JtJ.dtype, device=JtJ.device)
    L = _cholesky_nan(A)
    update = -torch.cholesky_solve(Jtr[..., None], L)[..., 0]
    return se3m.retract(pose, update)
