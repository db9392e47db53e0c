"""Sparse factor operators: keypoint reprojection and geometric depth
consistency.

PyTorch port of ``deepfactors_tpu/ops/sparse_factors.py``:
  - ReprojectionFactor (sources/core/gtsam/reprojection_factor.cpp:
    159-269): 2 rows per match over (pose0, pose1, code0); residual
    pix1_obs - warp, Cauchy-weighted, scaled by 1/sigma.
  - SparseGeometricFactor (sources/core/gtsam/sparse_geometric_factor.cpp:
    146-268): 1 row per sampled point over (pose0, pose1, code0, code1);
    residual dpt1_decoded - dpt1_projected with a nearest-neighbour code
    lookup at the projected pixel, Huber-weighted.
The masked weighted Jacobian rows reduce to the GN system in one matmul,
like the dense ops.

Every function takes one factor or a batch of P factors (a leading axis on
every argument but the camera: poses [P], codes [P, CS], keypoints or
points [P, M, 2], images [P, H, W] and [P, CS, H, W]), so the mapper
evaluates a whole factor pool at once. With ``src`` [P] (and, for the
geometric factor, ``dst`` [P]) the images are the keyframe pools
([K, H, W], [K, CS, H, W], [K, H, W, 2]) and factor p reads slot src[p]
(dst[p]): only the sampled pixels of the prox and Jacobian pools are
read; the depth-gradient planes of the P targets are gathered. Plain
PyTorch: no hand-written kernel (the JAX package computes both factors as
plain XLA).
"""
from __future__ import annotations

import torch

from ..geometry import camera as cm
from ..geometry import se3 as se3m
from ..geometry import warping as wp
from ..geometry.camera import PinholeCamera
from ..geometry.m_estimators import cauchy_weight, huber_weight
from ..geometry.se3 import SE3
from . import image as ip
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


def _geo_warp(pose0: SE3, pose1: SE3, code0, code1, cam, points, prx0_img0,
              jac_img0, prx0_img1, jac_img1, avg_dpt, src, dst, **find_kw):
    """The decoded depth at the points of keyframe 0, their correspondence
    in keyframe 1, and keyframe 1's decoded depth at the nearest pixel of
    each (poses [P], points [P, N, 2])."""
    prx0_p, jac0_p = _sample_code_data(prx0_img0, jac_img0, points, src)
    dpt0 = wp.depth_from_code(code0[:, None, :], jac0_p, prx0_p, avg_dpt)
    pose_10 = se3m.relative_pose(pose1, pose0)
    pose_10 = SE3(pose_10.q[:, None], pose_10.t[:, None])
    corr = wp.find_correspondence(points, dpt0, cam, pose_10, **find_kw)
    prx1_nn, jac1_nn = _sample_code_data(prx0_img1, jac_img1, corr.pix1, dst)
    dpt1 = wp.depth_from_code(code1[:, None, :], jac1_nn, prx1_nn, avg_dpt)
    return jac0_p, dpt0, pose_10, corr, jac1_nn, dpt1


def geometric_system(
    pose0: SE3,
    pose1: SE3,
    code0: Tensor,        # [(P,) CS]
    code1: Tensor,        # [(P,) CS]
    cam: PinholeCamera,
    points: Tensor,       # [(P,) N, 2] sampled pixels in keyframe 0
    prx0_img0: Tensor,    # [(P,) H, W] keyframe 0's zero-code prox
    jac_img0: Tensor,     # [(P,) CS, H, W] feature-major
    prx0_img1: Tensor,    # [(P,) H, W] keyframe 1's
    jac_img1: Tensor,     # [(P,) CS, H, W]
    dpt1_grad: Tensor,    # [(P,) H, W, 2] gradient of keyframe 1's depth
    huber_delta: float = 0.1,
    avg_dpt: float = 2.0,
    src: Tensor = None,   # [P] pool slots of keyframe 0's images
    dst: Tensor = None,   # [P] pool slots of keyframe 1's images
) -> SystemResult:
    """GN system [(P,) 12+2CS] of depth consistency at the sampled points,
    laid out [pose0 | pose1 | code0 | code1]. The Jacobians are the true
    derivatives of err = dpt1 - dpt1_projected (the reference stores their
    negation, since GTSAM's JacobianFactor solves |A dx - b| with b = +err).
    A point counts where its correspondence is valid (border 1, positive
    depth) and lands inside the image."""
    single = points.dim() == 2
    if single:
        pose0, pose1, code0, code1, points, prx0_img0, jac_img0, prx0_img1, \
            jac_img1, dpt1_grad = _batched(
                pose0, pose1, code0, code1, points, prx0_img0, jac_img0,
                prx0_img1, jac_img1, dpt1_grad)
    _, j_pose1, j_pose0 = se3m.relative_pose_jacobians(pose1, pose0)
    jac0_p, dpt0, pose_10, corr, jac1_nn, dpt1 = _geo_warp(
        pose0, pose1, code0, code1, cam, points, prx0_img0, jac_img0,
        prx0_img1, jac_img1, avg_dpt, src, dst, border=1, min_dpt=0.0)
    valid = corr.valid & cm.pixel_valid(cam, corr.pix1)
    err = dpt1 - corr.tpt[..., 2]
    dg = dpt1_grad if dst is None else dpt1_grad[dst.long()]        # [P,H,W,2]
    dpt_grad = torch.stack([ip.bilinear_sample(dg[..., k], corr.pix1)
                            for k in (0, 1)], dim=-1)                # [P,N,2]

    # d err/d pose = dpt_grad @ d pix1/d pose - (transform Jacobian)[z row]
    cJp = wp.correspondence_jacobian_pose(corr, dpt0, cam, pose_10)  # [P,N,2,6]
    tJz = se3m.transform_jacobian_pose(corr.pt, pose_10)[..., 2, :]  # [P,N,6]
    g_cJp = torch.einsum("pnc,pnck->pnk", dpt_grad, cJp)
    along = lambda J, j: torch.einsum("pnk,pkj->pnj", J, j)
    Jp0 = -along(tJz, j_pose0) + along(g_cJp, j_pose0)
    Jp1 = -along(tJz, j_pose1) + along(g_cJp, j_pose1)

    # code0 moves both the projected depth and the lookup point
    cJc0 = wp.correspondence_jacobian_code(corr, dpt0, cam, pose_10, jac0_p,
                                           avg_dpt)                 # [P,N,2,CS]
    Rz = se3m.quat_to_matrix(pose_10.q)[..., 2, :]                  # [P,1,3]
    pt_J_dpt = cm.reproject_depth_jacobian(cam, corr.pix0, dpt0)   # [P,N,3]
    dJp = wp.depth_jacobian_prx(dpt0, avg_dpt)
    tz_J_cde = (torch.sum(Rz * pt_J_dpt, dim=-1) * dJp)[..., None] * jac0_p
    Jc0 = -tz_J_cde + torch.einsum("pnc,pnck->pnk", dpt_grad, cJc0)

    # code1: the decode's own derivative at the looked-up pixel
    Jc1 = wp.depth_jacobian_prx(dpt1, avg_dpt)[..., None] * jac1_nn

    J = torch.cat([Jp0, Jp1, Jc0, Jc1], dim=-1)                     # [P,N,D]
    sys = _masked_system(J, err, huber_weight(err, huber_delta), valid)
    if single:
        return SystemResult(*(x[0] for x in sys))
    return sys


def geometric_error(
    pose0: SE3, pose1: SE3, code0: Tensor, code1: Tensor, cam: PinholeCamera,
    points: Tensor, prx0_img0: Tensor, jac_img0: Tensor,
    prx0_img1: Tensor, jac_img1: Tensor,
    huber_delta: float = 0.1, avg_dpt: float = 2.0,
) -> Tensor:
    """0.5 * sum (w err)^2 over the valid points (sparse_geometric_factor.cpp:
    85-142), [(P,)]. Validity is ``find_correspondence``'s own (its default
    border and depth test), without the system's extra in-image test."""
    single = points.dim() == 2
    if single:
        pose0, pose1, code0, code1, points, prx0_img0, jac_img0, prx0_img1, \
            jac_img1 = _batched(pose0, pose1, code0, code1, points, prx0_img0,
                                jac_img0, prx0_img1, jac_img1)
    *_, corr, _, dpt1 = _geo_warp(pose0, pose1, code0, code1, cam, points,
                                  prx0_img0, jac_img0, prx0_img1, jac_img1,
                                  avg_dpt, None, None)
    d = corr.tpt[..., 2] - dpt1
    err = d * huber_weight(d, huber_delta)
    sq = torch.where(corr.valid, err * err, torch.zeros_like(err))
    out = 0.5 * torch.sum(sq, dim=-1)
    return out[0] if single else out
