"""Dense warping math: proximity<->depth, correspondence and its Jacobians.

PyTorch port of ``deepfactors_tpu/geometry/warping.py`` (reference
sources/common/algorithm/warping.h). All functions work on arbitrary leading
batch dims; validity is a boolean mask instead of early-exit branches.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import camera as cm
from . import se3 as se3m
from .camera import PinholeCamera
from .se3 import SE3

Tensor = torch.Tensor


# ----------------------------------------------------------------------------
# Proximity (inverse-depth-like) parametrization (warping.h:30-69)
# ----------------------------------------------------------------------------

def prox_to_depth(prx: Tensor, avg_dpt) -> Tensor:
    return avg_dpt / prx - avg_dpt


def depth_to_prox(dpt: Tensor, avg_dpt) -> Tensor:
    return avg_dpt / (avg_dpt + dpt)


def depth_jacobian_prx(dpt: Tensor, avg_dpt) -> Tensor:
    """d depth / d prx evaluated at depth (warping.h:44-50)."""
    prx = avg_dpt / (avg_dpt + dpt)
    return -avg_dpt / (prx * prx)


def prox_from_code(code: Tensor, prx_J_cde: Tensor, prx_0code: Tensor) -> Tensor:
    """prx = prx0 + J·c, linear-in-code decode (warping.h:52-59)."""
    return prx_0code + torch.sum(prx_J_cde * code, dim=-1)


def depth_from_code(code: Tensor, prx_J_cde: Tensor, prx_0code: Tensor,
                    avg_dpt) -> Tensor:
    return prox_to_depth(prox_from_code(code, prx_J_cde, prx_0code), avg_dpt)


# ----------------------------------------------------------------------------
# Correspondence (warping.h:188-241)
# ----------------------------------------------------------------------------

class Correspondence(NamedTuple):
    pix0: Tensor   # [..., 2] source pixel
    pt: Tensor     # [..., 3] reprojected point in cam0
    tpt: Tensor    # [..., 3] point transformed to cam1
    pix1: Tensor   # [..., 2] projected pixel in cam1
    valid: Tensor  # [...] bool


def find_correspondence(pix0: Tensor, dpt: Tensor, cam: PinholeCamera,
                        pose_10: SE3, border: float = 1.0,
                        min_dpt: float = 0.0,
                        check_bounds: bool = True) -> Correspondence:
    """Warp pixels pix0 [..., 2] at depth dpt [...] through pose_10
    (warping.h:204-241). pose_10 maps cam0 points into cam1."""
    pt = cm.reproject(cam, pix0, dpt)
    tpt = se3m.act(pose_10, pt)
    pix1 = cm.project(cam, tpt)
    valid = tpt[..., 2] > min_dpt
    if check_bounds:
        valid = valid & cm.pixel_valid(cam, pix1, border)
    return Correspondence(pix0=pix0, pt=pt, tpt=tpt, pix1=pix1, valid=valid)


def correspondence_jacobian_pose(corresp: Correspondence, dpt: Tensor,
                                 cam: PinholeCamera, pose_10: SE3) -> Tensor:
    """d pix1 / d pose10 (decoupled tangent): [..., 2, 6] (warping.h:247-257)."""
    dXdT = se3m.transform_jacobian_pose(corresp.pt, pose_10)
    dCam = cm.project_point_jacobian(cam, corresp.tpt)
    return dCam @ dXdT


def correspondence_jacobian_depth(corresp: Correspondence, dpt: Tensor,
                                  cam: PinholeCamera, pose_10: SE3) -> Tensor:
    """d pix1 / d dpt: [..., 2] (warping.h:259-272)."""
    pix1_J_tpt = cm.project_point_jacobian(cam, corresp.tpt)
    R = se3m.quat_to_matrix(pose_10.q)
    pt_J_dpt = cm.reproject_depth_jacobian(cam, corresp.pix0, dpt)
    R = R.expand(pix1_J_tpt.shape[:-2] + (3, 3))
    return torch.einsum("...ij,...jk,...k->...i", pix1_J_tpt, R, pt_J_dpt)


def correspondence_jacobian_prx(corresp: Correspondence, dpt: Tensor,
                                cam: PinholeCamera, pose_10: SE3,
                                avg_dpt) -> Tensor:
    """d pix1 / d prx: [..., 2] (warping.h:275-291)."""
    pix1_J_dpt = correspondence_jacobian_depth(corresp, dpt, cam, pose_10)
    return pix1_J_dpt * depth_jacobian_prx(dpt, avg_dpt)[..., None]


def correspondence_jacobian_code(corresp: Correspondence, dpt: Tensor,
                                 cam: PinholeCamera, pose_10: SE3,
                                 prx_J_cde: Tensor, avg_dpt) -> Tensor:
    """d pix1 / d code: [..., 2, CS] (warping.h:294-313)."""
    pix1_J_prx = correspondence_jacobian_prx(corresp, dpt, cam, pose_10,
                                             avg_dpt)
    return pix1_J_prx[..., :, None] * prx_J_cde[..., None, :]


# ----------------------------------------------------------------------------
# Gradient-contracted warp Jacobians, unrolled (dense_sfm.h:124-201)
# ----------------------------------------------------------------------------

def warp_jacobians(x, y, z, u, v, dpt, gx, gy, fx, fy, R, t, avg_dpt):
    """Gradient-contracted warp Jacobians A [..., 6, N] (w.r.t. pose_10) and
    the prox chain err_J_prx [..., N] (dense_sfm.h:124-201), unrolled.

    x, y, z are the transformed points and gx, gy the sampled gradients
    [..., N]; u, v the pixels' rays; R [..., 3, 3] and t [..., 3] pose_10's
    rotation and translation; fx, fy floats or [..., 1]. A leading factor
    axis is batched; u and v may stay [N]."""
    iz = 1.0 / z
    d00 = fx * iz
    d02 = -fx * x * iz * iz
    d11 = fy * iz
    d12 = -fy * y * iz * iz
    gd0 = gx * d00
    gd1 = gy * d11
    gd2 = gx * d02 + gy * d12
    t10 = t[..., None]                            # [..., 3, 1]
    vx = x - t10[..., 0, :]
    vy = y - t10[..., 1, :]
    vz = z - t10[..., 2, :]
    A = torch.stack([gd0, gd1, gd2, -gd1 * vz + gd2 * vy,
                     gd0 * vz - gd2 * vx, -gd0 * vy + gd1 * vx], dim=-2)
    R = R[..., None]                              # [..., 3, 3, 1]
    m0 = R[..., 0, 0, :] * u + R[..., 0, 1, :] * v + R[..., 0, 2, :]
    m1 = R[..., 1, 0, :] * u + R[..., 1, 1, :] * v + R[..., 1, 2, :]
    m2 = R[..., 2, 0, :] * u + R[..., 2, 1, :] * v + R[..., 2, 2, :]
    pjd0 = d00 * m0 + d02 * m2
    pjd1 = d11 * m1 + d12 * m2
    dpt_J_prx = depth_jacobian_prx(dpt, avg_dpt)
    err_J_prx = -(gx * pjd0 + gy * pjd1) * dpt_J_prx
    return A, err_J_prx
