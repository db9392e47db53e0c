"""SE(3) / SO(3) utilities on the decoupled R^3 x SO(3) manifold.

PyTorch port of ``deepfactors_tpu/geometry/se3.py``. Conventions are the
reference's:
  - decoupled retract  t += dt;  R = exp(dw) @ R
    (reference: sources/core/gtsam/gtsam_traits.h:48-58)
  - local coordinates  [t_b - t_a, log(R_b R_a^-1)]
    (reference: sources/core/gtsam/gtsam_traits.h:66-72)
  - pose distance with translation/rotation weights, roll ignored
    (reference: sources/common/algorithm/warping.h:139-147)

Poses are a NamedTuple ``SE3`` of a unit quaternion ``q`` (wxyz, [..., 4])
and a translation ``t`` ([..., 3]), camera-to-world. Every function works on
arbitrary leading batch dimensions and never moves data between devices.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor

_EPS = 1e-8


class SE3(NamedTuple):
    """Rigid transform: x -> R(q) @ x + t. Batched over leading dims."""

    q: Tensor  # [..., 4] unit quaternion, wxyz
    t: Tensor  # [..., 3]

    @property
    def batch_shape(self):
        return self.t.shape[:-1]

    def matrix(self) -> Tensor:
        """[..., 3, 3] rotation matrix."""
        return quat_to_matrix(self.q)

    def matrix4(self) -> Tensor:
        """[..., 4, 4] homogeneous matrix."""
        top = torch.cat([self.matrix(), self.t[..., :, None]], dim=-1)
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=self.t.dtype,
                              device=self.t.device)
        bottom = bottom.expand(top.shape[:-2] + (1, 4))
        return torch.cat([top, bottom], dim=-2)


def identity(batch_shape=(), dtype=torch.float32, device="cuda") -> SE3:
    q = torch.zeros(tuple(batch_shape) + (4,), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return SE3(q, torch.zeros(tuple(batch_shape) + (3,), dtype=dtype,
                              device=device))


def from_matrix(T: Tensor) -> SE3:
    """Build SE3 from a [..., 4, 4] or [..., 3, 4] homogeneous matrix."""
    return SE3(matrix_to_quat(T[..., :3, :3]), T[..., :3, 3])


# ----------------------------------------------------------------------------
# Quaternion algebra (wxyz)
# ----------------------------------------------------------------------------

def quat_mul(a: Tensor, b: Tensor) -> Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q: Tensor) -> Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def _cross(a: Tensor, b: Tensor) -> Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: Tensor, v: Tensor) -> Tensor:
    """Rotate vector(s) v [..., 3] by quaternion(s) q [..., 4]."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = _cross(u, v)
    return v + 2.0 * _cross(u, uv + w * v)


def quat_normalize(q: Tensor) -> Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_to_matrix(q: Tensor) -> Tensor:
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
        ],
        dim=-2,
    )


def matrix_to_quat(R: Tensor) -> Tensor:
    """Shepperd's method, branch-free via torch.where."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    qw0 = safe_sqrt(1.0 + tr)
    c0 = torch.stack([qw0, (m21 - m12) / qw0, (m02 - m20) / qw0,
                      (m10 - m01) / qw0], -1)
    qx1 = safe_sqrt(1.0 + m00 - m11 - m22)
    c1 = torch.stack([(m21 - m12) / qx1, qx1, (m01 + m10) / qx1,
                      (m02 + m20) / qx1], -1)
    qy2 = safe_sqrt(1.0 - m00 + m11 - m22)
    c2 = torch.stack([(m02 - m20) / qy2, (m01 + m10) / qy2, qy2,
                      (m12 + m21) / qy2], -1)
    qz3 = safe_sqrt(1.0 - m00 - m11 + m22)
    c3 = torch.stack([(m10 - m01) / qz3, (m02 + m20) / qz3,
                      (m12 + m21) / qz3, qz3], -1)

    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    q = torch.where(cond0, c0, torch.where(cond1, c1, torch.where(cond2, c2, c3)))
    return quat_normalize(0.5 * q)


# ----------------------------------------------------------------------------
# SO(3) exp / log
# ----------------------------------------------------------------------------

def so3_exp_quat(w: Tensor) -> Tensor:
    """Axis-angle [..., 3] -> unit quaternion, Taylor-safe near zero."""
    theta_sq = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(theta_sq)
    half = 0.5 * theta
    small = theta_sq < _EPS
    k = torch.where(small, 0.5 - theta_sq / 48.0,
                    torch.sin(half) / torch.where(small, torch.ones_like(theta),
                                                  theta))
    cw = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    return torch.cat([cw, k * w], dim=-1)


def so3_log(q: Tensor) -> Tensor:
    """Unit quaternion -> axis-angle [..., 3], Taylor-safe near identity."""
    w = q[..., :1]
    v = q[..., 1:]
    # force the positive hemisphere for the shortest rotation
    sign = torch.where(w < 0, -1.0, 1.0)
    w = w * sign
    v = v * sign
    vn = torch.linalg.norm(v, dim=-1, keepdim=True)
    small = vn < _EPS
    theta = 2.0 * torch.atan2(vn, w)
    k = torch.where(small, 2.0 / torch.clamp(w, min=0.5),
                    theta / torch.where(small, torch.ones_like(vn), vn))
    return k * v


def hat(w: Tensor) -> Tensor:
    """so(3) hat operator: [..., 3] -> [..., 3, 3] skew matrix."""
    wx, wy, wz = w.unbind(-1)
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


# ----------------------------------------------------------------------------
# SE(3) group ops
# ----------------------------------------------------------------------------

def mul(a: SE3, b: SE3) -> SE3:
    """Compose: (a*b)(x) = a(b(x))."""
    return SE3(quat_normalize(quat_mul(a.q, b.q)), quat_rotate(a.q, b.t) + a.t)


def inverse(a: SE3) -> SE3:
    qi = quat_conj(a.q)
    return SE3(qi, -quat_rotate(qi, a.t))


def act(a: SE3, x: Tensor) -> Tensor:
    """Apply the transform to points x [..., 3]."""
    return quat_rotate(a.q, x) + a.t


def retract(pose: SE3, delta: Tensor) -> SE3:
    """Decoupled retract (reference gtsam_traits.h:48-58):
    t_new = t + delta[:3];  R_new = exp(delta[3:]) @ R."""
    dq = so3_exp_quat(delta[..., 3:6])
    return SE3(quat_normalize(quat_mul(dq, pose.q)), pose.t + delta[..., :3])


def local(a: SE3, b: SE3) -> Tensor:
    """Inverse of retract: coordinates of b in the tangent of a
    (reference gtsam_traits.h:66-72)."""
    dw = so3_log(quat_mul(b.q, quat_conj(a.q)))
    return torch.cat([b.t - a.t, dw], dim=-1)


def relative_pose(pose_a: SE3, pose_b: SE3) -> SE3:
    """pose_ab = pose_a^-1 * pose_b (reference warping.h:98-103)."""
    return mul(inverse(pose_a), pose_b)


def relative_pose_jacobians(pose_a: SE3, pose_b: SE3):
    """Relative pose + 6x6 Jacobians of its decoupled-tangent coordinates
    w.r.t. perturbations of pose_a and pose_b (reference warping.h:105-137).

    Returns (pose_ab, jac_a [..., 6, 6], jac_b [..., 6, 6])."""
    pose_ab = relative_pose(pose_a, pose_b)
    rot_a_T = quat_to_matrix(pose_a.q).transpose(-1, -2)
    d = pose_a.t - pose_b.t
    z = torch.zeros_like(rot_a_T)
    ja_tw = -hat(torch.einsum("...ij,...j->...i", rot_a_T, d)) @ rot_a_T
    jac_a = torch.cat([
        torch.cat([-rot_a_T, ja_tw], dim=-1),
        torch.cat([z, -rot_a_T], dim=-1),
    ], dim=-2)
    jac_b = torch.cat([
        torch.cat([rot_a_T, z], dim=-1),
        torch.cat([z, rot_a_T], dim=-1),
    ], dim=-2)
    return pose_ab, jac_a, jac_b


def pose_distance(pose_a: SE3, pose_b: SE3, trs_wgt=8.0, rot_wgt=3.0) -> Tensor:
    """Weighted translation+rotation distance, roll ignored
    (reference warping.h:139-147)."""
    rel = relative_pose(pose_a, pose_b)
    w = so3_log(rel.q)
    drot = torch.linalg.norm(w[..., :2], dim=-1)
    dtrs = torch.linalg.norm(rel.t, dim=-1)
    return dtrs * trs_wgt + drot * rot_wgt


def transform_jacobian_pose(pt: Tensor, pose: SE3) -> Tensor:
    """d(R x + t)/d(t, w) = [I | -(Rx)^], shape [..., 3, 6]
    (reference warping.h:156-164)."""
    Rx = quat_rotate(pose.q, pt)
    eye = torch.eye(3, dtype=pt.dtype, device=pt.device).expand(
        Rx.shape[:-1] + (3, 3))
    return torch.cat([eye, -hat(Rx)], dim=-1)


def transform_jacobian_point(pose: SE3) -> Tensor:
    """d(R x + t)/dx = R (reference warping.h:172-177)."""
    return quat_to_matrix(pose.q)


def stack(poses) -> SE3:
    """Stack a list of SE3 into a batched SE3."""
    return SE3(torch.stack([p.q for p in poses], dim=0),
               torch.stack([p.t for p in poses], dim=0))


def index(pose: SE3, i) -> SE3:
    return SE3(pose.q[i], pose.t[i])
