"""Pose interpolation and critically-damped springs (common/interp.h:24-78).

PyTorch port of ``deepfactors_tpu/utils/interp.py``: used by a viewer's
smooth camera follow (the reference GUI eases its view toward the live
camera with these). Poses hold tensors or numpy arrays; results are
tensors on the input's device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..geometry.se3 import SE3


def _t(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


def lerp(a, b, t: float):
    return a + (b - a) * t


def slerp(q0, q1, t: float) -> torch.Tensor:
    """Quaternion slerp (wxyz), shortest arc; nlerp near parallel."""
    q0, q1 = _t(q0), _t(q1)
    d = torch.sum(q0 * q1)
    q1 = torch.where(d < 0, -q1, q1)
    d = torch.abs(d)
    theta = torch.arccos(torch.clamp(d, -1.0, 1.0))
    s = torch.sin(theta)
    safe = torch.where(s > 1e-6, s, torch.ones_like(s))
    w0 = torch.where(s > 1e-6, torch.sin((1 - t) * theta) / safe,
                     torch.full_like(s, 1 - t))
    w1 = torch.where(s > 1e-6, torch.sin(t * theta) / safe,
                     torch.full_like(s, t))
    q = w0 * q0 + w1 * q1
    return q / torch.linalg.norm(q)


def interpolate_pose(p0: SE3, p1: SE3, t: float) -> SE3:
    """SE3 interpolation: slerp rotation + lerp translation
    (interp.h Interpolate)."""
    return SE3(slerp(p0.q, p1.q, t), lerp(_t(p0.t), _t(p1.t), t))


class DampedSpring:
    """Critically-damped spring toward a moving target pose
    (interp.h:24-78). step(target, dt) eases the state toward target."""

    def __init__(self, pose: SE3, smoothness: float = 0.5):
        self.pose = pose
        self.smoothness = smoothness

    def step(self, target: SE3, dt: float) -> SE3:
        alpha = 1.0 - float(np.exp(-dt / max(self.smoothness, 1e-6)))
        self.pose = interpolate_pose(self.pose, target, alpha)
        return self.pose
