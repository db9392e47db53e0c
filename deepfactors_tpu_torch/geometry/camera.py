"""Pinhole camera model with analytic Jacobians.

PyTorch port of ``deepfactors_tpu/geometry/camera.py`` (reference
sources/common/algorithm/pinhole_camera.h and pinhole_camera_impl.h). A
camera is a NamedTuple of host Python floats: intrinsics enter device
arithmetic as scalars, never as tensors that would have to live on a device.

Pixel convention matches the reference: pix = (x, y), x in [0, W), image
storage [H, W] (row y, column x). ``reproject`` treats integer pixel
coordinates directly (no half-pixel offset).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

Tensor = torch.Tensor


class PinholeCamera(NamedTuple):
    fx: float
    fy: float
    u0: float
    v0: float
    width: float
    height: float

    @classmethod
    def create(cls, fx, fy, u0, v0, width, height):
        return cls(float(fx), float(fy), float(u0), float(v0), float(width),
                   float(height))

    def matrix(self, device="cuda") -> Tensor:
        return torch.tensor([[self.fx, 0.0, self.u0], [0.0, self.fy, self.v0],
                             [0.0, 0.0, 1.0]], dtype=torch.float32,
                            device=device)

    def level(self, lvl: int) -> "PinholeCamera":
        """Camera for pyramid level ``lvl`` (level 0 = finest): integer-halve
        the viewport and rescale intrinsics by the actual ratio
        (camera_pyramid.h:35-48, ResizeViewport semantics)."""
        cam = self
        for _ in range(lvl):
            new_w = float(math.floor(cam.width / 2))
            new_h = float(math.floor(cam.height / 2))
            xr = new_w / cam.width
            yr = new_h / cam.height
            cam = PinholeCamera(cam.fx * xr, cam.fy * yr, cam.u0 * xr,
                                cam.v0 * yr, new_w, new_h)
        return cam


def project(cam: PinholeCamera, point: Tensor) -> Tensor:
    """Point [..., 3] -> pixel [..., 2] (pinhole_camera_impl.h:41-45)."""
    z = point[..., 2]
    return torch.stack([cam.fx * point[..., 0] / z + cam.u0,
                        cam.fy * point[..., 1] / z + cam.v0], dim=-1)


def reproject(cam: PinholeCamera, pixel: Tensor, depth: Tensor) -> Tensor:
    """Pixel [..., 2], depth [...] -> point [..., 3]
    (pinhole_camera_impl.h:52-56)."""
    x = (pixel[..., 0] - cam.u0) / cam.fx
    y = (pixel[..., 1] - cam.v0) / cam.fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1) * depth[..., None]


def project_point_jacobian(cam: PinholeCamera, point: Tensor) -> Tensor:
    """d project / d point: [..., 2, 3] (pinhole_camera_impl.h:91-97)."""
    x, y, z = point[..., 0], point[..., 1], point[..., 2]
    zero = torch.zeros_like(z)
    row0 = torch.stack([cam.fx / z, zero, -(cam.fx * x) / (z * z)], dim=-1)
    row1 = torch.stack([zero, cam.fy / z, -(cam.fy * y) / (z * z)], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def reproject_depth_jacobian(cam: PinholeCamera, pixel: Tensor,
                             depth: Tensor) -> Tensor:
    """d reproject / d depth: [..., 3] (pinhole_camera_impl.h:77-84)."""
    x = (pixel[..., 0] - cam.u0) / cam.fx
    y = (pixel[..., 1] - cam.v0) / cam.fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def reproject_pixel_jacobian(cam: PinholeCamera, pixel: Tensor,
                             depth: Tensor) -> Tensor:
    """d reproject / d pixel: [..., 3, 2] (pinhole_camera_impl.h:63-70)."""
    z = torch.zeros_like(depth)
    col0 = torch.stack([depth / cam.fx, z, z], dim=-1)
    col1 = torch.stack([z, depth / cam.fy, z], dim=-1)
    return torch.stack([col0, col1], dim=-1)


def pixel_valid(cam: PinholeCamera, pixel: Tensor, border=0) -> Tensor:
    """Boolean mask [...] (pinhole_camera_impl.h:105-108)."""
    x, y = pixel[..., 0], pixel[..., 1]
    b = float(border)
    return (x >= b) & (x < cam.width - b) & (y >= b) & (y < cam.height - b)


def resize(cam: PinholeCamera, new_width, new_height) -> PinholeCamera:
    """ResizeViewport semantics (pinhole_camera_impl.h:126-136)."""
    xr = new_width / cam.width
    yr = new_height / cam.height
    return PinholeCamera(cam.fx * xr, cam.fy * yr, cam.u0 * xr, cam.v0 * yr,
                         float(new_width), float(new_height))


def camera_pyramid(cam: PinholeCamera, levels: int):
    """List of per-level cameras, finest first (camera_pyramid.h:35-48)."""
    return [cam.level(i) for i in range(levels)]
