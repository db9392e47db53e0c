"""Procedural indoor scenes: ray-cast textured rooms with ground truth.

PyTorch port of the scene, trajectory and rendering parts of
``deepfactors_tpu/io/synth.py``: boxy rooms with textured walls and
furniture-like boxes, rendered with exact z-depth at any camera pose. The
scene parameters come from a numpy ``RandomState`` seeded exactly like the
JAX package's, so ``random_room(seed)`` builds the same room in both.

Conventions: pixel (x, y); camera x right, y down, z forward; poses are
camera-to-world SE3(q wxyz, t).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import camera as cm
from ..geometry import se3 as se3m
from ..geometry.camera import PinholeCamera
from ..geometry.se3 import SE3
from ..ops import image as ipg

Tensor = torch.Tensor
_NTEX = 12  # texture params per surface


class RoomScene(NamedTuple):
    """Axis-aligned room + inner boxes with per-surface texture parameters
    (host numpy). Surfaces: room faces 0..5 (axis*2 + is_max_side), then box
    b faces 6+6b .. 6+6b+5."""

    room_min: np.ndarray   # [3]
    room_max: np.ndarray   # [3]
    box_min: np.ndarray    # [B, 3]
    box_max: np.ndarray    # [B, 3]
    tex: np.ndarray        # [6 + 6B, _NTEX]


def random_room(seed: int = 0, n_boxes: int = 3, freq_scale: float = 1.0,
                size_scale: float = 1.0) -> RoomScene:
    """Sample a room: 4-7 m footprint, 2.5-3 m height, ``n_boxes`` boxes on
    the floor, random texture parameters per surface."""
    rng = np.random.RandomState(seed)
    lx = size_scale * rng.uniform(4.0, 7.0)
    ly = size_scale * rng.uniform(2.5, 3.0)
    lz = size_scale * rng.uniform(4.0, 7.0)
    room_min = np.array([-lx / 2, -ly / 2, -lz / 2], np.float32)
    room_max = np.array([lx / 2, ly / 2, lz / 2], np.float32)
    bmin, bmax = [], []
    for _ in range(n_boxes):
        sx = rng.uniform(0.4, 1.2)
        sy = rng.uniform(0.5, 1.6)
        sz = rng.uniform(0.4, 1.2)
        clearance = 1.6 + 0.5 * max(sx, sz)
        for attempt in range(400):
            cx = rng.uniform(room_min[0] + 0.3 + sx / 2,
                             room_max[0] - 0.3 - sx / 2)
            cz = rng.uniform(room_min[2] + 0.3 + sz / 2,
                             room_max[2] - 0.3 - sz / 2)
            if np.hypot(cx, cz) > clearance:
                break
            if attempt % 50 == 49:
                clearance *= 0.85
        ymax = room_max[1]
        bmin.append([cx - sx / 2, ymax - sy, cz - sz / 2])
        bmax.append([cx + sx / 2, ymax, cz + sz / 2])
    n_surf = 6 + 6 * n_boxes
    tex = np.zeros((n_surf, _NTEX), np.float32)
    tex[:, 0] = freq_scale * rng.uniform(0.8, 2.0, n_surf)
    tex[:, 2] = freq_scale * rng.uniform(0.8, 2.0, n_surf)
    tex[:, 4] = freq_scale * rng.uniform(2.0, 5.0, n_surf)
    tex[:, 5] = freq_scale * rng.uniform(2.0, 5.0, n_surf)
    tex[:, 7] = freq_scale * rng.uniform(5.0, 9.0, n_surf)
    tex[:, 8] = freq_scale * rng.uniform(5.0, 9.0, n_surf)
    tex[:, 10] = freq_scale * rng.uniform(10.0, 16.0, n_surf)
    for c in (1, 3, 6, 9, 11):
        tex[:, c] = rng.uniform(0, 2 * np.pi, n_surf)
    return RoomScene(room_min, room_max,
                     np.asarray(bmin, np.float32).reshape(n_boxes, 3),
                     np.asarray(bmax, np.float32).reshape(n_boxes, 3), tex)


def _texture(u: Tensor, v: Tensor, p: Tensor) -> Tensor:
    val = (0.45
           + 0.20 * torch.sin(p[0] * u + p[1]) * torch.cos(p[2] * v + p[3])
           + 0.15 * torch.sin(p[4] * u + p[5] * v + p[6])
           + 0.10 * torch.cos(p[7] * u - p[8] * v + p[9])
           + 0.07 * torch.sin(p[10] * (u + 0.7 * v) + p[11]))
    return torch.clamp(val, 0.03, 0.97)


def _signed_safe(d: Tensor) -> Tensor:
    return torch.where(d >= 0, torch.clamp(d, min=1e-9), torch.clamp(d, max=-1e-9))


_INPLANE = np.array([[1, 2], [1, 2], [0, 2], [0, 2], [0, 1], [0, 1]])


def render(scene: RoomScene, cam: PinholeCamera, pose: SE3, height: int,
           width: int, device="cuda"):
    """(image [H, W] in [0, 1], z-depth [H, W]) of the scene seen from a
    camera-to-world pose, ray-cast on ``device``."""
    dev = torch.device(device)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=dev),
                            torch.arange(width, dtype=torch.float32, device=dev),
                            indexing="ij")
    dirs = torch.stack([(xs - cam.u0) / cam.fx, (ys - cam.v0) / cam.fy,
                        torch.ones_like(xs)], dim=-1).reshape(-1, 3)
    R = se3m.quat_to_matrix(f(pose.q))
    d = dirs @ R.T
    o = f(pose.t).expand(d.shape)
    safe = _signed_safe(d)

    pos = d >= 0
    t_ax = (torch.where(pos, f(scene.room_max), f(scene.room_min)) - o) / safe
    t_room, axis = torch.min(t_ax, dim=-1)
    face_room = axis * 2 + torch.gather(pos, 1, axis[:, None])[:, 0].long()
    ts, faces = [t_room], [face_room]
    for b in range(scene.box_min.shape[0]):
        t1 = (f(scene.box_min[b]) - o) / safe
        t2 = (f(scene.box_max[b]) - o) / safe
        t_near, ax = torch.max(torch.minimum(t1, t2), dim=-1)
        t_far = torch.min(torch.maximum(t1, t2), dim=-1).values
        hit = (t_near < t_far) & (t_near > 1e-4)
        side = torch.gather(d, 1, ax[:, None])[:, 0] < 0
        ts.append(torch.where(hit, t_near, torch.full_like(t_near, float("inf"))))
        faces.append(6 + 6 * b + ax * 2 + side.long())
    ts, faces = torch.stack(ts), torch.stack(faces)
    win = torch.argmin(ts, dim=0)
    t = torch.gather(ts, 0, win[None])[0]
    face = torch.gather(faces, 0, win[None])[0]
    p = o + t[:, None] * d
    local = torch.as_tensor(_INPLANE, device=dev)[face % 6]
    u = torch.gather(p, 1, local[:, :1])[:, 0]
    v = torch.gather(p, 1, local[:, 1:])[:, 0]
    params = f(scene.tex)[face].T
    img = _texture(u, v, params)
    return img.reshape(height, width), t.reshape(height, width)


def render_aa(scene: RoomScene, cam: PinholeCamera, pose: SE3, height: int,
              width: int, ss: int = 2, device="cuda"):
    """Anti-aliased render: image supersampled ``ss``x then binomial
    blur-down; depth ray-cast at the target resolution."""
    big = cm.resize(cam, width * ss, height * ss)
    img, _ = render(scene, big, pose, height * ss, width * ss, device)
    for _ in range(int(np.log2(ss))):
        img = ipg.gaussian_blur_down(img)
    _, dpt = render(scene, cam, pose, height, width, device)
    return img, dpt


def _np_yaw_pitch_quat(yaw: float, pitch: float) -> np.ndarray:
    """wxyz quaternion of R = R_y(yaw) · R_x(pitch)."""
    cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
    cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
    return np.array([cy * cp, cy * sp, sy * cp, -sy * sp], np.float32)


def orbit_trajectory(n_frames: int, radius: float = 0.8,
                     sweep: float = 2.6 * np.pi, y_bob: float = 0.08,
                     pitch_amp: float = 0.06, look: str = "outward"):
    """In-room orbit of ``sweep`` radians with vertical bob and pitch wobble.
    Returns a list of camera-to-world SE3 poses (host numpy)."""
    poses = []
    for i in range(n_frames):
        s = i / max(1, n_frames - 1)
        th = sweep * s
        pos = np.array([radius * np.cos(th), y_bob * np.sin(4.0 * np.pi * s),
                        radius * np.sin(th)], np.float32)
        if look == "outward":
            yaw = np.arctan2(pos[0], pos[2])
        else:
            yaw = np.arctan2(-pos[0], -pos[2])
        pitch = pitch_amp * np.sin(3.0 * np.pi * s)
        poses.append(SE3(_np_yaw_pitch_quat(yaw, pitch), pos))
    return poses


def render_sequence(scene: RoomScene, cam: PinholeCamera, poses, height: int,
                    width: int, with_depth: bool = False,
                    antialias: bool = True, device="cuda"):
    """Render a trajectory to host numpy images (and depths)."""
    imgs, dpts = [], []
    for p in poses:
        fn = render_aa if antialias else render
        img, dpt = fn(scene, cam, p, height, width, device=device)
        imgs.append(img.cpu().numpy())
        dpts.append(dpt.cpu().numpy())
    return (imgs, dpts) if with_depth else imgs


class OracleDecoder:
    """Ground-truth 'decoder': each frame's exact proximity pyramid with a
    zero code Jacobian, the perfect-decoder bound (the JAX package's
    ``io/synth.OracleDecoder``).

    Frames are looked up by their image content, so it drops into the
    mapper's decoder slot unchanged: ``raw_outputs_T`` gives the outputs
    the mapper reads from ``models/decoder.Decoder`` (prx0 per level, the
    feature-major code Jacobian, stdev, a zero predicted code)."""

    def __init__(self, frames, depths, levels: int, code_size: int,
                 avg_dpt: float = 2.0):
        self.levels = levels
        self.code_size = code_size
        self._lut = {}
        for img, dpt in zip(frames, depths):
            key = np.asarray(img, np.float32).tobytes()
            self._lut[key] = avg_dpt / (avg_dpt + np.asarray(dpt, np.float32))

    def raw_outputs_T(self, img: Tensor) -> dict:
        prx = self._lut[img.detach().cpu().numpy().astype(np.float32).tobytes()]
        prx_pyr = tuple(ipg.build_pyramid(torch.as_tensor(prx,
                                                          device=img.device),
                                          self.levels))
        CS = self.code_size
        return dict(
            prx0=prx_pyr,
            jac=tuple(torch.zeros((CS,) + p.shape, device=img.device)
                      for p in prx_pyr),
            stdev=tuple(torch.zeros_like(p) for p in prx_pyr),
            code_pred=torch.zeros((CS,), device=img.device))
