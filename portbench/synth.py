"""The benchmark's own inputs: procedural rooms, the orbit, the renderer and
the image filters, frozen.

Copied from the port as it stood when the benchmark was written, so that a
later change to the port's originals cannot move the yardstick:

- ``random_room``, ``orbit_trajectory``, ``render``, ``render_aa`` and the
  texture: ``deepfactors_tpu_torch/io/synth.py``;
- ``sobel_gradients``, ``gaussian_blur_down`` and the clamped filter:
  ``deepfactors_tpu_torch/ops/image.py``;
- the quaternion of yaw and pitch and ``quat_to_matrix``:
  ``deepfactors_tpu_torch/io/synth.py`` and ``geometry/se3.py``.

One change: ``random_room`` seeds numpy's ``RandomState`` with
``seed32(seed)``, so any whole number (the benchmark's seeds pass 2**32)
names a room. Poses are camera-to-world (q wxyz, t) pairs of numpy arrays.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor
_NTEX = 12  # texture params per surface


class Camera(NamedTuple):
    fx: float
    fy: float
    u0: float
    v0: float
    width: float
    height: float


def seed32(seed: int) -> int:
    """A 32-bit seed for numpy's ``RandomState`` from any whole number."""
    return int(np.random.SeedSequence(int(seed)).generate_state(1)[0])


def resize(cam: Camera, width, height) -> Camera:
    xr, yr = width / cam.width, height / cam.height
    return Camera(cam.fx * xr, cam.fy * yr, cam.u0 * xr, cam.v0 * yr,
                  float(width), float(height))


class RoomScene(NamedTuple):
    room_min: np.ndarray   # [3]
    room_max: np.ndarray   # [3]
    box_min: np.ndarray    # [B, 3]
    box_max: np.ndarray    # [B, 3]
    tex: np.ndarray        # [6 + 6B, _NTEX]


def random_room(seed: int = 0, n_boxes: int = 3, freq_scale: float = 1.0,
                size_scale: float = 1.0) -> RoomScene:
    """A room: 4-7 m footprint, 2.5-3 m height, ``n_boxes`` boxes on the
    floor, random texture parameters per surface."""
    rng = np.random.RandomState(seed32(seed))
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


def quat_to_matrix(q: Tensor) -> Tensor:
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
    ], dim=-2)


def _texture(u: Tensor, v: Tensor, p: Tensor) -> Tensor:
    val = (0.45
           + 0.20 * torch.sin(p[0] * u + p[1]) * torch.cos(p[2] * v + p[3])
           + 0.15 * torch.sin(p[4] * u + p[5] * v + p[6])
           + 0.10 * torch.cos(p[7] * u - p[8] * v + p[9])
           + 0.07 * torch.sin(p[10] * (u + 0.7 * v) + p[11]))
    return torch.clamp(val, 0.03, 0.97)


def _signed_safe(d: Tensor) -> Tensor:
    return torch.where(d >= 0, torch.clamp(d, min=1e-9),
                       torch.clamp(d, max=-1e-9))


_INPLANE = np.array([[1, 2], [1, 2], [0, 2], [0, 2], [0, 1], [0, 1]])


def render(scene: RoomScene, cam: Camera, q, t, height: int, width: int,
           device="cuda"):
    """(image [H, W] in [0, 1], z-depth [H, W]) of the scene seen from the
    camera-to-world pose (q [4], t [3]), ray-cast on ``device``; a batch of
    poses (q [N, 4], t [N, 3]) gives [N, H, W] each."""
    dev = torch.device(device)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev), indexing="ij")
    dirs = torch.stack([(xs - cam.u0) / cam.fx, (ys - cam.v0) / cam.fy,
                        torch.ones_like(xs)], dim=-1).reshape(-1, 3)
    R = quat_to_matrix(f(q))
    d = dirs @ R.mT                                   # [..., HW, 3]
    o = f(t)[..., None, :].expand(d.shape)
    safe = _signed_safe(d)

    pos = d >= 0
    t_ax = (torch.where(pos, f(scene.room_max), f(scene.room_min)) - o) / safe
    t_room, axis = torch.min(t_ax, dim=-1)
    face_room = (axis * 2
                 + torch.gather(pos, -1, axis[..., None])[..., 0].long())
    ts, faces = [t_room], [face_room]
    for b in range(scene.box_min.shape[0]):
        t1 = (f(scene.box_min[b]) - o) / safe
        t2 = (f(scene.box_max[b]) - o) / safe
        t_near, ax = torch.max(torch.minimum(t1, t2), dim=-1)
        t_far = torch.min(torch.maximum(t1, t2), dim=-1).values
        hit = (t_near < t_far) & (t_near > 1e-4)
        side = torch.gather(d, -1, ax[..., None])[..., 0] < 0
        ts.append(torch.where(hit, t_near,
                              torch.full_like(t_near, float("inf"))))
        faces.append(6 + 6 * b + ax * 2 + side.long())
    ts, faces = torch.stack(ts), torch.stack(faces)
    win = torch.argmin(ts, dim=0)
    tt = torch.gather(ts, 0, win[None])[0]
    face = torch.gather(faces, 0, win[None])[0]
    p = o + tt[..., None] * d
    local = torch.as_tensor(_INPLANE, device=dev)[face % 6]
    u = torch.gather(p, -1, local[..., :1])[..., 0]
    v = torch.gather(p, -1, local[..., 1:])[..., 0]
    params = f(scene.tex)[face].movedim(-1, 0)
    img = _texture(u, v, params)
    lead = tt.shape[:-1]
    return img.reshape(*lead, height, width), tt.reshape(*lead, height, width)


def render_aa(scene: RoomScene, cam: Camera, q, t, height: int, width: int,
              ss: int = 2, device="cuda"):
    """Anti-aliased render: the image supersampled ``ss`` x, then blurred
    down; the depth ray-cast at the target size."""
    big = resize(cam, width * ss, height * ss)
    img, _ = render(scene, big, q, t, height * ss, width * ss, device)
    for _ in range(int(np.log2(ss))):
        img = gaussian_blur_down(img)
    _, dpt = render(scene, cam, q, t, height, width, device)
    return img, dpt


def yaw_pitch_quat(yaw: float, pitch: float) -> np.ndarray:
    """wxyz quaternion of R = R_y(yaw) R_x(pitch)."""
    cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
    cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
    return np.array([cy * cp, cy * sp, sy * cp, -sy * sp], np.float32)


def orbit_trajectory(n_frames: int, radius: float = 0.8,
                     sweep: float = 2.6 * np.pi, y_bob: float = 0.08,
                     pitch_amp: float = 0.06):
    """In-room orbit of ``sweep`` radians, looking outward, with vertical bob
    and pitch wobble: (q [n, 4], t [n, 3]) camera-to-world, numpy."""
    qs, ts = [], []
    for i in range(n_frames):
        s = i / max(1, n_frames - 1)
        th = sweep * s
        pos = np.array([radius * np.cos(th), y_bob * np.sin(4.0 * np.pi * s),
                        radius * np.sin(th)], np.float32)
        yaw = np.arctan2(pos[0], pos[2])
        pitch = pitch_amp * np.sin(3.0 * np.pi * s)
        qs.append(yaw_pitch_quat(yaw, pitch))
        ts.append(pos)
    return np.stack(qs), np.stack(ts)


_SOBEL_X = np.array([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]],
                    dtype=np.float32)
_SOBEL_Y = np.array([[-1.0, -2.0, -1.0], [0.0, 0.0, 0.0], [1.0, 2.0, 1.0]],
                    dtype=np.float32)


def _pad_edge(img: Tensor, ph: int, pw: int) -> Tensor:
    lead = img.shape[:-2]
    x = img.reshape((-1, 1) + img.shape[-2:])
    x = F.pad(x, (pw, pw, ph, ph), mode="replicate")
    return x.reshape(lead + x.shape[-2:])


def conv2d_clamped(img: Tensor, kernel: np.ndarray) -> Tensor:
    """2D correlation of [..., H, W] with edge-replicated borders, as a
    shift-multiply-add over the static taps."""
    kh, kw = kernel.shape
    H, W = img.shape[-2], img.shape[-1]
    padded = _pad_edge(img, kh // 2, kw // 2)
    out = torch.zeros_like(img)
    for i in range(kh):
        for j in range(kw):
            if kernel[i, j] != 0.0:
                out = out + float(kernel[i, j]) * padded[..., i:i + H, j:j + W]
    return out


def sobel_gradients(img: Tensor) -> Tensor:
    """[..., H, W] -> [..., H, W, 2] (dx, dy), divided by 8."""
    gx = conv2d_clamped(img, _SOBEL_X) / 8.0
    gy = conv2d_clamped(img, _SOBEL_Y) / 8.0
    return torch.stack([gx, gy], dim=-1)


def gaussian_blur_down(img: Tensor) -> Tensor:
    """[..., H, W] -> [..., H//2, W//2]: 5x5 binomial blur at even pixels
    with clamped taps, /256."""
    Ho, Wo = img.shape[-2] // 2, img.shape[-1] // 2
    padded = _pad_edge(img, 2, 2)
    w = (1.0, 4.0, 6.0, 4.0, 1.0)
    rows = torch.zeros(img.shape[:-2] + (Ho, padded.shape[-1]),
                       dtype=img.dtype, device=img.device)
    for i, wi in enumerate(w):
        rows = rows + wi * padded[..., i:i + 2 * Ho:2, :]
    out = torch.zeros(img.shape[:-2] + (Ho, Wo), dtype=img.dtype,
                      device=img.device)
    for j, wj in enumerate(w):
        out = out + wj * rows[..., :, j:j + 2 * Wo:2]
    return out / 256.0
