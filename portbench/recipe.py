"""The training recipe's inputs, frozen: its rendered dataset, its batch
sampling and its photometric augmentation.

Copied from ``deepfactors_tpu_torch/train_room_decoder.py``
(``build_dataset``, ``AUG``, ``apply_augment``, ``make_augment``) as it
stood when the benchmark was written, so that a later change there cannot
move the yardstick. Changes from the original:

- the room and pose draws are seeded from any whole number through
  ``synth.seed32`` (the recipe seeds 0);
- a batch is the next ``batch`` rows of a permutation of the dataset drawn
  on the device, a new permutation once the rows run out (the recipe draws
  each batch's rows with replacement): so the rows of a batch all differ,
  which the check of the first steps needs, and the work per step is the
  same.
"""
from __future__ import annotations

import numpy as np
import torch

from . import synth

CHUNK = 8
BLUR_K3 = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], np.float32) / 16.0
AUG = {"strong": dict(gamma=(0.6, 1.7), gain=(0.7, 1.25), bias=0.12,
                      ramp=0.25, vig=0.35, noise=0.03, blur_p=0.3),
       "mild": dict(gamma=(0.75, 1.4), gain=(0.8, 1.2), bias=0.08,
                    ramp=0.15, vig=0.25, noise=0.02, blur_p=0.2)}


def build_dataset(rooms, poses_per_room, height, width, cam, seed=0,
                  n_boxes=3, randomize=False, scale_range=(0.75, 2.2),
                  device="cuda"):
    """[rooms * poses_per_room, H, W] images and z-depths rendered on
    ``device`` (plain renders, 8 poses a call). ``randomize``: per room
    0-5 boxes, texture frequency scale 0.7-1.3, room size scale from
    ``scale_range``, camera radius 1.5 x the size scale, roll up to 0.25
    rad."""
    s32 = synth.seed32(seed)
    rng = np.random.RandomState(s32)

    def random_poses(n, r_max=1.2, roll_amp=0.0):
        qs, ts = [], []
        for _ in range(n):
            r = rng.uniform(0.0, r_max)
            th = rng.uniform(0, 2 * np.pi)
            ts.append([r * np.cos(th), rng.uniform(-0.25, 0.25),
                       r * np.sin(th)])
            q = synth.yaw_pitch_quat(rng.uniform(0, 2 * np.pi),
                                     rng.uniform(-0.25, 0.25))
            if roll_amp > 0.0:
                half = 0.5 * rng.uniform(-roll_amp, roll_amp)
                cr, sr = np.cos(half), np.sin(half)
                w, x, y, z = q
                q = np.array([w * cr - z * sr, x * cr - y * sr,
                              y * cr + x * sr, z * cr + w * sr], q.dtype)
            qs.append(q)
        return np.stack(qs), np.asarray(ts, np.float32)

    n = rooms * poses_per_room
    imgs = torch.empty((n, height, width), device=device)
    dpts = torch.empty((n, height, width), device=device)
    at = 0
    for r in range(rooms):
        room_seed = (s32 * 7919 + r) % 2 ** 32
        if randomize:
            nb = int(rng.randint(0, 6))
            fs = float(rng.uniform(0.7, 1.3))
            ss = float(rng.uniform(*scale_range))
            sc = synth.random_room(room_seed, nb, freq_scale=fs,
                                   size_scale=ss)
            q, t = random_poses(poses_per_room, r_max=1.5 * ss,
                                roll_amp=0.25)
        else:
            sc = synth.random_room(room_seed, n_boxes)
            q, t = random_poses(poses_per_room)
        for c in range(0, poses_per_room, CHUNK):
            im, dp = synth.render(sc, cam, q[c:c + CHUNK], t[c:c + CHUNK],
                                  height, width, device=device)
            imgs[at:at + len(im)] = im
            dpts[at:at + len(im)] = dp
            at += len(im)
    return imgs, dpts


def apply_augment(imgs, vals, noise, blur_on):
    """Photometric randomisation of [B, H, W] images in [0, 1] with given
    draws: ``vals`` [B, 7] (gamma, gain, bias, x ramp, y ramp, vignette,
    noise amplitude), ``noise`` [B, H, W] unit normals, ``blur_on`` [B]."""
    Hh, Ww = imgs.shape[-2:]
    gy, gx = np.mgrid[0:Hh, 0:Ww]
    ys = torch.as_tensor((gy / (Hh - 1) - 0.5) * 2, dtype=torch.float32,
                         device=imgs.device)
    xs = torch.as_tensor((gx / (Ww - 1) - 0.5) * 2, dtype=torch.float32,
                         device=imgs.device)
    r2 = xs ** 2 + ys ** 2
    v = [vals[:, i, None, None] for i in range(7)]
    img = imgs.clamp(1e-3, 1.0) ** v[0]
    ramp = v[3] * xs + v[4] * ys
    vig = 1.0 - v[5] * r2
    img = (img * v[1] + v[2] + ramp) * vig
    img = img + v[6] * noise
    blur = synth.conv2d_clamped(img, BLUR_K3)
    img = torch.where(blur_on[:, None, None], blur, img)
    return img.clamp(0.0, 1.0)


def make_augment(strength="mild"):
    """``augment(imgs [B, H, W], generator) -> imgs``: each sample's seven
    uniforms, a noise field and the blur coin drawn from ``generator``."""
    A = AUG[strength]
    lo = [A["gamma"][0], A["gain"][0], -A["bias"], -A["ramp"], -A["ramp"],
          0.0, 0.0]
    hi = [A["gamma"][1], A["gain"][1], A["bias"], A["ramp"], A["ramp"],
          A["vig"], A["noise"]]

    def augment(imgs, generator):
        B, dev = imgs.shape[0], imgs.device
        lo_t = torch.tensor(lo, device=dev)
        hi_t = torch.tensor(hi, device=dev)
        u = torch.rand((B, 7), generator=generator, device=dev)
        noise = torch.randn(imgs.shape, generator=generator, device=dev)
        blur_on = torch.rand((B,), generator=generator,
                             device=dev) < A["blur_p"]
        return apply_augment(imgs, lo_t + u * (hi_t - lo_t), noise, blur_on)

    return augment


class EpochSampler:
    """Batches of ``batch`` rows of ``n``: consecutive slices of a
    permutation drawn on the device, a new one when fewer than ``batch``
    rows are left. Nothing is read back to the host."""

    def __init__(self, n: int, batch: int, generator: torch.Generator,
                 device):
        if batch > n:
            raise ValueError(f"a batch of {batch} from {n} rows")
        self.n, self.batch, self.gen, self.dev = n, batch, generator, device
        self.perm, self.at = None, n

    def next(self) -> torch.Tensor:
        if self.at + self.batch > self.n:
            self.perm = torch.randperm(self.n, generator=self.gen,
                                       device=self.dev)
            self.at = 0
        idx = self.perm[self.at:self.at + self.batch]
        self.at += self.batch
        return idx
