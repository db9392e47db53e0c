"""One BA step at production shapes on one card: the counterpart of
``__graft_entry__.dryrun_multichip(1)``.

The problem is fixed and seeded with numpy exactly as there (K = 8
keyframes, CS = 32, 192x256, 16 factors k -> k+1 around the ring, identity
poses, zero codes), so the result can be held against the JAX package's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..geometry.camera import PinholeCamera
from ..ops import dense_sfm as ds
from . import dist_ba

K, CS, H, W, P = 8, 32, 192, 256, 16


def dryrun_problem(device="cuda"):
    """(cam, params, fd, pose_q, pose_t, codes, active_kf) of the fixed
    16-factor problem, on ``device``."""
    cam = PinholeCamera.create(fx=220.0, fy=220.0, u0=W / 2, v0=H / 2,
                               width=W, height=H)
    params = ds.SfmParams(huber_delta=0.3, avg_dpt=2.0, min_dpt=0.0,
                          valid_border=1)
    rng = np.random.RandomState(0)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    imgs = np.stack(
        [0.5 + 0.3 * np.sin(xs / 3 + k) * np.cos(ys / 4 + k) for k in range(K)]
    ).astype(np.float32)
    src = np.arange(P, dtype=np.int64) % K
    dst = (src + 1) % K
    jac0 = 0.01 * rng.standard_normal((P, H, W, CS)).astype(np.float32)
    grad1 = 0.1 * rng.standard_normal((P, H, W, 2)).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=device)
    fd = dist_ba.ShardedFactorData(
        src=t(src), dst=t(dst),
        active=torch.ones(P, dtype=torch.bool, device=device),
        img0=t(imgs[src]), img1=t(imgs[dst]),
        prx0=torch.full((P, H, W), 0.5, device=device), jac0=t(jac0),
        std0=torch.zeros((P, H, W), device=device), grad1=t(grad1))
    pose_q = torch.tensor([1.0, 0, 0, 0], device=device).repeat(K, 1)
    pose_t = torch.zeros((K, 3), device=device)
    codes = torch.zeros((K, CS), device=device)
    active = torch.ones(K, dtype=torch.bool, device=device)
    return cam, params, fd, pose_q, pose_t, codes, active


def dryrun_single(device="cuda"):
    """Run ONE photometric-BA step (unfused linearisation of the 16 factors,
    Schur solve, retract) and return (q [K, 4], t [K, 3], codes [K, CS]) as
    host arrays; raises if a result is not finite."""
    cam, params, fd, q, t, c, active = dryrun_problem(device)
    step = dist_ba.make_ba_step(K, CS, cam, params)
    q, t, c, _ = step(q, t, c, fd, active)
    out = tuple(x.cpu().numpy() for x in (q, t, c))
    if not all(np.isfinite(x).all() for x in out):
        raise FloatingPointError("the dry-run step gave a non-finite result")
    return out
