"""One BA step at production shapes, on one card or over the ranks of a
world: the counterpart of ``__graft_entry__.dryrun_multichip(n)`` and
``dryrun_matrix(ns)``.

The problem is fixed and seeded with numpy exactly as there (K = 8
keyframes, CS = 32, 192x256, 16 factors k -> k+1 around the ring, identity
poses, zero codes), so the result can be held against the JAX package's;
a world of n ranks shards its factors n ways and sums the system over the
group, so every world reaches the result of one process but for the order
of the sums.

A rank of ``dryrun_matrix``'s worlds (what ``multihost.World`` starts):

    python -m deepfactors_tpu_torch.parallel.dryrun --out DIR \
        [--device cuda|cpu] [--backend nccl|gloo] \
        --coord file:///tmp/x/rendezvous --nproc N --proc-id R
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from ..geometry.camera import PinholeCamera
from ..ops import dense_sfm as ds
from ..ops import kernels
from . import dist_ba, multihost

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


def dryrun_multichip(world: int = 1, rank: int = 0, group=None,
                     device="cuda"):
    """Run ONE photometric-BA step (unfused linearisation of this rank's
    shard of the 16 factors, ``dist_ba.shard_factors(fd, world, rank)``,
    the system summed over ``group``, Schur solve, retract) and return
    (q [K, 4], t [K, 3], codes [K, CS]) as host arrays, the same on every
    rank; raises if a result is not finite."""
    cam, params, fd, q, t, c, active = dryrun_problem(device)
    fd = dist_ba.shard_factors(fd, world, rank)
    step = dist_ba.make_ba_step(K, CS, cam, params, group=group)
    q, t, c, _ = step(q, t, c, fd, active)
    out = tuple(x.cpu().numpy() for x in (q, t, c))
    if not all(np.isfinite(x).all() for x in out):
        raise FloatingPointError("the dry-run step gave a non-finite result")
    return out


def dryrun_single(device="cuda"):
    """The step in one process on one device: ``dryrun_multichip(1, 0)``."""
    return dryrun_multichip(1, 0, None, device)


def dryrun_matrix(ns=(1, 2, 4), tol: float = 1e-4, backend=None,
                  device="cuda", timeout_s: float = 600.0):
    """The same step in a world of every size in ``ns``, all worlds started
    at once (``multihost.World``, one process a rank; ``backend`` as
    ``multihost.initialize`` takes it). Asserts that the ranks of a world
    agree bit for bit, and that every world is within ``tol`` of the first
    (the order of the sums is the only difference). Returns the deviation
    of each world from the first, and each world's (q, t, codes) with the
    kernel launches of each of its ranks (``kernels.launch_counts()``)."""
    argv = [sys.executable, "-m", "deepfactors_tpu_torch.parallel.dryrun",
            "--device", str(device)]
    if backend:
        argv += ["--backend", backend]
    with tempfile.TemporaryDirectory(prefix="df_dryrun_") as tmp:
        worlds = {}
        try:
            for n in ns:
                worlds[n] = multihost.World(
                    argv + ["--out", os.path.join(tmp, f"world{n}")], n)
            ranks = {n: w.wait(timeout_s) for n, w in worlds.items()}
        finally:
            for w in worlds.values():
                w.close()
        results = {}
        for n, outs in ranks.items():
            for r, (rc, out) in enumerate(outs):
                if rc != 0:
                    raise RuntimeError(f"world {n}, rank {r} exited {rc}:\n"
                                       + out)
            got = [np.load(os.path.join(tmp, f"world{n}.rank{r}.npz"))
                   for r in range(n)]
            for g in got[1:]:
                for k in ("q", "t", "c"):
                    assert np.array_equal(g[k], got[0][k]), (
                        f"world {n}: the ranks disagree on {k}")
            results[n] = dict(q=got[0]["q"], t=got[0]["t"], c=got[0]["c"],
                              launches=[_launches(g) for g in got])
    ref = results[ns[0]]
    devs = {}
    for n in ns:
        devs[n] = max(float(np.abs(results[n][k] - ref[k]).max())
                      for k in ("q", "t", "c"))
        assert devs[n] <= tol, f"world {n} deviates {devs[n]} (> {tol})"
    return devs, results


_LAUNCHES = "launches."


def _launches(npz) -> dict:
    return {k[len(_LAUNCHES):]: int(npz[k]) for k in npz.files
            if k.startswith(_LAUNCHES)}


def _rank_main(argv=None):
    ap = argparse.ArgumentParser(prog="dryrun")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--coord", required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--proc-id", type=int, required=True)
    args = ap.parse_args(argv)
    multihost.initialize(args.coord, args.nproc, args.proc_id,
                         backend=args.backend, device=args.device)
    try:
        kernels.reset_launch_counts()
        q, t, c = dryrun_multichip(args.nproc, args.proc_id,
                                   multihost.global_group(),
                                   multihost.local_device())
        np.savez(f"{args.out}.rank{args.proc_id}.npz", q=q, t=t, c=c,
                 **{_LAUNCHES + k: v
                    for k, v in kernels.launch_counts().items()})
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    _rank_main()
