"""Several processes running one distributed BA: the PyTorch port of the
JAX package's ``tools/multihost_demo.py``.

Each rank owns a contiguous block of the photometric factors
(``parallel.multihost.host_factor_slice``), builds only its own rows of the
factor table (drawn with numpy exactly as the JAX demo's worker draws the
whole table), and runs distributed BA steps whose ``all_reduce`` of the
[D, D] system crosses the process boundary. The problem is the JAX demo's
at production size: K = 8 keyframes, CS 32, 192x256, 8 factors k -> k+1
(the JAX demo's 2 processes x 2 devices x 2 factors), identity poses and
zero codes; 3 steps.

Launcher mode (starts the ranks, checks that they agree):
  python -m deepfactors_tpu_torch.tools.multihost_demo [--nproc 2]
      [--backend nccl|gloo] [--device cuda|cpu] [--K 8 --CS 32 --H 192
      --W 256 --factors 8]

Worker mode (what the launcher runs in every rank):
  python -m deepfactors_tpu_torch.tools.multihost_demo --worker
      --coord file:///tmp/x/rendezvous --nproc 2 --proc-id {0,1} [...]

On the card the backend defaults to NCCL, which needs a card a rank:
``--backend gloo`` puts every rank on one card. ``--device`` defaults to
cuda and stops without a card.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

STEPS = 3


def factor_rows(K, CS, H, W, n_factors, rows: slice):
    """The rows ``rows`` of the demo's factor table as numpy arrays
    (``dist_ba.ShardedFactorData`` fields): the JAX demo's draws, in its
    order (the whole table is drawn, so every rank's rows are the rows of
    one table)."""
    from ..parallel.dist_ba import ShardedFactorData

    rng = np.random.RandomState(0)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    imgs = np.stack([0.5 + 0.3 * np.sin(xs / 3 + k) * np.cos(ys / 4 + k)
                     for k in range(K)]).astype(np.float32)
    src_all = np.arange(n_factors, dtype=np.int32) % K
    dst_all = (src_all + 1) % K
    jac_all = 0.01 * rng.standard_normal(
        (n_factors, H, W, CS)).astype(np.float32)
    grad_all = 0.1 * rng.standard_normal(
        (n_factors, H, W, 2)).astype(np.float32)
    n = rows.stop - rows.start
    return ShardedFactorData(
        src=src_all[rows], dst=dst_all[rows], active=np.ones((n,), bool),
        img0=imgs[src_all[rows]], img1=imgs[dst_all[rows]],
        prx0=np.full((n, H, W), 0.5, np.float32), jac0=jac_all[rows],
        std0=np.zeros((n, H, W), np.float32), grad1=grad_all[rows])


def run_steps(K, CS, H, W, n_factors, device, group=None):
    """STEPS BA steps over this process's rows (all of them without a
    group): (q [K, 4], t [K, 3], codes [K, CS], stats [2]) host arrays."""
    from ..geometry.camera import PinholeCamera
    from ..ops import dense_sfm as ds
    from ..parallel import dist_ba, multihost

    cam = PinholeCamera.create(fx=220.0, fy=220.0, u0=W / 2, v0=H / 2,
                               width=W, height=H)
    params = ds.SfmParams(huber_delta=0.3, avg_dpt=2.0, min_dpt=0.0,
                          valid_border=1)
    rows = (multihost.host_factor_slice(n_factors) if group is not None
            else slice(0, n_factors))
    fd = multihost.host_local_to_global(
        factor_rows(K, CS, H, W, n_factors, rows), device)
    step = dist_ba.make_ba_step(K, CS, cam, params, group=group)
    q = torch.tensor([1.0, 0, 0, 0], device=device).repeat(K, 1)
    t = torch.zeros((K, 3), device=device)
    c = torch.zeros((K, CS), device=device)
    active = torch.ones(K, dtype=torch.bool, device=device)
    for _ in range(STEPS):
        q, t, c, stats = step(q, t, c, fd, active)
    return tuple(x.cpu().numpy() for x in (q, t, c, stats))


def reduce_ms(K, CS, device, group, reps=20):
    """The collective of one BA step, timed: host ms of the ``all_reduce``
    of H [D, D], b [D] and the statistics [2] (D = K (6 + CS)) over
    ``group``, each call between two synchronises; (bytes reduced, median
    ms over ``reps``)."""
    import time

    import torch.distributed as dist

    D = K * (6 + CS)
    parts = [torch.ones((D, D), device=device), torch.ones(D, device=device),
             torch.ones(2, device=device)]
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    ms = []
    for _ in range(reps + 1):
        sync()
        t0 = time.perf_counter()
        for x in parts:
            dist.all_reduce(x, group=group)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    return sum(x.numel() * 4 for x in parts), float(np.median(ms[1:]))


def digest(t, stats) -> str:
    """The launcher's agreement check: sum |t| and the last step's inlier
    count, printed as the JAX demo prints them."""
    return f"DIGEST {float(np.abs(t).sum()):.8f} {float(stats[1]):.1f}"


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="multihost_demo")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--proc-id", type=int, default=0)
    ap.add_argument("--coord", default=None)
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--K", type=int, default=8)
    ap.add_argument("--CS", type=int, default=32)
    ap.add_argument("--H", type=int, default=192)
    ap.add_argument("--W", type=int, default=256)
    ap.add_argument("--factors", type=int, default=8)
    ap.add_argument("--timeout", type=float, default=600.0)
    return ap.parse_args(argv)


def worker(args, log=print) -> None:
    from ..ops import kernels
    from ..parallel import multihost

    multihost.initialize(args.coord, args.nproc, args.proc_id,
                         backend=args.backend, device=args.device)
    try:
        dev = multihost.local_device()
        kernels.reset_launch_counts()
        _, t, _, stats = run_steps(args.K, args.CS, args.H, args.W,
                                   args.factors, dev,
                                   multihost.global_group())
        launches = kernels.launch_counts()
        nbytes, ms = reduce_ms(args.K, args.CS, dev, multihost.global_group())
        log(f"proc {args.proc_id}: {dev}, pose_t[1]={t[1].round(6)} "
            f"stats={stats.round(4)}; the step's all_reduce of {nbytes} "
            f"bytes {ms:.3f} ms (host, median)")
        log(f"LAUNCHES {json.dumps(launches)}")
        log(f"REDUCE {json.dumps({'bytes': nbytes, 'ms': ms})}")
        log(digest(t, stats))
    finally:
        multihost.shutdown()


def launcher(args, argv, log=print) -> dict:
    from ..parallel import multihost

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    outs = multihost.World(
        [sys.executable, "-m", "deepfactors_tpu_torch.tools.multihost_demo",
         "--worker"] + list(argv), args.nproc).wait(args.timeout)
    digests, launches, reduce = [], [], []
    for pid, (rc, out) in enumerate(outs):
        log(f"--- proc {pid} (rc {rc}) ---")
        log(out)
        for line in out.splitlines():
            if line.startswith("DIGEST"):
                digests.append(line)
            elif line.startswith("LAUNCHES"):
                launches.append(json.loads(line.split(" ", 1)[1]))
            elif line.startswith("REDUCE"):
                reduce.append(json.loads(line.split(" ", 1)[1]))
    ok = (len(digests) == args.nproc and len(set(digests)) == 1
          and all(rc == 0 for rc, _ in outs))
    log("MULTIHOST DEMO: " + ("PASS" if ok else "FAIL"))
    return {"ok": ok, "digests": digests, "rcs": [rc for rc, _ in outs],
            "launches": launches, "reduce": reduce,
            "outputs": [o for _, o in outs]}


def main(argv=None, log=print) -> dict:
    """Launcher or worker by ``--worker``; the launcher returns the ranks'
    digests, return codes, kernel launch counts (every kernel's, per
    rank, over the BA steps), the timed all_reduce
    (``reduce_ms``) and outputs, and ``ok``."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if args.worker:
        worker(args, log)
        return {"ok": True}
    return launcher(args, [a for a in argv if a != "--worker"], log)


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
