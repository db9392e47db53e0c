"""profile_dispatch: the fixed cost of a mapper run against its marginal
cost per GN iteration, at the bench problem size.

PyTorch port of the JAX package's ``tools/profile_dispatch.py``. The JAX
mapper runs N iterations in one ``jit`` (one dispatch and a fixed cost);
the port's ``Mapper._run`` uploads the compacted pool and runs N eager
``gn_iteration`` calls, each read back for the convergence test, so its
"fixed" cost is the pool upload and its marginal cost the launches of one
iteration. Modes:
  - ``main`` (default, ``probe_main``): ``_run`` over n = 2, 2, 20, 100,
    100, 200 iterations (host ms, µs per iteration), the device's share of
    one iteration (the profiler's kernel µs and kernel count, on the card),
    then n = 100 with the pool already on the device (``gn_iteration``
    called directly);
  - ``fixed``: one small op on a big (a jac pool's size) and on a small
    tensor, per dispatch;
  - ``n0``: ``_run`` with zero to four iterations (what lies outside the
    iteration body).

Usage: python -m deepfactors_tpu_torch.tools.profile_dispatch
       [main|fixed|n0] [--device cpu]
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..config import parse_args
from ..geometry import se3 as se3m
from ..mapping.mapper import Mapper, MapperConfig
from .bench_config import CS, H, W, bench_camera
from .common import device_from_flag, kernel_time, sync

L = 3
N_KF = 5


def _bench_mapper(dev):
    """The bench-size Mapper (5 keyframes of synthetic texture in a chain,
    every work at level 0, no decoder) and its compacted factor pool."""
    cam = bench_camera()
    cfg = MapperConfig(
        max_keyframes=N_KF, max_frames=1, max_factors=16, code_size=CS,
        height=H, width=W, pyramid_levels=L, pho_iters=(4, 8, 15),
        connection_mode="LASTN", max_back_connections=2, use_schur=True,
        relin_threshold=0.0)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)

    def synth(k):
        return (0.5 + 0.3 * np.sin(xs / 7 + k) * np.cos(ys / 5 + 0.3 * k)
                + 0.1 * np.sin((xs + 2 * ys) / 11 + k)).astype(np.float32)

    m = Mapper(cfg, cam, decoder=None, device=dev)
    m.add_keyframe_to_map(synth(0), se3m.identity(device=dev))
    for k in range(1, N_KF):
        m.add_keyframe_to_map(synth(k), se3m.identity(device=dev))
        m._add_photo_pair(m.kf_slots[-2], m.kf_slots[-1])
    for w in m.work.work:
        w.active_level = 0
    m._bookkeeping()
    return m, m._compact_pool()


def _timed_run(m, pool, n, dev):
    sync(dev)
    t0 = time.perf_counter()
    m._run(pool, (0,), n, False)
    sync(dev)
    return time.perf_counter() - t0


def probe_main(dev, log=print) -> dict:
    """Fixed against marginal cost (the JAX tool's ``main``)."""
    m, pool = _bench_mapper(dev)
    log(f"P={int(pool.active.sum())} slots={len(pool.active)} on "
        f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}")
    m._run(pool, (0,), 2, False)
    ns, ts = [], []
    for n in (2, 2, 20, 100, 100, 200):
        dt = _timed_run(m, pool, n, dev)
        ns.append(n)
        ts.append(dt)
        log(f"n={n:4d}: total {dt * 1e3:8.2f} ms  ({dt / n * 1e6:7.1f} "
            f"us/iter)")
    kus = nk = None
    if dev.type == "cuda":
        kus, nk = kernel_time(lambda: m._run(pool, (0,), 1, False))
        log(f"one iteration on the device: {kus:.1f} us in {nk} kernels")

    # the pool on the device already: gn_iteration with prebuilt tensors
    t = lambda a, dt=torch.long: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(a), device=dev).to(dt)
    args = (t(pool.src), t(pool.dst), t(pool.dst_is_frame, torch.bool),
            t(pool.level), t(pool.active, torch.bool), (0,), False)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(100):
        float(m.gn_iteration(*args))
    sync(dev)
    pre = time.perf_counter() - t0
    log(f"prebuilt args n=100: {pre * 1e3:8.2f} ms")
    return dict(n=ns, seconds=ts, kernel_us=kus, kernels=nk,
                prebuilt_100_ms=pre * 1e3)


def probe_fixed(dev, log=print) -> dict:
    """What one dispatch costs with a big and with a small argument."""
    g = torch.Generator(device=dev).manual_seed(0)
    big = torch.randn((5, 32, 192, 256), generator=g, device=dev)  # a jac pool
    small = torch.ones((8, 8), device=dev)
    out = {}
    for name, fn, arg in (("big-arg op", lambda x: x[0, 0, 0, :2].sum(), big),
                          ("small-arg op", lambda x: x.sum(), small)):
        float(fn(arg))
        t0 = time.perf_counter()
        for _ in range(5):
            float(fn(arg))
        out[name] = (time.perf_counter() - t0) / 5 * 1e3
        log(f"{name}: {out[name]:7.3f} ms/dispatch")
    return out


def probe_n0(dev, log=print) -> dict:
    """A mapper run with zero iterations: everything outside the body."""
    m, pool = _bench_mapper(dev)
    m._run(pool, (0,), 0, False)
    out = {}
    for n in (0, 0, 1, 1, 2, 4):
        dt = _timed_run(m, pool, n, dev)
        out.setdefault(n, []).append(dt * 1e3)
        log(f"n={n}: {dt * 1e3:8.2f} ms")
    return out


def main(argv, log=print) -> dict:
    """Run the mode of ``argv`` (main, fixed or n0); returns its readings."""
    flags = parse_args(list(argv))
    mode = (flags["__positional__"] or ["main"])[0]
    probe = {"main": probe_main, "fixed": probe_fixed, "n0": probe_n0}[mode]
    return probe(device_from_flag(flags.get("device", "cuda")), log=log)


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
