"""What the tools share: the device check of every entry and the stage
timer of the profiling tools.

A stage is timed three ways, since eager PyTorch has no counterpart of the
JAX tools' loop-length differencing inside one ``jit``:
  - host ms per call: ``n`` back-to-back calls ending in a synchronise, on
    the host clock (what a caller waits for);
  - event µs per call: CUDA events around the same calls. A stage of many
    small launches keeps the device waiting on the host, so this reads
    near the host time there;
  - kernel µs and kernels per call: the durations of the CUDA kernels
    ``torch.profiler`` records in one call, summed, and their count (the
    device's own work, without the gaps between launches).
On the CPU only the host clock is read.
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import torch


def device_from_flag(name: str) -> torch.device:
    """The ``--device`` of an entry; ``cuda`` without a CUDA device stops
    (no tool falls back to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return dev


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class StageTime(NamedTuple):
    host_ms: float                  # host clock per call
    event_us: Optional[float]       # CUDA events per call (None on the CPU)
    kernel_us: Optional[float]      # profiler kernel durations in one call
    kernels: Optional[int]          # CUDA kernels in one call

    def __str__(self):
        if self.event_us is None:
            return f"host {self.host_ms:9.3f} ms"
        k = ("no kernel trace" if self.kernel_us is None else
             f"{self.kernel_us:10.1f} us in {self.kernels:5d} kernels")
        return (f"host {self.host_ms:9.3f} ms  events {self.event_us:10.1f}"
                f" us  {k}")


# Late in a long process (after every phase of chip_smoke.py on the card)
# the profiler was seen to drop kernel records: the first 7-9 of every
# session in one run, every record of some sessions in another. So every
# session launches _PREROLL spin kernels ahead of the call (the first of
# ~0.5 ms), which are not counted, and a session whose spins were all
# dropped is not trusted: it is taken again, up to _ATTEMPTS times.
_PREROLL = 32
_ATTEMPTS = 3


def kernel_time(fn: Callable):
    """(µs, count) of the CUDA kernels ``torch.profiler`` records in one
    call of ``fn``, after the uncounted spins; (None, None) where no
    session of ``_ATTEMPTS`` recorded a spin and a kernel of the call."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1_000_000)
            for _ in range(_PREROLL - 1):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        ks = [e for e in prof.events() if e.device_type.name == "CUDA"]
        spin = ["spin_kernel" in e.name for e in ks]
        ks = [e for e, s in zip(ks, spin) if not s]
        if ks and any(spin):
            return sum(e.time_range.elapsed_us() for e in ks), len(ks)
        time.sleep(0.1)
    return None, None


def time_stage(fn: Callable, dev: torch.device, n: int = 10,
               warmup: int = 2) -> StageTime:
    """Time ``fn`` (no arguments) as the module docstring says."""
    for _ in range(warmup):
        fn()
    sync(dev)
    cuda = dev.type == "cuda"
    if cuda:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    if cuda:
        b.record()
    sync(dev)
    host_ms = (time.perf_counter() - t0) / n * 1e3
    if not cuda:
        return StageTime(host_ms, None, None, None)
    return StageTime(host_ms, a.elapsed_time(b) / n * 1e3, *kernel_time(fn))
