"""Profiling: ``torch.profiler`` traces and synchronised op timing.

PyTorch port of ``deepfactors_tpu/utils/profiling.py`` (the equivalent of
the reference's kernel_benchmark grid search and tic/toc tracing): capture
a trace of host and device activity for the Chrome trace viewer or
TensorBoard, time callables with the device synchronised, and name regions
of a trace.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


def _sync(device=None):
    if torch.cuda.is_available():
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(log_dir: str = "df_trace"):
    """Profile the block (CPU, and CUDA where there is a card) and write
    ``trace.json`` (Chrome trace format) into ``log_dir``; yields the
    profiler (``key_averages()`` sums by op and kernel)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def time_fn(fn, *args, iters: int = 20, warmup: int = 2, **kwargs):
    """Average wall time of a callable in ms, each end synchronised with
    the card (host clock: includes launch overhead)."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    _sync()
    return (time.perf_counter() - t0) / iters * 1000.0


def annotate(name: str):
    """A named region in the profiler's trace (``record_function``)."""
    return torch.profiler.record_function(name)
