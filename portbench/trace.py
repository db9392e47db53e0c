"""The traced run's reading: one ``torch.profiler`` session over the traced
window, reduced to what the per-layer metrics and the breakdown read.

Device time is every kernel, copy and fill the profiler's CUPTI trace holds
that starts inside the window (not the ranges that ``record_function``
mirrors onto the device's timeline); busy time is the length of the union
of their intervals. An idle gap is a stretch between two
device intervals; it is put down to the innermost of the harness's own
spans (``solve``, ``step``, ``readback``) that the host was in when the
gap opened.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

SPANS = ("solve", "step", "readback")


class DeviceOp(NamedTuple):
    name: str
    start_ns: int
    dur_ns: int


class Trace(NamedTuple):
    ops: list            # [DeviceOp], by start
    busy_s: float
    window_s: float
    idle_gaps: list      # [(span, seconds)], largest first
    device_ops: list     # [(name, seconds)], largest first


def span(name: str, on: bool):
    """A harness span: a ``record_function`` range when tracing."""
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


def profiler():
    """A session of the host's events and, where there is a card, its
    CUPTI trace."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _union(intervals):
    """(total length, merged intervals) of sorted [start, end) pairs."""
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def _short(name: str) -> str:
    return name if len(name) <= 96 else name[:96]


def read(prof, window_ns: tuple) -> Trace:
    """Reduce a finished profiler session. ``window_ns`` is the traced
    window's (start, end) on the profiler's clock, taken from the
    ``window`` span the harness opens around it."""
    from torch.autograd import DeviceType

    lo, hi = window_ns
    ops, spans = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            s = e.start_ns()
            if lo <= s <= hi:
                ops.append(DeviceOp(e.name(), s, e.duration_ns()))
        elif e.name() in SPANS:
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                          e.name()))
    ops.sort(key=lambda o: o.start_ns)
    busy_ns, merged = _union([(o.start_ns, o.start_ns + o.dur_ns)
                              for o in ops])
    gaps = {}
    edges = [lo] + [x for m in merged for x in m] + [hi]
    spans.sort()
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        inner = [s for s in spans if s[0] <= a < s[1]]
        where = min(inner, key=lambda s: s[1] - s[0])[2] if inner else \
            "harness"
        gaps[where] = gaps.get(where, 0.0) + (b - a) / 1e9
    by_name = {}
    for o in ops:
        by_name[o.name] = by_name.get(o.name, 0) + o.dur_ns
    device_ops = sorted(((_short(n), t / 1e9) for n, t in by_name.items()),
                        key=lambda kv: -kv[1])
    return Trace(ops, busy_ns / 1e9, (hi - lo) / 1e9,
                 sorted(gaps.items(), key=lambda kv: -kv[1]), device_ops)


def window_bounds(prof) -> tuple:
    """(start, end) ns of the ``window`` span of a finished session."""
    for e in prof.profiler.kineto_results.events():
        if e.name() == "window":
            return e.start_ns(), e.start_ns() + e.duration_ns()
    raise RuntimeError("the traced session holds no window span")
