"""The port's tracer: nested spans on the profiler's clock.

``with span(name, frame=None):`` times a block. Spans nest through a stack
per thread; each record holds its id, its parent's id (0 for a root) and
a trace id: the frame number on the frame path (``frame=``), inherited
from the parent where not given, so the spans of one frame share it.

A span records while an operator has turned the tracer on
(``enable_timing(True)``, the demo's ``--enable_timing``) or while a
``torch.profiler`` session records; otherwise it costs one check and
returns a shared null context (no allocation, no ``record_function``, no
CUDA call). An on span keeps, in memory (at most ``CAP`` records; later
spans are counted as dropped, ``dropped()``):

- its host start and end in Unix-epoch ns (``time.time_ns()``), the clock
  of the profiler's events;
- where CUDA is initialised and the current stream is not capturing, its
  device start and end: CUDA events recorded on the current stream at open
  and close, placed on the same clock by one anchor per device (the device
  synchronised, then events recorded and waited for; the time of the one
  the host bracketed most tightly taken as the midpoint of the host times
  around it). They are converted lazily, in ``spans()``, which waits for
  the events. The anchor is taken when a device first records after
  ``enable_timing(True)`` or ``reset_timing()``.

While a profiler records, a span also opens ``record_function(name)``, so
that the profiler's trace shows the same names on host and device.

``spans()`` returns the records (``Span``), ``timing_summary()`` count,
total and self time per name (host, and device where recorded),
``reset_timing()`` clears them. ``tag(frame, kind)`` names the event kind
of the innermost open span of a frame.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple, Optional

import torch
from torch.autograd import profiler as _prof

CAP = 1 << 16
ANCHOR_TRIES = 5

_enabled = False
_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_records: list = []
_dropped = 0
_anchors: dict = {}      # device index -> (host ns, event)
_pool: dict = {}         # device index -> [free events]


class Span(NamedTuple):
    id: int
    parent: int                 # 0: a root
    trace: Optional[int]        # the frame number on the frame path
    name: str
    kind: Optional[str]         # the frame's event kind, where tagged
    thread: int
    host_start_ns: int
    host_end_ns: int
    dev_start_ns: Optional[int]  # None: no device interval recorded
    dev_end_ns: Optional[int]


def enable_timing(on: bool = True):
    """Turn the tracer on or off for the operator (the profiler turns it on
    by itself while it records). Turning it on re-anchors device times."""
    global _enabled
    if on:
        _anchors.clear()
    _enabled = on


def span(name: str, frame: Optional[int] = None):
    """A context manager timing its block as the span ``name``; ``frame``
    sets the trace id (default: the enclosing span's)."""
    if not (_enabled or _prof._is_profiler_enabled):
        return _NULL
    return _Open(name, frame)


def tag(frame: int, kind: str):
    """Name ``kind`` the event of the innermost open span of this thread
    whose trace id is ``frame``."""
    if not (_enabled or _prof._is_profiler_enabled):
        return
    for s in reversed(_stack()):
        if s.trace == frame:
            s.kind = kind
            return


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _event(dev: int):
    free = _pool.get(dev)
    return free.pop() if free else torch.cuda.Event(enable_timing=True)


def _release(dev: int, *events):
    _pool.setdefault(dev, []).extend(events)


def _anchor(dev: int):
    """(host ns, event) of the device's anchor, taken at the first call:
    of ``ANCHOR_TRIES`` events each recorded on the idle device and waited
    for, the one the host bracketed most tightly, placed at the middle of
    its bracket (a host slow to reach the record, as after a sleep, widens
    a bracket and would place the anchor early)."""
    a = _anchors.get(dev)
    if a is None:
        torch.cuda.synchronize(dev)
        best = None
        for _ in range(ANCHOR_TRIES):
            e = torch.cuda.Event(enable_timing=True)
            t0 = time.time_ns()
            e.record()
            e.synchronize()
            t1 = time.time_ns()
            if best is None or t1 - t0 < best[0]:
                best = (t1 - t0, (t0 + t1) // 2, e)
        a = _anchors[dev] = best[1:]
    return a


class _Open:
    """A span while it is open, then its record until converted."""

    __slots__ = ("id", "parent", "trace", "name", "kind", "thread", "t0",
                 "t1", "dev", "anchor", "ev0", "ev1", "d0", "d1", "mirror")

    def __init__(self, name: str, frame: Optional[int]):
        self.name, self.trace, self.kind = name, frame, None
        self.dev = self.ev0 = self.ev1 = self.d0 = self.d1 = None
        self.mirror = None

    def __enter__(self):
        st = _stack()
        up = st[-1] if st else None
        self.parent = up.id if up is not None else 0
        if self.trace is None and up is not None:
            self.trace = up.trace
        self.id = next(_ids)
        self.thread = threading.get_ident()
        st.append(self)
        if _prof._is_profiler_enabled:
            self.mirror = _prof.record_function(self.name)
        self.t0 = time.time_ns()
        if self.mirror is not None:
            self.mirror.__enter__()
        if torch.cuda.is_initialized() and \
                not torch.cuda.is_current_stream_capturing():
            self.dev = torch.cuda.current_device()
            self.anchor = _anchor(self.dev)
            self.ev0 = _event(self.dev)
            self.ev0.record()
        return self

    def __exit__(self, *exc):
        global _dropped
        if self.ev0 is not None:
            self.ev1 = _event(self.dev)
            self.ev1.record()
        if self.mirror is not None:
            self.mirror.__exit__(None, None, None)
        self.t1 = time.time_ns()
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        elif self in st:
            st.remove(self)
        with _lock:
            keep = len(_records) < CAP
            if keep:
                _records.append(self)
            else:
                _dropped += 1
        if not keep and self.ev0 is not None:
            _release(self.dev, self.ev0, self.ev1)
        return False

    def record(self) -> Span:
        if self.ev1 is not None and self.d0 is None:
            host, a = self.anchor
            self.ev1.synchronize()
            self.d0 = host + round(a.elapsed_time(self.ev0) * 1e6)
            self.d1 = self.d0 + round(self.ev0.elapsed_time(self.ev1) * 1e6)
            _release(self.dev, self.ev0, self.ev1)
            self.ev0 = self.ev1 = None
        return Span(self.id, self.parent, self.trace, self.name, self.kind,
                    self.thread, self.t0, self.t1, self.d0, self.d1)


def spans() -> list:
    """Every kept record since the last ``reset_timing()``, in the order
    the spans closed, device times converted (waiting for their events)."""
    with _lock:
        recs = list(_records)
    return [r.record() for r in recs]


def dropped() -> int:
    """Spans closed since the last reset while ``CAP`` records were kept."""
    return _dropped


def timing_summary() -> dict:
    """name -> count, total and self ms on the host (``host_ms``,
    ``host_self_ms``) and, where a device interval was recorded, on the
    device (``dev_ms``, ``dev_self_ms``). A span's self time is its time
    less its children's."""
    recs = spans()
    child_host, child_dev = {}, {}
    for r in recs:
        if r.parent:
            child_host[r.parent] = child_host.get(r.parent, 0) + \
                r.host_end_ns - r.host_start_ns
            if r.dev_start_ns is not None:
                child_dev[r.parent] = child_dev.get(r.parent, 0) + \
                    r.dev_end_ns - r.dev_start_ns
    out = {}
    for r in recs:
        s = out.setdefault(r.name, {"count": 0, "host_ms": 0.0,
                                    "host_self_ms": 0.0})
        s["count"] += 1
        host = r.host_end_ns - r.host_start_ns
        s["host_ms"] += host / 1e6
        s["host_self_ms"] += (host - child_host.get(r.id, 0)) / 1e6
        if r.dev_start_ns is not None:
            dev = r.dev_end_ns - r.dev_start_ns
            s["dev_ms"] = s.get("dev_ms", 0.0) + dev / 1e6
            s["dev_self_ms"] = s.get("dev_self_ms", 0.0) + \
                (dev - child_dev.get(r.id, 0)) / 1e6
    return out


def reset_timing():
    """Forget every record, the drop count and the device anchors."""
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0
    _anchors.clear()
