"""Wall-clock tic/toc tracing gated by a global flag (own copy of
``deepfactors_tpu/utils/timing.py``; reference sources/common/timing.
{h,cpp}:24-46). Pairs print on toc when enabled; cumulative stats are
queryable. Host clock only: a span that should include device work must
end in ``torch.cuda.synchronize()``."""
from __future__ import annotations

import time
from collections import defaultdict

_enabled = False
_starts: dict = {}
_totals: dict = defaultdict(float)
_counts: dict = defaultdict(int)


def enable_timing(on: bool = True):
    global _enabled
    _enabled = on


def tic(name: str):
    if _enabled:
        _starts[name] = time.perf_counter()


def toc(name: str):
    if _enabled and name in _starts:
        dt = time.perf_counter() - _starts.pop(name)
        _totals[name] += dt
        _counts[name] += 1
        print(f"[timing] {name}: {dt * 1000:.2f} ms")


def timing_summary() -> dict:
    return {
        k: {"total_s": _totals[k], "count": _counts[k],
            "avg_ms": 1000 * _totals[k] / max(_counts[k], 1)}
        for k in _totals
    }


def reset_timing():
    _starts.clear()
    _totals.clear()
    _counts.clear()
