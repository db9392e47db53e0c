"""The program's own spans over the traced window, for the per-layer
metrics whose source is ``program_span``.

The program's tracer (``deepfactors_tpu_torch.utils.timing``) records its
spans while a ``torch.profiler`` session records, so at the end of the
traced window its records hold the window's spans: host start and end on
the profiler's clock, and device start and end where the work ran on a
card. A program without that tracer (``spans()``) gives None, and so does
every metric that reads it.

Stream time of a span is its device interval; idle is a gap between the
traced window's device operations (``ctx.trace.ops``), put down to the
innermost program span open on the host when the gap opened, the rule
``portbench/trace.py`` follows for the harness's own spans.
"""
from __future__ import annotations

import bisect


def program_spans():
    """The program's span records, or None where it has no tracer."""
    try:
        from deepfactors_tpu_torch.utils import timing
    except ImportError:
        return None
    read = getattr(timing, "spans", None)
    return None if read is None else read()


def stream_ms(records, name: str, units: int):
    """The summed device intervals of the spans ``name``, in ms a unit;
    None where no such span has a device interval."""
    if not records or not units:
        return None
    dev = [r.dev_end_ns - r.dev_start_ns for r in records
           if r.name == name and r.dev_start_ns is not None]
    if not dev:
        return None
    return sum(dev) / 1e6 / units


def idle_by_span(ops, records) -> dict:
    """Idle ns between the device operations ``ops`` (``start_ns``,
    ``dur_ns``), by the name of the innermost span of ``records`` open on
    the host when each gap opened (the shortest such span); None holds the
    gaps under no span."""
    merged = []
    for o in sorted(ops, key=lambda o: o.start_ns):
        s, e = o.start_ns, o.start_ns + o.dur_ns
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
    starts = [a for a, _ in gaps]
    owner = [None] * len(gaps)
    for r in records:
        d = r.host_end_ns - r.host_start_ns
        lo = bisect.bisect_left(starts, r.host_start_ns)
        hi = bisect.bisect_left(starts, r.host_end_ns)
        for i in range(lo, hi):
            if owner[i] is None or d < owner[i][0]:
                owner[i] = (d, r.name)
    out = {}
    for (a, b), w in zip(gaps, owner):
        k = w[1] if w is not None else None
        out[k] = out.get(k, 0) + b - a
    return out


def idle_ms(ops, records, name: str, units: int):
    """Idle under the spans ``name``, in ms a unit; None where no such
    span was recorded or the window holds no device operation."""
    if not records or not units or not ops or \
            not any(r.name == name for r in records):
        return None
    return idle_by_span(ops, records).get(name, 0) / 1e6 / units


def stream_metric(ctx, name: str, unit: str):
    """A metric's reading: ``stream_ms`` of the program's spans ``name``
    over the window's ``unit``s."""
    return stream_ms(program_spans(), name, ctx.units.get(unit))


def idle_metric(ctx, name: str, unit: str):
    """A metric's reading: ``idle_ms`` of the program's spans ``name``
    over the window's ``unit``s."""
    return idle_ms(ctx.trace.ops, program_spans(), name,
                   ctx.units.get(unit))
