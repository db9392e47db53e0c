"""``portbench/spans.py`` and the nine metrics that read the program's
spans, on synthetic device operations and spans with known answers: stream
time a unit, idle put down to the innermost span open when a gap opened,
and None where there is no span or no device interval; and the reader on
the program's own tracer."""
from typing import NamedTuple, Optional

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import harness, spans
from portbench.trace import DeviceOp, Trace

MS = 1_000_000
BA = ("ba_linearise_ms", "ba_assemble_ms", "ba_solve_ms")
BA_IDLE = ("ba_linearise_idle_ms", "ba_assemble_idle_ms",
           "ba_solve_idle_ms")
TRAIN = ("train_forward_ms", "train_backward_ms", "train_optimiser_ms")


class Rec(NamedTuple):
    name: str
    host_start_ns: int
    host_end_ns: int
    dev_start_ns: Optional[int] = None
    dev_end_ns: Optional[int] = None


def _op(a, b):
    return DeviceOp("k", a * MS, (b - a) * MS)


# two BA iterations on the host (ms): linearise [0, 100) with an inner span
# [25, 40), assemble [100, 150), solve [150, 200); then [1000, 1200)
RECS = [Rec("inner", 25 * MS, 40 * MS),
        Rec("ba.linearise", 0, 100 * MS, 10 * MS, 60 * MS),
        Rec("ba.assemble", 100 * MS, 150 * MS, 60 * MS, 80 * MS),
        Rec("ba.solve", 150 * MS, 200 * MS, 80 * MS, 95 * MS),
        Rec("ba.linearise", 1000 * MS, 1100 * MS, 1000 * MS, 1040 * MS),
        Rec("ba.assemble", 1100 * MS, 1150 * MS, 1040 * MS, 1050 * MS),
        Rec("ba.solve", 1150 * MS, 1200 * MS, 1050 * MS, 1060 * MS)]
# gaps: (30, 35) under inner; (60, 120) under linearise; (130, 160) under
# assemble; (170, 210) under solve; (220, 1010) under no span; (1020,
# 1030) under linearise; (1040, 1160) under linearise (the op [1030, 1040)
# ends in it)
OPS = [_op(*x) for x in ((10, 30), (35, 60), (120, 130), (160, 170),
                         (210, 220), (1010, 1020), (1030, 1040),
                         (1160, 1170), (1165, 1168))]


def test_idle_goes_to_the_innermost_open_span():
    idle = spans.idle_by_span(OPS, RECS)
    assert idle == {"inner": 5 * MS, "ba.linearise": (60 + 10 + 120) * MS,
                    "ba.assemble": 30 * MS, "ba.solve": 40 * MS,
                    None: 790 * MS}


def test_stream_and_idle_per_unit():
    assert spans.stream_ms(RECS, "ba.linearise", 2) == pytest.approx(45.0)
    assert spans.stream_ms(RECS, "ba.assemble", 2) == pytest.approx(15.0)
    assert spans.stream_ms(RECS, "ba.solve", 2) == pytest.approx(12.5)
    assert spans.idle_ms(OPS, RECS, "ba.linearise", 2) == pytest.approx(95)
    assert spans.idle_ms(OPS, RECS, "ba.solve", 4) == pytest.approx(10)


def test_none_without_spans_or_device_intervals():
    host_only = [r._replace(dev_start_ns=None, dev_end_ns=None)
                 for r in RECS]
    assert spans.stream_ms(None, "ba.solve", 2) is None
    assert spans.stream_ms([], "ba.solve", 2) is None
    assert spans.stream_ms(host_only, "ba.solve", 2) is None
    assert spans.stream_ms(RECS, "train.forward", 2) is None
    assert spans.stream_ms(RECS, "ba.solve", 0) is None
    assert spans.idle_ms(OPS, None, "ba.solve", 2) is None
    assert spans.idle_ms([], RECS, "ba.solve", 2) is None
    assert spans.idle_ms(OPS, RECS, "train.forward", 2) is None
    # a span present under which no gap opened reads 0
    assert spans.idle_ms(OPS[:1], RECS, "ba.solve", 2) == 0.0


def _ctx(units, ops=OPS):
    trace = Trace(ops, 0.0, 1.2, [], [])
    return harness.MetricContext(trace, units, {}, None, None)


def _read(name, ctx):
    return harness.load_module("metrics", name).read(ctx)


def test_the_nine_metrics(monkeypatch):
    train = [Rec("train.forward", 0, 10 * MS, 0, 30 * MS),
             Rec("train.backward", 10 * MS, 20 * MS, 30 * MS, 80 * MS),
             Rec("train.optimiser", 20 * MS, 30 * MS, 80 * MS, 90 * MS)]
    monkeypatch.setattr(spans, "program_spans", lambda: RECS + train)
    ba = _ctx({"iterations": 2, "solves": 1})
    assert [_read(n, ba) for n in BA] == pytest.approx([45.0, 15.0, 12.5])
    assert [_read(n, ba) for n in BA_IDLE] == pytest.approx([95.0, 15.0,
                                                             20.0])
    assert [_read(n, ba) for n in TRAIN] == [None] * 3
    tr = _ctx({"steps": 2})
    assert [_read(n, tr) for n in TRAIN] == pytest.approx([15.0, 25.0, 5.0])
    assert [_read(n, tr) for n in BA + BA_IDLE] == [None] * 6
    monkeypatch.setattr(spans, "program_spans", lambda: None)
    for n in BA + BA_IDLE + TRAIN:
        assert _read(n, ba) is None and _read(n, tr) is None


def test_the_reader_on_the_programs_tracer(monkeypatch):
    from deepfactors_tpu_torch.utils import timing
    timing.reset_timing()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            with timing.span("ba.solve"):
                torch.zeros(3).sum()
        got = spans.program_spans()
        assert [r.name for r in got] == ["ba.solve"]
        # no card here: no device interval, so no stream time
        assert spans.stream_ms(got, "ba.solve", 1) is None
        # a program without the tracer's reader gives None
        monkeypatch.delattr(timing, "spans")
        assert spans.program_spans() is None
    finally:
        timing.reset_timing()
