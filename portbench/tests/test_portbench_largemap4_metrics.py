"""The two metrics of the four-card large map's exchange, on a made-up
trace: ``ba_allreduce_ms`` (the program's ``ba.allreduce`` spans' stream
time a BA iteration) and ``allreduce_bus_share`` (the counted bytes as a
ring moves them, over the NCCL all-reduce kernels' time, against the
link's peak); each None where its source is missing."""
import pytest

from portbench import harness, links, spans
from portbench.trace import DeviceOp, Trace

from .test_portbench_spans import MS, Rec

NCCL = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage)"
OPS = [DeviceOp("dense_warp_kernel", 0, 5 * MS),
       DeviceOp(NCCL, 10 * MS, 20 * MS),
       DeviceOp("ncclDevKernel_Broadcast_RING_LL", 40 * MS, 1 * MS),
       DeviceOp(NCCL, 50 * MS, 30 * MS)]
RECS = [Rec("ba.assemble", 0, 90 * MS, 8 * MS, 82 * MS),
        Rec("ba.allreduce", 5 * MS, 85 * MS, 10 * MS, 30 * MS),
        Rec("ba.allreduce", 100 * MS, 180 * MS, 50 * MS, 80 * MS)]
GB = 10 ** 9


def _ctx(units, ranks=4, ops=OPS):
    return harness.MetricContext(Trace(ops, 0.0, 0.1, [], []), units,
                                 {"ranks": ranks}, None, None)


def _read(name, ctx):
    return harness.load_module("metrics", name).read(ctx)


def test_allreduce_stream_time(monkeypatch):
    monkeypatch.setattr(spans, "program_spans", lambda: RECS)
    assert _read("ba_allreduce_ms", _ctx({"iterations": 2})) == \
        pytest.approx(25.0)
    monkeypatch.setattr(spans, "program_spans", lambda: RECS[:1])
    assert _read("ba_allreduce_ms", _ctx({"iterations": 2})) is None
    monkeypatch.setattr(spans, "program_spans", lambda: None)
    assert _read("ba_allreduce_ms", _ctx({"iterations": 2})) is None


def test_bus_share():
    # 15 GB counted over 4 ranks: 22.5 GB a direction in 50 ms of the two
    # all-reduce kernels (the broadcast not counted): 450 GB/s, the peak
    ctx = _ctx({"iterations": 2, "allreduce_bytes": 15 * GB})
    assert _read("allreduce_bus_share", ctx) == pytest.approx(
        100.0 * 22.5 * GB / 0.05 / links.PEAK_LINK_BYTES)
    assert _read("allreduce_bus_share", ctx) == pytest.approx(100.0)
    half = _ctx({"iterations": 2, "allreduce_bytes": 7.5 * GB})
    assert _read("allreduce_bus_share", half) == pytest.approx(50.0)
    assert links.ring_allreduce_bytes(8, 2) == 8


@pytest.mark.parametrize("units,ranks,ops", [
    ({"iterations": 2}, 4, OPS),                            # no counter
    ({"iterations": 2, "allreduce_bytes": 0}, 4, OPS),      # nothing sent
    ({"iterations": 2, "allreduce_bytes": GB}, 1, OPS),     # one rank
    ({"iterations": 2, "allreduce_bytes": GB}, 4, OPS[:1]),  # no NCCL
])
def test_bus_share_none_without_its_sources(units, ranks, ops):
    assert _read("allreduce_bus_share", _ctx(units, ranks, ops)) is None
