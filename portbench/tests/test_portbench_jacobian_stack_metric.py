"""``jacobian_stack_roofline`` on a made-up trace: the bound of the factors
the traced iterations stacked (4 (22 + 2 CS) bytes a factor's pixel at 3.35
TB/s, its operations at 67 TFLOP/s, the larger) over the kernel's profiled
time, reckoned by hand; None where the kernel or the iterations are
missing, as on a program without the kernel."""
import pytest

from portbench import counts, harness
from portbench.trace import DeviceOp, Trace

MS = 1_000_000
KERNEL = "(anonymous namespace)::jacobian_stack_kernel(float const*, ...)"
OPS = [DeviceOp("dense_warp_kernel", 0, 1 * MS),
       DeviceOp(KERNEL, 2 * MS, 3 * MS),
       DeviceOp("ampere_sgemm_128x64_nn", 6 * MS, 1 * MS),
       DeviceOp(KERNEL, 8 * MS, 5 * MS)]
SHAPES = {"K": 8, "P": 124, "CS": 32, "H": 192, "W": 256}


def _read(units, ops=OPS, shapes=SHAPES):
    ctx = harness.MetricContext(Trace(ops, 0.0, 0.1, [], []), units, shapes,
                                None, counts)
    return harness.load_module("metrics", "jacobian_stack_roofline").read(ctx)


def test_share_by_hand():
    # 2 iterations of 124 factors at 192x256, CS 32: 86 planes of 4 bytes a
    # pixel, 2 * 124 * 49,152 * 344 = 4,193,255,424 bytes, 1.2517 ms at
    # 3.35 TB/s (the operations, 282 a pixel, take 0.0512 ms at 67
    # TFLOP/s); the two launches took 8 ms
    nbytes = 2 * 124 * 49_152 * 344
    assert nbytes == 4_193_255_424
    share = _read({"iterations": 2})
    assert share == pytest.approx(100.0 * nbytes / 3.35e12 / 0.008)
    assert share == pytest.approx(15.6465, abs=1e-4)


def test_operations_bound_where_they_outweigh_the_bytes():
    # CS 1: 24 planes, 96 bytes and 220 operations a pixel; the metric
    # takes the larger of the two times
    mod = harness.load_module("metrics", "jacobian_stack_roofline")
    assert mod.planes(1) == 24 and mod.flops_per_pixel(1) == 220
    assert mod.planes(32) == 86 and mod.flops_per_pixel(32) == 282
    px = 2 * 124 * 49_152
    share = _read({"iterations": 2}, shapes=dict(SHAPES, CS=1))
    assert share == pytest.approx(100.0 * max(96 * px / 3.35e12,
                                              220 * px / 67e12) / 0.008)


@pytest.mark.parametrize("units,ops", [
    ({}, OPS),                           # no iterations counted
    ({"iterations": 0}, OPS),
    ({"iterations": 2}, OPS[:1] + OPS[2:3]),   # no such kernel: the parent
    ({"iterations": 2}, []),
])
def test_none_without_its_sources(units, ops):
    assert _read(units, ops) is None
