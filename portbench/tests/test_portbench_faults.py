"""A run with the timed path broken underneath comes out not correct, for
every fault each cell can have: a step that returns its state unchanged;
half of the batch (of the factors) left out; an answer altered where it is
produced. (The exchange between cards is no fault of these one-card
cells.) The run skips the harness's look for a card and drives the rest on
the CPU at a small size, with the cell's own limits; the sound run comes
out correct."""
import pytest

from . import tiny

CASES = [(c, f) for c in ("largemap.k128", "train.b64")
         for f in (None, "unchanged", "half", "altered")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(cell, fault):
    out = tiny.run(cell, seed=17, fault=fault, seconds=0.2)
    assert out["correct"] is (fault is None), out["checks"]
    assert list(out)[-1] == "checks"
    if fault is not None:
        assert any(not c["value"] <= c["limit"]
                   for c in out["checks"].values())


def test_traced_run_reads_its_metrics():
    out = tiny.run("largemap.k128", trace=True, seconds=0.2)
    assert set(out["device"]) >= {"busy_s", "window_s", "memory_peak_bytes"}
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device on the CPU: the device metrics read nothing and are left out
    assert "idle_share.ba" not in out["metrics"]
    assert "ba_mfu" in out["metrics"]
