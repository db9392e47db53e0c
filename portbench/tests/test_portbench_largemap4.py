"""The four-card large map cut to the CPU: ``largemap.k1024x4`` at the
tiny size (``tiny.cell``) runs as a world of four gloo ranks, rank 0 in
this process and ranks 1-3 started by the driver, and comes out correct,
traced and not; every fault the driver can plant, the exchange's
included, comes out not correct; a rank that fails ends the world."""
import pytest
import torch

from . import tiny

CELL = "largemap.k1024x4"


def test_sound_run_is_correct():
    out = tiny.run(CELL, seed=5, seconds=0.3)
    assert out["correct"] is True, out["checks"]
    assert set(out["checks"]) == {"h_ratio", "replica_gap"}
    # the ranks' replicated solves agree bit for bit
    assert out["checks"]["replica_gap"]["value"] == 0.0
    assert set(out["metrics"]) == {"ba_iter_ms", "setup_s"}


def test_traced_run_is_correct():
    out = tiny.run(CELL, seed=6, trace=True, seconds=0.3)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] == 2       # trace_units
    # no device on the CPU: the device metrics read nothing and are left out
    assert "ba_allreduce_ms" not in out["metrics"]
    assert "allreduce_bus_share" not in out["metrics"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered",
                                   "exchange"])
def test_fault_is_not_correct(fault):
    out = tiny.run(CELL, seed=17, fault=fault, seconds=0.2)
    assert out["correct"] is False
    assert any(not c["value"] <= c["limit"] for c in out["checks"].values())


def test_device_report_counts_every_card(monkeypatch):
    """The result line of a world on four cards reports four, of rank 0's
    kind; a card of another kind is not counted; ``stop`` restores the
    harness's own report."""
    harness = tiny.harness
    driver = harness.load_module("drivers", "largemap4")
    names = {0: "card", 1: "card", 2: "other", 3: "card"}
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: names[torch.device(d).index])
    monkeypatch.setattr(harness, "device_kind", harness.device_kind)
    cards = [torch.device("cuda", i) for i in range(4)]
    state = {"own_report": driver.report_cards(cards)}
    assert harness.device_kind(cards[0]) == {"platform": "gpu",
                                             "kind": "card", "count": 3}
    names[2] = "card"
    assert harness.device_kind(cards[0])["count"] == 4
    assert harness.device_kind(torch.device("cpu"))["count"] == 1
    assert driver.stop(state) == []
    assert harness.device_kind(cards[0])["count"] == 1


_FAILING_RANK = r"""
import sys, time
sys.path.insert(0, sys.argv[1])
from portbench import harness
driver = harness.load_module("drivers", "largemap4")
# a rank that cannot start: the watchdog ends this process, never a hang
ranks = driver.Ranks({"device": "no-such-device"}, 2)
time.sleep(120)
"""


def test_a_failing_rank_ends_the_world():
    import subprocess
    import sys
    import time
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, "-c", _FAILING_RANK,
                        str(tiny.harness.ROOT)], capture_output=True,
                       text=True, timeout=100)
    assert r.returncode == 1
    assert "rank 1 ended with 1" in r.stderr
    assert time.monotonic() - t0 < 60
