"""On four cards, at the cell's own size: the four-card large map's run
is correct and the control (the reference in TF32 in the program's place)
is not, by the cell's limits. Marked ``card``; skips without four
cards."""
import pytest
import torch

from portbench import harness

pytestmark = pytest.mark.card


def test_program_correct_control_not(card):
    c = harness.find_cell(harness.load_manifest(), "largemap.k1024x4")
    if torch.cuda.device_count() < c.chips:
        pytest.skip(f"needs {c.chips} CUDA cards")
    driver = harness.load_module("drivers", c.config_name)
    ref = harness.load_module("reference", c.config_name)
    state = driver.setup(c.config, c.traffic, 29, card, log=lambda *a: None)
    res = driver.window(state, 1.0)
    checks = driver.check(state, res, ref, c.traffic["limits"], 29,
                          log=lambda *a: None)
    assert all(x["value"] <= x["limit"] for x in checks.values()), checks
    low = driver.control(state, res, ref, 29)
    assert not low["h_ratio"] <= c.traffic["limits"]["h_ratio"], low
    del state, res
    torch.cuda.empty_cache()
