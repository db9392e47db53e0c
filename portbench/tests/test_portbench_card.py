"""On the card, at the cells' own sizes: the program's run is correct and
the control (the reference in the next lower precision in the program's
place) is not, by the cell's limits. Marked ``card``; skips without one."""
import pytest
import torch

from portbench import harness

pytestmark = pytest.mark.card


@pytest.mark.parametrize("cell", ["largemap.k128", "train.b64"])
def test_program_correct_control_not(card, cell):
    c = harness.find_cell(harness.load_manifest(), cell)
    driver = harness.load_module("drivers", c.config_name)
    ref = harness.load_module("reference", c.config_name)
    state = driver.setup(c.config, c.traffic, 23, card, log=lambda *a: None)
    res = driver.window(state, 1.0)
    checks = driver.check(state, res, ref, c.traffic["limits"], 23,
                          log=lambda *a: None)
    assert all(x["value"] <= x["limit"] for x in checks.values()), checks
    low = driver.control(state, res, ref, 23)
    limits = c.traffic["limits"]
    assert any(not low[k] <= lim for k, lim in limits.items()), low
    del state, res
    torch.cuda.empty_cache()
