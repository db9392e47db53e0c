"""A configuration, a traffic mix and a per-layer metric are added by
adding files: a copy of the benchmark gains a configuration (its file, and
a driver and a reference that reuse the large map's), a traffic mix and a
metric, each by new files and an entry in its BENCHMARK.json, and a run of
the new cell finds them, with no file that was there edited."""
import json
import shutil

import pytest

from portbench import harness

from . import tiny

METRIC = '''"""Solves the traced window finished (a metric added by a file)."""


def read(ctx):
    return ctx.units.get("solves")
'''
DRIVER = '''"""The large map's driver, for a second configuration."""
from .largemap import *  # noqa: F401,F403
'''
REFERENCE = '''"""The large map's reference, for a second configuration."""
from .largemap import *  # noqa: F401,F403
'''


@pytest.fixture
def grown(tmp_path):
    """A copy of the benchmark with one configuration, one traffic mix and
    one per-layer metric added as files."""
    shutil.copytree(harness.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    m = harness.load_manifest()
    pb = tmp_path / "portbench"
    cfg = harness.load_json(pb / "configs" / "largemap.json")
    cfg.update(name="lmwide", back=3)
    (pb / "configs" / "lmwide.json").write_text(json.dumps(cfg))
    (pb / "drivers" / "lmwide.py").write_text(DRIVER)
    (pb / "reference" / "lmwide.py").write_text(REFERENCE)
    (pb / "traffic" / "lmwide.k6.json").write_text(json.dumps(
        dict(harness.load_json(pb / "traffic" / "largemap.k128.json"), K=6)))
    (pb / "metrics" / "solves_done.py").write_text(METRIC)
    m["configs"].append(dict(m["configs"][0], name="lmwide",
                             file="portbench/configs/lmwide.json"))
    m["workloads"].append({"name": "lmwide.k6", "config": "lmwide",
                           "traffic": "k6", "chips": 1, "why": "a test"})
    m["end_to_end"][0]["workloads"].append("lmwide.k6")
    m["per_layer"].append({"name": "solves_done", "unit": "solves",
                           "better": "higher", "source": "program_counter",
                           "layer": "BA step", "moves": "ba_iter_ms",
                           "workloads": ["lmwide.k6"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    return tmp_path, before


def test_added_files_are_found(grown):
    root, before = grown
    cell = harness.find_cell(harness.load_manifest(root), "lmwide.k6", root)
    assert cell.config["back"] == 3 and cell.traffic["K"] == 6
    assert [m["name"] for m in cell.per_layer] == ["solves_done"]
    assert {m["name"] for m in cell.end_to_end} == {"ba_iter_ms", "setup_s"}
    assert harness.load_module("metrics", "solves_done", root).read(
        harness.MetricContext(None, {"solves": 3}, {}, None, None)) == 3
    # nothing that was there changed
    for rel, data in before.items():
        assert (root / rel).read_bytes() == data


def test_added_cell_runs(grown):
    root, _ = grown
    out = tiny.run("lmwide.k6", trace=True, root=root)
    assert out["correct"] is True
    assert out["metrics"]["solves_done"]["value"] == 2
    assert list(out)[-1] == "checks"
    plain = tiny.run("lmwide.k6", root=root)
    assert set(plain["metrics"]) == {"ba_iter_ms", "setup_s"}
