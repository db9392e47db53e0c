"""BENCHMARK.json against the benchmark's contract: names, units, keys,
bounds, what each cell reports, and the files each name needs."""
import json
import os
import re

import pytest

from portbench import harness

M = harness.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"projection|head|expansion|experts_per_tok|code_size|"
                   r"base_ch|width|height")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def _names():
    out = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        out += [(group, e["name"]) for e in M[group]]
    return out


def test_top_level_keys_and_size():
    assert set(M) == TOP
    with open(os.path.join(harness.ROOT, "BENCHMARK.json"), "rb") as f:
        assert len(f.read()) <= 64 * 1024


@pytest.mark.parametrize("group,name", _names())
def test_names(group, name):
    assert NAME.match(name), name
    names = [e["name"] for e in M[group]]
    assert names.count(name) == 1


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_entry_keys(group):
    for e in M[group]:
        extra = ({"workloads"} if group in ("end_to_end", "per_layer")
                 else set())
        assert KEYS[group] <= set(e) <= KEYS[group] | extra, e["name"]


@pytest.mark.parametrize("metric", M["end_to_end"] + M["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_units_and_fields(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in M["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert _line(metric["layer"])
        assert metric["moves"] in {m["name"] for m in M["end_to_end"]}
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_command_paths_and_run_seconds():
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.rstrip("/").endswith("_torch")
        assert os.path.isdir(os.path.join(harness.ROOT, p))
    assert 1 <= len(M["command"]) <= 32
    for w in M["command"]:
        assert _line(w) and not w.startswith("/") and ".." not in w
        if "/" in w:
            assert any(w.startswith(p.rstrip("/") + "/") for p in M["paths"])
    rs = M["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its 43,200 seconds
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    used = {w["config"] for w in M["workloads"]}
    files = [c["file"] for c in M["configs"]]
    assert len(set(files)) == len(files) and 1 <= len(files) <= 24
    for c in M["configs"]:
        assert c["name"] in used
        assert _line(c["source"]) and c["source"].startswith("https://")
        assert _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in M["paths"])
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and k in cfg and not WIDTH.search(k), k


def test_workloads():
    assert 1 <= len(M["workloads"]) <= 24
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)
    for w in M["workloads"]:
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_every_cell_reports_what_it_must(cell):
    c = harness.find_cell(M, cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    # each per-layer metric's end-to-end metric is reported in its cells
    for m in c.per_layer:
        assert m["moves"] in e2e, (cell, m["name"])


def test_layers_named_alike():
    """Metrics of one layer give the same layer string; a metric's layer
    and moves pair up with its cells."""
    layers = {}
    for m in M["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["moves"])
    assert all(_line(k) for k in layers)


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_files_for_every_name(cell):
    c = harness.find_cell(M, cell)
    root = harness.ROOT / "portbench"
    assert (root / "drivers" / f"{c.config_name}.py").exists()
    assert (root / "reference" / f"{c.config_name}.py").exists()
    assert (root / "traffic" / f"{c.config_name}.{c.traffic_name}.json"
            ).exists()
    for m in c.per_layer:
        assert (root / "metrics" / f"{m['name']}.py").exists()
    assert set(c.traffic["limits"]) and all(
        isinstance(v, (int, float)) for v in c.traffic["limits"].values())


def test_manifest_is_plain_json():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        assert json.load(f) == M
