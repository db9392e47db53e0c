"""The benchmark of ``deepfactors_tpu_torch``: one run of one cell.

Driven by data. ``BENCHMARK.json`` names each cell's configuration and
traffic; the harness finds everything else by those names:

- ``portbench/configs/<config>.json``: the configuration (the ``file`` the
  manifest gives it);
- ``portbench/traffic/<config>.<traffic>.json``: the cell's mix, with the
  limits of its check;
- ``portbench/drivers/<config>.py``: ``setup``, ``window``, ``check``,
  ``shapes``, ``plant`` and ``control`` of the configuration's system
  under test;
- ``portbench/reference/<config>.py``: its plain reference;
- ``portbench/metrics/<metric>.py``: ``read(ctx)`` of each per-layer
  metric, which returns None where the run holds nothing to read.

A run: check the device, set up (timed as ``setup_s``), measure the window
(``--trace 0``: the end-to-end metrics; ``--trace 1``: a shorter traced
window and the per-layer metrics), read the peak memory, free the
program's state, check the window's outputs against the reference, check
that nothing of JAX was loaded, and print one JSON line.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import re
import sys
import time
from pathlib import Path
from typing import NamedTuple, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "deepfactors_tpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


class Cell(NamedTuple):
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list     # manifest entries that this cell reports
    per_layer: list


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(manifest: dict, workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` with its configuration and traffic read."""
    if not NAME.match(workload):
        raise ValueError(f"not a cell name: {workload!r}")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    cfg = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(root / "portbench" / "traffic"
                        / f"{w['config']}.{w['traffic']}.json")
    return Cell(workload, w["config"], w["traffic"], int(w["chips"]), cfg,
                traffic,
                [m for m in manifest["end_to_end"] if _applies(m, workload)],
                [m for m in manifest["per_layer"] if _applies(m, workload)])


def load_module(kind: str, name: str, root: Path = ROOT):
    """``portbench/<kind>/<name>.py`` as a module of the package
    ``portbench.<kind>``, so that it may import the package's other modules
    relatively (names may hold dots)."""
    if not NAME.match(name):
        raise ValueError(f"not a {kind} name: {name!r}")
    path = root / "portbench" / kind / f"{name}.py"
    mod_name = "portbench.{}._{}_{}".format(
        kind, name.replace(".", "_").replace("-", "_"),
        abs(hash(str(root))))
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, the
    names compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


class MetricContext(NamedTuple):
    """What a per-layer metric reads: the trace, the work done in the
    traced window (``units``: e.g.
    ``{"iterations": n}`` or ``{"steps": n}``), the cell's shapes, the
    window's peak device memory and the yardstick's counts."""
    trace: object
    units: dict
    shapes: dict
    peak_bytes: Optional[int]
    counts: object


def device_kind(device) -> dict:
    import torch
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1}
    return {"platform": "cpu", "kind": "cpu", "count": 1}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t0: float, fault: Optional[str] = None, log=None,
             root: Path = ROOT) -> dict:
    """Set up, measure and check one cell; the result line as a dict (its
    ``checks`` last). ``fault`` plants one of the driver's faults under
    the timed path (the fault tests and the calibration only)."""
    import torch

    from . import counts
    from . import trace as tr

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    log(f"set-up: started {time.perf_counter() - t0:.2f} s after the "
        f"process")
    driver = load_module("drivers", cell.config_name, root)
    cuda = device.type == "cuda"
    state = driver.setup(cell.config, cell.traffic, seed, device, log=log)
    if fault is not None:
        driver.plant(state, fault)
    if cuda:
        torch.cuda.synchronize(device)
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    # the set-up's objects stay out of the collector's passes in the window
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0
    if trace:
        with tr.profiler() as prof:
            with tr.span("window", True):
                res = driver.window(state, seconds,
                                    max_units=cell.traffic["trace_units"],
                                    traced=True)
    else:
        res = driver.window(state, seconds, max_units=None, traced=False)
    u = res["unit_s"]
    log(f"window: {len(u)} units, host s each: median "
        f"{sorted(u)[len(u) // 2]:.4f}, max {max(u):.4f} (unit "
        f"{u.index(max(u))}), first {', '.join(f'{x:.4f}' for x in u[:4])}")
    peak = None
    if cuda:
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    out = {"correct": False, "attempted": res["attempted"],
           "failed": res["failed"], "metrics": {},
           "device": dict(device_kind(device),
                          memory_peak_bytes=max(setup_peak, peak)
                          if cuda else 0)}
    if trace:
        t = tr.read(prof, tr.window_bounds(prof))
        del prof
        out["device"]["busy_s"] = t.busy_s
        out["device"]["window_s"] = t.window_s
        ctx = MetricContext(t, res["units"],
                            driver.shapes(state), peak, counts)
        for m in cell.per_layer:
            v = load_module("metrics", m["name"], root).read(ctx)
            if v is not None:
                out["metrics"][m["name"]] = {"value": float(v),
                                             "unit": m["unit"]}
        out["breakdown"] = {"device_ops": [list(x) for x in t.device_ops[:10]],
                            "idle_gaps": [list(x) for x in t.idle_gaps[:10]]}
    else:
        measured = dict(res["metrics"], setup_s=setup_s)
        for m in cell.end_to_end:
            if m["name"] not in measured:
                raise RuntimeError(f"the {cell.config_name} driver measured "
                                   f"no {m['name']}")
            out["metrics"][m["name"]] = {"value": float(measured[m["name"]]),
                                         "unit": m["unit"]}
    checks = driver.check(state, res,
                          load_module("reference", cell.config_name, root),
                          cell.traffic["limits"], seed, log=log)
    # every unit of the window finished with finite numbers, and the
    # compared numbers are within their limits
    out["correct"] = res["failed"] == 0 and bool(checks) and all(
        c["value"] <= c["limit"] for c in checks.values())
    out["checks"] = checks
    return out


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse_args(argv)
    cell = find_cell(load_manifest(), args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"{have} available", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), t0)
    bad = forbidden_modules()
    if bad:
        print("portbench: modules of JAX or the JAX package are loaded: "
              + ", ".join(bad), file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0
