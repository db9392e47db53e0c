"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole: ``deepfactors_tpu_torch`` begins with
``deepfactors_tpu``), the plain references import nothing of the program,
and a run refuses where it cannot measure."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

PB = harness.ROOT / "portbench"
PROGRAM = "deepfactors_tpu_torch"
STDLIB_OK = {"__future__", "argparse", "ast", "collections", "contextlib",
             "importlib", "json", "math", "os", "pickle", "re", "sys",
             "time", "typing", "pathlib"}


def _imports(path: Path):
    """Top-level names a module imports (relative imports as '.')."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            yield "." if node.level else node.module.split(".")[0]


def _sources():
    return sorted(p for p in PB.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(PB)))
def test_no_source_imports_jax(path):
    names = set(_imports(path))
    assert not names & set(harness.FORBIDDEN), names


@pytest.mark.parametrize("path", sorted((PB / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    names = set(_imports(path))
    assert PROGRAM not in names and "portbench" not in names
    assert names <= {".", "torch", "numpy"} | STDLIB_OK, names


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("deepfactors_tpu_torch", "deepfactors_tpu_torchx",
                 "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_modules() == []
    for name in ("deepfactors_tpu", "deepfactors_tpu.ops", "jax.numpy",
                 "jaxlib", "flax"):
        monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_modules() == sorted(
        ["deepfactors_tpu", "deepfactors_tpu.ops", "jax.numpy", "jaxlib",
         "flax"])


_PROBE = r"""
import sys
class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "deepfactors_tpu"):
            raise ImportError("blocked import: " + name)
        return None
sys.meta_path.insert(0, Blocker())
sys.path.insert(0, sys.argv[1])
from portbench import harness
from portbench.tests import tiny
for cell in ("largemap.k128", "train.b64"):
    out = tiny.run(cell, trace=True, seconds=0.2)
    assert out["correct"], out
for d in ("largemap", "train"):
    harness.load_module("drivers", d)
for m in harness.load_manifest()["per_layer"]:
    harness.load_module("metrics", m["name"])
import portbench.calibrate
assert harness.forbidden_modules() == [], harness.forbidden_modules()
print("clean")
"""


def test_a_run_loads_nothing_of_jax():
    r = subprocess.run([sys.executable, "-c", _PROBE, str(harness.ROOT)],
                       cwd=harness.ROOT, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("clean")


def _run(root, workload="largemap.k128"):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=root, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=""))


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = _run(harness.ROOT)
    assert r.returncode != 0 and r.stdout == ""
    assert "CUDA" in r.stderr


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path)
    assert r.returncode != 0 and r.stdout == ""


def test_unknown_workload_refused():
    r = _run(harness.ROOT, "nosuch.cell")
    assert r.returncode != 0 and r.stdout == ""
    with pytest.raises(KeyError):
        harness.find_cell(harness.load_manifest(), "nosuch.cell")
    with pytest.raises(ValueError):
        harness.find_cell(harness.load_manifest(), "../etc")
    assert json.loads((harness.ROOT / "BENCHMARK.json").read_text())
