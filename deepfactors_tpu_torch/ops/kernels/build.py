"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface, and
loaded with ``ctypes``. The build happens at first use (never at import:
the CPU tests import every module), all sources compile in parallel, and
the libraries land in a git-ignored directory keyed by a digest of the
sources and flags, so an edited source is rebuilt and an unchanged one is
reused within a checkout.

Build directory: ``build/kernels`` at the root of the checkout.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ...utils.timing import span

CSRC = Path(__file__).resolve().parents[2] / "csrc"
SOURCES = ("se3_gram.cu", "sfm_gram.cu", "sfm_error.cu", "dense_warp.cu",
           "jacobian_stack.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no implicit FMA contraction: each expression rounds op by op like the
    # plain PyTorch twin, so the two agree per pixel; the Gram accumulation
    # uses explicit fmaf()
    "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict = {}
build_log: dict = {}   # source -> {"seconds": s, "ptxas": text}


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc"
        if cand and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _digest(source: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(source: str) -> Path:
    return build_dir() / f"{Path(source).stem}-{_digest(source)}.so"


def build_all(ptxas_verbose: bool = False) -> float:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all started together, in a ``kernels.build`` span. Returns the
    wall seconds; raises with the compiler's output if any build fails."""
    t0 = time.perf_counter()
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [src for src in SOURCES
            if ptxas_verbose or not _lib_path(src).exists()]
    if todo:
        with span("kernels.build"):
            _compile(todo, ptxas_verbose)
    return time.perf_counter() - t0


def _compile(sources, ptxas_verbose: bool):
    procs = []
    for src in sources:
        lib = _lib_path(src)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        if ptxas_verbose:
            cmd.insert(-3, "-Xptxas=-v")
        procs.append((src, lib, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    errors = []
    for src, lib, tmp, t_start, proc in procs:
        text, _ = proc.communicate()
        build_log[src] = {"seconds": time.perf_counter() - t_start,
                          "ptxas": text}
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {src}:\n{text}")
            continue
        os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))


def library(source: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<source>``, built on first use."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            path = _lib_path(source)
            if not path.exists():
                build_all()
            lib = _libs[source] = ctypes.CDLL(str(path))
        return lib
