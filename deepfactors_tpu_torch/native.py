"""ctypes bindings for the native C++ runtime (``native/*.cpp``).

PyTorch port of ``deepfactors_tpu/native.py``, with a build of its own:

  - ``NativeScheduler``: the coarse-to-fine factor work scheduler
    (native/scheduler.cpp; the reference's sources/core/mapping/{work,
    work_manager,df_work}), standard library only;
  - ``NativeLoader`` and ``load_depth_png``: the threaded-prefetch frame
    decoder (native/dataset_loader.cpp; libpng, libjpeg, zlib).

The two sources build with ``g++`` at first use, each into its own shared
library under ``build/native/`` at the root of the checkout, keyed by a
digest of the source and flags, so the scheduler never depends on the
image libraries. A failed build raises with the compiler's output; nothing
here falls back to another implementation. The JAX package's own prebuilt
library is never loaded.
"""
from __future__ import annotations

import ctypes as C
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
NATIVE_SRC = ROOT / "native"
CXXFLAGS = ("-O2", "-fPIC", "-Wall", "-std=c++17", "-shared")
# source -> link flags (native/Makefile's, split by what each source uses)
LIBS = {"scheduler.cpp": (),
        "dataset_loader.cpp": ("-lpng", "-ljpeg", "-lz", "-lpthread")}

_lock = threading.Lock()
_libs: dict = {}

PHOTO, REP, GEO = 0, 1, 2


def build_dir() -> Path:
    return ROOT / "build" / "native"


def lib_path(source: str) -> Path:
    h = hashlib.sha256(" ".join(CXXFLAGS + LIBS[source]).encode())
    h.update((NATIVE_SRC / source).read_bytes())
    return build_dir() / f"lib{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(source: str) -> Path:
    """Compile ``native/<source>`` unless its library is there; raises
    RuntimeError with g++'s output when the build fails."""
    lib = lib_path(source)
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = ["g++", *CXXFLAGS, "-o", str(tmp), str(NATIVE_SRC / source),
           *LIBS[source]]
    p = subprocess.run(cmd, capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"native build of {source} failed "
                           f"({' '.join(cmd)}):\n{p.stdout}{p.stderr}")
    os.replace(tmp, lib)
    return lib


def _load(source: str):
    with _lock:
        if source not in _libs:
            lib = C.CDLL(str(build(source)))
            _SIGNATURES[source](lib)
            _libs[source] = lib
        return _libs[source]


def _sched_signatures(lib):
    lib.df_sched_new.restype = C.c_void_p
    lib.df_sched_new.argtypes = [C.c_int, C.c_int, C.c_int]
    lib.df_sched_free.argtypes = [C.c_void_p]
    lib.df_sched_add_work.restype = C.c_int64
    lib.df_sched_add_work.argtypes = [
        C.c_void_p, C.c_int32, C.c_int32, C.c_int32, C.c_int32,
        C.POINTER(C.c_int32), C.c_int32, C.c_int32, C.c_int64,
    ]
    lib.df_sched_replace_pair.argtypes = [C.c_void_p, C.c_int32, C.c_int32,
                                          C.c_int32]
    lib.df_sched_bookkeeping.argtypes = [C.c_void_p]
    lib.df_sched_budget.restype = C.c_int32
    lib.df_sched_budget.argtypes = [C.c_void_p]
    lib.df_sched_update.restype = C.c_int32
    lib.df_sched_update.argtypes = [C.c_void_p, C.c_int32, C.c_int32]
    lib.df_sched_has_work.restype = C.c_int32
    lib.df_sched_has_work.argtypes = [C.c_void_p]
    lib.df_sched_error.restype = C.c_int32
    lib.df_sched_error.argtypes = [C.c_void_p]
    lib.df_sched_erase_frame.argtypes = [C.c_void_p, C.c_int32]
    lib.df_sched_erase_keyframe.argtypes = [C.c_void_p, C.c_int32]
    lib.df_sched_pool.argtypes = [
        C.c_void_p, C.c_int32, C.POINTER(C.c_int32), C.POINTER(C.c_int32),
        C.POINTER(C.c_int32), C.POINTER(C.c_uint8), C.POINTER(C.c_uint8),
    ]
    lib.df_sched_work_slot.restype = C.c_int32
    lib.df_sched_work_slot.argtypes = [C.c_void_p, C.c_int64]
    lib.df_sched_num_works.restype = C.c_int32
    lib.df_sched_num_works.argtypes = [C.c_void_p]
    lib.df_sched_fused_sig.restype = C.c_int32
    lib.df_sched_fused_sig.argtypes = [C.c_void_p, C.POINTER(C.c_int32)]
    lib.df_sched_descent_slots.argtypes = [C.c_void_p,
                                           C.POINTER(C.c_uint8)]


def _loader_signatures(lib):
    lib.df_loader_new.restype = C.c_void_p
    lib.df_loader_new.argtypes = [C.c_char_p, C.POINTER(C.c_double),
                                  C.c_int, C.c_int, C.c_int]
    lib.df_loader_free.argtypes = [C.c_void_p]
    lib.df_loader_native_size.restype = C.c_int
    lib.df_loader_native_size.argtypes = [C.c_void_p, C.POINTER(C.c_int),
                                          C.POINTER(C.c_int)]
    lib.df_loader_start.argtypes = [C.c_void_p, C.c_int]
    lib.df_loader_next.restype = C.c_int
    lib.df_loader_next.argtypes = [C.c_void_p, C.POINTER(C.c_float),
                                   C.POINTER(C.c_double)]
    lib.df_load_depth_png.restype = C.c_int
    lib.df_load_depth_png.argtypes = [C.c_char_p, C.c_float,
                                      C.POINTER(C.c_float), C.c_int,
                                      C.POINTER(C.c_int), C.POINTER(C.c_int)]


_SIGNATURES = {"scheduler.cpp": _sched_signatures,
               "dataset_loader.cpp": _loader_signatures}


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(C.POINTER(ctype))


class NativeScheduler:
    """C++ work scheduler handle (see native/scheduler.cpp)."""

    def __init__(self, photo_cap: int, rep_cap: int, geo_cap: int):
        self._lib = _load("scheduler.cpp")
        self._h = self._lib.df_sched_new(photo_cap, rep_cap, geo_cap)
        self._caps = (photo_cap, rep_cap, geo_cap)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.df_sched_free(self._h)
            self._h = None

    def add_work(self, kind: int, src: int, dst: int, dst_is_frame: bool,
                 iters, remove_after: bool = False, parent: int = 0) -> int:
        arr = (C.c_int32 * len(iters))(*iters)
        return self._lib.df_sched_add_work(
            self._h, kind, src, dst, int(dst_is_frame), arr, len(iters),
            int(remove_after), parent)

    def replace_pair(self, kind: int, src: int, dst: int):
        self._lib.df_sched_replace_pair(self._h, kind, src, dst)

    def bookkeeping(self):
        self._lib.df_sched_bookkeeping(self._h)
        if self._lib.df_sched_error(self._h):
            raise RuntimeError("native scheduler: factor pool exhausted")

    def budget(self) -> int:
        return int(self._lib.df_sched_budget(self._h))

    def update(self, iters_done: int, converged: bool) -> int:
        return int(self._lib.df_sched_update(self._h, iters_done,
                                             int(converged)))

    def has_work(self) -> bool:
        return bool(self._lib.df_sched_has_work(self._h))

    def num_works(self) -> int:
        return int(self._lib.df_sched_num_works(self._h))

    def erase_frame(self, slot: int):
        self._lib.df_sched_erase_frame(self._h, slot)

    def erase_keyframe(self, slot: int):
        self._lib.df_sched_erase_keyframe(self._h, slot)

    def work_slot(self, work_id: int) -> int:
        return int(self._lib.df_sched_work_slot(self._h, work_id))

    def fused_sig(self):
        """Shared-schedule signature for the single-dispatch C2F descent
        (see df_sched_fused_sig): (active_level, iters, orig_iters) or
        None."""
        out = (C.c_int32 * 18)()
        if not self._lib.df_sched_fused_sig(self._h, out):
            return None
        n = out[1]
        return (int(out[0]), tuple(out[2:2 + n]),
                tuple(out[2 + 8:2 + 8 + n]))

    def descent_slots(self) -> np.ndarray:
        buf = np.zeros(self._caps[0], np.uint8)
        self._lib.df_sched_descent_slots(self._h, _ptr(buf, C.c_uint8))
        return buf.astype(bool)

    def pool(self, kind: int):
        """(src, dst, level, dst_is_frame, active) host arrays of a pool."""
        cap = self._caps[kind]
        src, dst, level = (np.zeros(cap, np.int32) for _ in range(3))
        isf, act = np.zeros(cap, np.uint8), np.zeros(cap, np.uint8)
        self._lib.df_sched_pool(
            self._h, kind, _ptr(src, C.c_int32), _ptr(dst, C.c_int32),
            _ptr(level, C.c_int32), _ptr(isf, C.c_uint8),
            _ptr(act, C.c_uint8))
        return src, dst, level, isf.astype(bool), act.astype(bool)


class NativeLoader:
    """Threaded-prefetch frame decoder (see native/dataset_loader.cpp):
    iterates (timestamp, [out_h, out_w] float32 gray in [0, 1])."""

    def __init__(self, files, timestamps=None, out_w: int = 0,
                 out_h: int = 0, n_threads: int = 2):
        self._lib = _load("dataset_loader.cpp")
        blob = "\n".join(files).encode()
        ts = None
        if timestamps is not None:
            ts = (C.c_double * len(files))(*timestamps)
        self._h = self._lib.df_loader_new(blob, ts, len(files), out_w, out_h)
        w, h = C.c_int(), C.c_int()
        self._lib.df_loader_native_size(self._h, C.byref(w), C.byref(h))
        self.native_size = (w.value, h.value)
        self.out_w = out_w if out_w else w.value
        self.out_h = out_h if out_h else h.value
        self._lib.df_loader_start(self._h, n_threads)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.df_loader_free(self._h)
            self._h = None

    def __iter__(self):
        return self

    def __next__(self):
        img = np.empty((self.out_h, self.out_w), np.float32)
        ts = C.c_double()
        rc = self._lib.df_loader_next(self._h, _ptr(img, C.c_float),
                                      C.byref(ts))
        if rc == 1:
            raise StopIteration
        if rc < 0:
            raise IOError("frame decode failed")
        return ts.value, img


def load_depth_png(path: str, scale: float, max_hw=(1024, 2048)):
    """A 16-bit depth PNG as float32 (value x scale), decoded natively."""
    lib = _load("dataset_loader.cpp")
    buf = np.empty(max_hw[0] * max_hw[1], np.float32)
    w, h = C.c_int(), C.c_int()
    rc = lib.df_load_depth_png(path.encode(), scale, _ptr(buf, C.c_float),
                               buf.size, C.byref(w), C.byref(h))
    if rc != 0:
        raise IOError(f"depth png load failed ({rc}): {path}")
    return buf[: w.value * h.value].reshape(h.value, w.value).copy()
