"""ctypes bindings for the native host ops (``csrc/host_ops.cpp``, a copy of
``native/host_ops.cpp`` that ``tests/test_torch_native.py`` pins byte for
byte): the voxel-barycentre subsample and the hash-grid 1-NN of
``mvkpconv_tpu/data/native.py``, with the same entry points.

``g++`` compiles the library at first use into
``mvkpconv_tpu_torch/_build/libhost_ops.so``, next to a marker that names
the CPU it was built for: a library without the marker, older than the
source, or built for another CPU (a copied directory) may use ISA
extensions this CPU lacks (``-march=native``), so it is rebuilt. Each entry
point returns None where
the library cannot be built or loaded (no ``g++``), and ``SphereDataset``
then takes its numpy fallbacks; :func:`available` says which ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG / "csrc" / "host_ops.cpp"
_BUILD_DIR = _PKG / "_build"
_LIB_PATH = _BUILD_DIR / "libhost_ops.so"
_MARKER = _BUILD_DIR / ".libhost_ops.built_here"
_lib = None
_tried = False


def _cpu() -> str:
    """What ``-march=native`` compiles for: the CPU's model and flags."""
    try:
        info = Path("/proc/cpuinfo").read_text().splitlines()
        lines = [ln for ln in info if ln.startswith(("model name", "flags"))][:2]
    except OSError:
        lines = [platform.processor()]
    return hashlib.sha256("\n".join([platform.machine(), *lines]).encode()).hexdigest()


def _build() -> None:
    """Compile to a name of this process's own, then move it into place, so
    processes that build at once never load a half-written library."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(
        ["g++", "-O3", "-march=native", "-shared", "-fPIC", str(_SRC), "-o", str(tmp)],
        check=True, capture_output=True,
    )
    os.replace(tmp, _LIB_PATH)
    _MARKER.write_text(_cpu())


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        stale = (
            not _LIB_PATH.exists()
            or _LIB_PATH.stat().st_mtime < _SRC.stat().st_mtime
            or not _MARKER.exists()
            or _MARKER.stat().st_mtime < _LIB_PATH.stat().st_mtime
            or _MARKER.read_text() != _cpu()
        )
        if stale:
            _build()
        lib = ctypes.CDLL(str(_LIB_PATH))
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.grid_subsample.restype = ctypes.c_int64
        lib.grid_subsample.argtypes = [
            f32p, ctypes.c_int64, f32p, ctypes.c_int64, i32p, ctypes.c_int32,
            ctypes.c_float, f32p, f32p, i32p, ctypes.c_int32, ctypes.c_int64,
        ]
        lib.nearest_neighbor_1nn.restype = None
        lib.nearest_neighbor_1nn.argtypes = [
            f32p, ctypes.c_int64, f32p, ctypes.c_int64, ctypes.c_float, i64p, f32p,
        ]
        _lib = lib
    except (OSError, subprocess.CalledProcessError, FileNotFoundError):
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def grid_subsample_native(
    points: np.ndarray,
    colors: np.ndarray,
    labels: np.ndarray,
    cell: float,
    num_classes: int = 20,
    ignore_label: int = -1,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """C++ voxel-barycenter subsample (voxels in first-seen order); None if
    the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, np.float32)
    cols = np.ascontiguousarray(colors, np.float32)
    labs = np.ascontiguousarray(labels, np.int32)
    n = len(pts)
    out_p = np.empty((n, 3), np.float32)
    out_f = np.empty((n, cols.shape[1]), np.float32)
    out_l = np.empty((n,), np.int32)
    count = lib.grid_subsample(
        _f32p(pts), n, _f32p(cols), cols.shape[1],
        labs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), num_classes,
        ctypes.c_float(cell), _f32p(out_p), _f32p(out_f),
        out_l.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), ignore_label, n,
    )
    count = min(count, n)
    return out_p[:count].copy(), out_f[:count].copy(), out_l[:count].copy()


def nearest_neighbor_1nn_native(
    queries: np.ndarray, supports: np.ndarray, cell: Optional[float] = None
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Exact hash-grid 1-NN; None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    q = np.ascontiguousarray(queries, np.float32)
    s = np.ascontiguousarray(supports, np.float32)
    if cell is None:
        # heuristic: cell ≈ average support spacing
        extent = s.max(0) - s.min(0) + 1e-6
        cell = float((extent.prod() / max(len(s), 1)) ** (1 / 3) + 1e-6)
    idx = np.empty(len(q), np.int64)
    d2 = np.empty(len(q), np.float32)
    lib.nearest_neighbor_1nn(
        _f32p(q), len(q), _f32p(s), len(s), ctypes.c_float(cell),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), _f32p(d2),
    )
    return idx, d2
