"""Builds ``csrc/*.cu`` into one shared library with a plain C interface.

``nvcc -gencode arch=compute_90a,code=sm_90a`` compiles every source of
``mvkpconv_tpu_torch/csrc/`` at first use into
``mvkpconv_tpu_torch/_build/libmvkp_<hash>.so``, where the hash covers the
sources and the flags, so a changed source rebuilds and an unchanged one is
loaded as it is. The library is loaded with ``ctypes``; every pointer and
the stream pass as ``c_void_p``. Nothing here runs on import: the wrappers
call :func:`library` only when they are handed a CUDA tensor. A missing
``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    # query, support, out, B, Nq, Ns, r2, k, stream
    "mvkp_radius_topk": (_P, _P, _P, _I, _I, _I, _F, _I, _P),
    # points, image_xyz, image_is_bf16, iu0, iv0, out,
    # B, N, V, H, W, window, k, stream
    "mvkp_pixel_topk": (_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # rows, rows_is_bf16, index, out, B, rows_per_b, Ns, C, stream
    "mvkp_segsum": (_P, _I, _P, _P, _I, _I, _I, _I, _P),
}

_LIB = None


def find_nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME", "") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def sources():
    return sorted(CSRC.glob("*.cu"))


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources if the library for their hash is missing. The
    compiler's output (``-Xptxas -v``: registers, spills, shared memory per
    kernel) and the build seconds go to the ``.log`` beside the library."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    out = BUILD_DIR / f"libmvkp_{_digest(srcs)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    out.with_suffix(".log").write_text(f"nvcc seconds: {seconds:.3f}\n{log}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check_launch(name: str, rc: int) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if rc != 0:
        msg = ""
        try:
            rt = ctypes.CDLL("libcudart.so")
            rt.cudaGetErrorString.restype = ctypes.c_char_p
            msg = rt.cudaGetErrorString(ctypes.c_int(rc)).decode()
        except OSError:
            pass
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc} {msg}")
