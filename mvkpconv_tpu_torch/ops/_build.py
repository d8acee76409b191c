"""Builds ``csrc/*.cu`` into one shared library with a plain C interface.

``nvcc -gencode arch=compute_90a,code=sm_90a`` compiles every source of
``mvkpconv_tpu_torch/csrc/`` at first use (one ``nvcc -c`` per source, all
started together, then one link) into
``mvkpconv_tpu_torch/_build/libmvkp_<hash>.so``, where the hash covers the
sources and the flags, so a changed source rebuilds and an unchanged one is
loaded as it is. The library is loaded with ``ctypes``; every pointer and
the stream pass as ``c_void_p``. Nothing here runs on import: the wrappers
call :func:`library` only when they are handed a CUDA tensor. A missing
``nvcc`` or a failed build raises. A measurement tool may ask for preprocessor
symbols (``library(defines=("MVKP_CYCLES",))``: the KPConv kernels' cycle
counters and the segment sum's counts) before anything else has loaded the library.
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    # query, support, out, packed, boxes, super_boxes, B, Nq, Ns, r2, k, stream
    "mvkp_radius_topk": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    # points, image_xyz, image_is_bf16, iu0, iv0, out,
    # B, N, V, H, W, window, k, stream
    "mvkp_pixel_topk": (_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # B, rows_per_b, Ns, C, out[3] (plan ints, plan scratch ints, sum scratch words)
    "mvkp_segsum_sizes": (_I, _I, _I, _I, _P),
    # index, plan, scratch, B, rows_per_b, Ns, stream
    "mvkp_segsum_plan": (_P, _P, _P, _I, _I, _I, _P),
    # rows, rows_is_bf16, round_bf16, plan, out, scratch, B, rows_per_b, Ns, C, stream
    "mvkp_segsum_sum": (_P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _P),
    # rel, x, x_is_bf16, ldx, kp, W, out, Q, K, M, Cin, Cout, extent, stream
    "mvkp_kpconv_fwd": (_P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    # queries per block (0: planned)
    "mvkp_kpconv_fwd_tune": (_I,),
    # queries per block of bwd_x, 16 x the queries per warp of wf (0: planned)
    "mvkp_kpconv_bwd_tune": (_I,),
    # rel, g, kp, W, dx, dx_is_bf16, Q, K, M, Cin, Cout, extent, stream
    "mvkp_kpconv_bwd_x": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    # rel, x, x_is_bf16, ldx, kp, wf, Q, K, M, Cin, extent, stream
    "mvkp_kpconv_wf": (_P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _F, _P),
    # out[6], out[7], out[4], out[6] on the host; only in a build with MVKP_CYCLES
    "mvkp_kpconv_fwd_cycles": (_P,),
    "mvkp_kpconv_bwd_x_cycles": (_P,),
    "mvkp_kpconv_wf_cycles": (_P,),
    "mvkp_segsum_counts": (_P,),
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


def _digest(srcs, flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build(defines=()) -> Path:
    """Compile the sources, with ``-D`` for each of ``defines``, if the library
    for their hash is missing. The compiler's output (``-Xptxas -v``:
    registers, spills, shared memory per kernel) and the build seconds go to
    the ``.log`` beside the library."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    out = BUILD_DIR / f"libmvkp_{_digest(srcs, flags)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    stem = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{stem}.{s.stem}.o" for s in srcs]
    t0 = time.perf_counter()
    procs = [
        (s, subprocess.Popen([nvcc, *flags, "-c", "-o", str(o), str(s)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for s, o in zip(srcs, objs)
    ]
    logs, failed = [], []
    for s, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"==> {s.name} ({time.perf_counter() - t0:.3f} s)\n{text}")
        if proc.returncode != 0:
            failed.append(s.name)
    tmp = BUILD_DIR / f"{stem}.tmp"
    if not failed:
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        logs.append(f"==> link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append("link")
    seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink(missing_ok=True)
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    out.with_suffix(".log").write_text(f"nvcc seconds: {seconds:.3f}\n{log}")
    os.replace(tmp, out)
    return out


def library(defines=()) -> ctypes.CDLL:
    """The loaded kernel library, built on the first call, which alone decides
    the ``defines``."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build(defines)))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name, None)  # the cycle counters exist only with their define
            if fn is not None:
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
