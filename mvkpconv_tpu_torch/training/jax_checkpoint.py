"""The JAX package's checkpoints (``mvkpconv_tpu/training/checkpoint.py``):
a reader of their flax msgpack files, and the restore of a run directory
from them into a model of the port.

A JAX checkpoint is ``flax.serialization.to_bytes`` of a ``TrainState``
(``mvkpconv_tpu/training/steps.py:37-43``): a msgpack map of ``step``,
``params``, ``batch_stats`` and ``opt_state``. The port decodes msgpack
itself (:func:`unpackb`, the standard library only) and flax's extension
types on top of it: code 1 an ndarray, a nested msgpack of (shape, dtype
name, C-order buffer); code 2 a Python complex, a nested (real, imag); code
3 a numpy scalar, an ndarray of shape (). A ``bfloat16`` buffer becomes a
``torch.bfloat16`` tensor (numpy has no such dtype without ml_dtypes); every
other array a numpy array. Arrays over 2³⁰ bytes, which flax writes as
``__msgpack_chunked_array__`` maps of chunks, are put back together.

:func:`load_jax_checkpoint` fills a model from ``params`` and
``batch_stats`` through ``convert.load_jax_variables``, which raises on any
leaf it does not use and on any tensor it does not set; ``opt_state``
(optax's momentum) is not read. :func:`restore_run` is what the CLIs call:
the port's ``.pt`` checkpoints where the directory holds any, else the JAX
package's ``.msgpack`` ones.
"""

from __future__ import annotations

import struct
from collections import namedtuple
from pathlib import Path
from typing import Any, Optional, Tuple

import numpy as np
import torch

ExtType = namedtuple("ExtType", "code data")
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3

# first byte → (struct format of the length or value, kind)
_FIXED = {
    0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
    0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
    0xCA: (">f", "value"), 0xCB: (">d", "value"),
    0xCC: (">B", "value"), 0xCD: (">H", "value"), 0xCE: (">I", "value"), 0xCF: (">Q", "value"),
    0xD0: (">b", "value"), 0xD1: (">h", "value"), 0xD2: (">i", "value"), 0xD3: (">q", "value"),
    0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
    0xDC: (">H", "array"), 0xDD: (">I", "array"),
    0xDE: (">H", "map"), 0xDF: (">I", "map"),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, data: bytes, ext_hook):
        self.data, self.pos, self.ext_hook = memoryview(data), 0, ext_hook

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack: truncated at byte {self.pos} (needs {n} more)")
        out = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def ext(self, size: int):
        code = self.unpack(">b")
        data = self.take(size)
        return self.ext_hook(code, data) if self.ext_hook else ExtType(code, data)

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b not in _FIXED:
            raise ValueError(f"msgpack: unknown type byte 0x{b:02x} at {self.pos - 1}")
        fmt, kind = _FIXED[b]
        n = self.unpack(fmt)
        if kind == "value":
            return n
        if kind == "bin":
            return self.take(n)
        if kind == "str":
            return self.take(n).decode("utf-8")
        if kind == "ext":
            return self.ext(n)
        if kind == "array":
            return [self.value() for _ in range(n)]
        return self.map(n)

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def unpackb(data: bytes, ext_hook=None) -> Any:
    """Decode one msgpack object as ``msgpack.unpackb(data, ext_hook=...)``
    does with its defaults: arrays as lists, str as ``str``, bin as
    ``bytes``, an extension as ``ext_hook(code, data)`` or an
    ``ExtType(code, data)``. Raises on trailing bytes."""
    reader = _Reader(data, ext_hook)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"msgpack: {len(reader.data) - reader.pos} bytes after the object")
    return out


def _ndarray(data: bytes):
    shape, dtype_name, buffer = unpackb(data)
    if dtype_name == "bfloat16":
        # numpy has no bfloat16: the uint16 bits, read as torch's (frombuffer
        # refuses an empty buffer)
        if not buffer:
            return torch.empty(shape, dtype=torch.bfloat16)
        return torch.frombuffer(bytearray(buffer), dtype=torch.bfloat16).reshape(shape)
    try:
        dtype = np.dtype(dtype_name)
    except TypeError as err:
        raise ValueError(f"checkpoint leaf of dtype {dtype_name!r}, which numpy cannot read") from err
    return np.frombuffer(buffer, dtype=dtype).reshape(shape).copy()


def flax_ext_hook(code: int, data: bytes):
    """flax ``serialization._msgpack_ext_unpack``."""
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_COMPLEX:
        real, imag = unpackb(data)
        return complex(real, imag)
    if code == EXT_NPSCALAR:
        arr = _ndarray(data)
        return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
    return ExtType(code, data)


def _unchunk(tree):
    """flax's chunked arrays (``{CHUNKED: True, 'shape': {'0': ..}, 'chunks':
    {'0': .., ..}}``) back to arrays, anywhere in a tree of dicts."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if any(isinstance(c, torch.Tensor) for c in chunks):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_msgpack_state(path) -> Any:
    """A flax ``msgpack_serialize`` file as a tree of dicts of arrays."""
    return _unchunk(unpackb(Path(path).read_bytes(), ext_hook=flax_ext_hook))


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):  # bfloat16 leaves: f32 holds them exactly
        return tree.float().numpy()
    return np.asarray(tree)


def load_jax_checkpoint(model: torch.nn.Module, path) -> int:
    """Fill ``model`` from a JAX ``TrainState`` checkpoint's ``params`` and
    ``batch_stats``; returns its ``step``. Raises where a leaf of the file or
    a tensor of the model is left over."""
    from mvkpconv_tpu_torch.convert import load_jax_variables

    state = read_msgpack_state(path)
    missing = {"step", "params"} - set(state)
    if missing:
        raise ValueError(f"{path}: not a JAX TrainState checkpoint (no {sorted(missing)})")
    load_jax_variables(model, {"params": _numpy_tree(state["params"]),
                               "batch_stats": _numpy_tree(state.get("batch_stats", {}))})
    return int(np.asarray(state["step"]))


def jax_checkpoint_path(ckpt_dir, best: bool = False) -> Optional[Path]:
    """The JAX package's checkpoint to restore in ``ckpt_dir``, where it holds
    no ``.pt`` of the port: ``model_best.msgpack`` with ``best``; else the one
    ``last_checkpoint`` names, else the newest ``ckpt_*.msgpack``; None where
    there is none."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.is_dir() or any(ckpt_dir.glob("*.pt")):
        return None
    if best:
        p = ckpt_dir / "model_best.msgpack"
        return p if p.exists() else None
    tag = ckpt_dir / "last_checkpoint"
    if tag.exists():
        p = ckpt_dir / tag.read_text().strip()
        if p.suffix == ".msgpack" and p.exists():
            return p
    ckpts = sorted(ckpt_dir.glob("ckpt_*.msgpack"))
    return ckpts[-1] if ckpts else None


def restore_run(model: torch.nn.Module, ckpt_dir, best: bool = False) -> Optional[Tuple[int, Path]]:
    """Fill ``model`` from a run's ``checkpoints/``: the port's latest ``.pt``
    (``model_best.pt`` with ``best``), else the JAX package's ``.msgpack``
    (:func:`jax_checkpoint_path`). Returns (step, file), or None where the
    directory holds neither."""
    from mvkpconv_tpu_torch.training.checkpoint import BEST, Checkpointer

    ck = Checkpointer(ckpt_dir)
    path = jax_checkpoint_path(ck.dir, best)
    if path is not None:
        return load_jax_checkpoint(model, path), path
    if best:
        path = ck.dir / BEST if (ck.dir / BEST).exists() else None
    else:
        path = ck.latest_path()
    if path is None or path.suffix != ".pt":
        return None
    restored = ck.restore(path)
    model.load_state_dict(restored["model"])
    return restored["step"], path
