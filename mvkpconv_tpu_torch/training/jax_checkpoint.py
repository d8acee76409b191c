"""The JAX package's checkpoints (``mvkpconv_tpu/training/checkpoint.py``):
a reader and a writer of their flax msgpack files, the restore of a run
directory from them into a model of the port, and the resume of a JAX run
(optimizer state included) in the port's ``Trainer``.

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
:func:`packb` and :func:`msgpack_serialize` are the inverse: the bytes
``flax.serialization.to_bytes`` writes for the same tree of dicts and numpy
arrays.

:func:`load_jax_checkpoint` fills a model from ``params`` and
``batch_stats`` through ``convert.load_jax_variables``, which raises on any
leaf it does not use and on any tensor it does not set.
:func:`load_jax_train_state` also fills an optimizer of the port from
``opt_state``: optax's ``multi_transform({train, deform, frozen})``
(``mvkpconv_tpu/training/optim.py``), whose ``train`` and ``deform``
states are ``(clip: {}, (trace: {trace: momentum tree}, schedule: {count}))``
with ``{}`` at each leaf the label masks out, and ``frozen`` ``{}``. Each
momentum leaf becomes the ``momentum_buffer`` of its parameter through the
layout change of that parameter (``convert.leaf_map``) and each ``count``
the ``count`` of the port's parameter group of that label; any leaf left
over raises. optax's ``trace`` (buf ← g + μ·buf from zeros) and torch's SGD
without dampening (buf = g at the first step, then μ·buf + g) are the same
recursion. :func:`write_jax_checkpoint` writes a port's model and
optimizer in that layout. :func:`restore_run` is what the CLIs call: the
port's ``.pt`` checkpoints where the directory holds any, else the JAX
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


# the types msgpack packs under strict_types; any other goes to ``default``
_STRICT = (type(None), bool, int, float, str, bytes, bytearray, list, dict, ExtType)


def _pack_into(out: list, obj, default) -> None:
    if default is not None and type(obj) not in _STRICT:  # numpy scalars too
        obj = default(obj)
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        if 0 <= obj <= 0x7F or -32 <= obj < 0:
            out.append(struct.pack(">b" if obj < 0 else ">B", obj))
        elif obj > 0:
            for code, fmt, top in ((0xCC, ">B", 2**8), (0xCD, ">H", 2**16), (0xCE, ">I", 2**32),
                                   (0xCF, ">Q", 2**64)):
                if obj < top:
                    out.append(bytes([code]) + struct.pack(fmt, obj))
                    break
            else:
                raise OverflowError(f"msgpack: {obj} does not fit 64 bits")
        else:
            for code, fmt, low in ((0xD0, ">b", -2**7), (0xD1, ">h", -2**15), (0xD2, ">i", -2**31),
                                   (0xD3, ">q", -2**63)):
                if obj >= low:
                    out.append(bytes([code]) + struct.pack(fmt, obj))
                    break
            else:
                raise OverflowError(f"msgpack: {obj} does not fit 64 bits")
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _head(out, len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray)):
        _head(out, len(obj), None, -1, (0xC4, 0xC5, 0xC6))
        out.append(bytes(obj))
    elif isinstance(obj, ExtType):
        n = len(obj.data)
        fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fix:
            out.append(bytes([fix[n]]))
        else:
            _head(out, n, None, -1, (0xC7, 0xC8, 0xC9))
        out.append(struct.pack(">b", obj.code) + obj.data)
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for v in obj:
            _pack_into(out, v, default)
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack_into(out, k, default)
            _pack_into(out, v, default)
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def _head(out: list, n: int, fix, fix_max: int, codes) -> None:
    """The header of a str, bin, array, map or ext of ``n`` entries: its fix
    form up to ``fix_max``, else the 8-, 16- or 32-bit length form (a
    ``None`` code: no such form)."""
    if n <= fix_max:
        out.append(bytes([fix | n]))
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (2**8, 2**16, 2**32)):
        if code is not None and n < top:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise OverflowError(f"msgpack: {n} entries")


def packb(obj, default=None) -> bytes:
    """Encode as ``msgpack.packb(obj, default=..., strict_types=True)``
    does: ``default`` maps any object whose type is not exactly one msgpack
    packs to one it does. Without ``default`` tuples are arrays, as the
    plain ``msgpack.packb`` makes them."""
    out: list = []
    _pack_into(out, obj, default)
    return b"".join(out)


def flax_ext_pack(x):
    """flax ``serialization._msgpack_ext_pack`` of a numpy array or scalar."""
    if isinstance(x, np.ndarray):
        return ExtType(EXT_NDARRAY, packb((list(x.shape), x.dtype.name, x.tobytes("C"))))
    if isinstance(x, np.generic):
        arr = np.asarray(x)
        return ExtType(EXT_NPSCALAR, packb((list(arr.shape), arr.dtype.name, arr.tobytes("C"))))
    raise TypeError(f"msgpack: cannot pack {type(x).__name__}")


def msgpack_serialize(tree) -> bytes:
    """The bytes ``flax.serialization.to_bytes(tree)`` writes for a tree of
    dicts of numpy arrays (no array over flax's 2³⁰-byte chunk): the dicts
    in their own order, as ``msgpack_serialize(tree, in_place=True)``."""
    def check(t):
        if isinstance(t, dict):
            for v in t.values():
                check(v)
        elif isinstance(t, np.ndarray) and t.nbytes > 2**30:
            raise ValueError(f"an array of {t.nbytes} bytes: flax would chunk it")

    check(tree)
    return packb(tree, default=flax_ext_pack)


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


# ---------------------------------------------------------------- optimizer state

OPT_LABELS = ("train", "deform", "frozen")


def _flat_leaves(tree, prefix=""):
    """'a/b' → array for each array leaf; the ``{}`` leaves (optax's masked
    nodes) are skipped."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat_leaves(v, key))
        else:
            out[key] = v
    return out


def _group_labels(model, optimizer):
    """The label (``train`` or ``deform``, ``training/optim.py``) of each of
    the optimizer's parameter groups, from its parameters' names."""
    from mvkpconv_tpu_torch.training.optim import _label

    names = {id(p): n for n, p in model.named_parameters()}
    labels = []
    for group in optimizer.param_groups:
        found = {_label(names[id(p)], ()) for p in group["params"]}
        if len(found) != 1:
            raise ValueError(f"a parameter group of labels {sorted(found)}")
        labels.append(found.pop())
    return labels


def _param_leaves(model):
    """flax 'params' key → (torch parameter, (to_flax, to_torch) layout
    changes)."""
    from mvkpconv_tpu_torch.convert import leaf_map

    params = dict(model.named_parameters())
    return {fkey: (params[key], fns) for key, col, fkey, fns in leaf_map(model)
            if col == "params"}


def _expect(tree, keys, what):
    """Raise unless ``tree`` is a dict of exactly ``keys``."""
    if not isinstance(tree, dict) or set(tree) != set(keys):
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"{what}: {got}, expected {sorted(keys)}")


@torch.no_grad()
def load_jax_opt_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer, opt_state) -> None:
    """Set ``optimizer``'s momentum buffers and schedule counts from a JAX
    ``opt_state`` tree (as :func:`read_msgpack_state` gives it). Raises where
    a label, a leaf or a parameter is left over."""
    _expect(opt_state, ("inner_states",), "opt_state")
    inner = opt_state["inner_states"]
    if not set(inner) <= set(OPT_LABELS):
        raise ValueError(f"opt_state/inner_states: unknown labels {sorted(set(inner) - set(OPT_LABELS))}")
    if "frozen" in inner:
        _expect(inner["frozen"], ("inner_state",), "opt_state/inner_states/frozen")
        _expect(inner["frozen"]["inner_state"], (), "opt_state/inner_states/frozen/inner_state")
    leaves = _param_leaves(model)
    labels = _group_labels(model, optimizer)
    for label in ("train", "deform"):
        groups = [g for g, lab in zip(optimizer.param_groups, labels) if lab == label]
        if label not in inner:
            if groups:
                raise ValueError(f"opt_state has no {label!r} state for the port's {label!r} group")
            continue
        where = f"opt_state/inner_states/{label}/inner_state"
        _expect(inner[label], ("inner_state",), f"opt_state/inner_states/{label}")
        st = inner[label]["inner_state"]
        _expect(st, ("0", "1"), where)
        _expect(st["0"], (), where + "/0")
        _expect(st["1"], ("0", "1"), where + "/1")
        _expect(st["1"]["0"], ("trace",), where + "/1/0")
        _expect(st["1"]["1"], ("count",), where + "/1/1")
        trace = _flat_leaves(st["1"]["0"]["trace"])
        count = int(np.asarray(st["1"]["1"]["count"]))
        mine = {id(p) for g in groups for p in g["params"]}
        for fkey, arr in trace.items():
            if fkey not in leaves:
                raise ValueError(f"{where}: momentum of {fkey!r}, which the model does not have")
            p, (_, to_torch) = leaves[fkey]
            if id(p) not in mine:
                raise ValueError(f"{where}: momentum of {fkey!r}, which the port does not "
                                 f"train in its {label!r} group")
            arr = np.ascontiguousarray(to_torch(np.asarray(arr, dtype=np.float32)))
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{fkey}: momentum shape {arr.shape} != {tuple(p.shape)}")
            optimizer.state[p]["momentum_buffer"] = torch.tensor(arr, dtype=p.dtype, device=p.device)
            mine.discard(id(p))
        if mine:
            names = {id(p): n for n, p in model.named_parameters()}
            raise ValueError(f"{where}: no momentum for {sorted(names[i] for i in mine)[:5]}")
        for g in groups:
            g["count"] = count


def load_jax_train_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer, path) -> int:
    """Fill ``model`` and ``optimizer`` from a JAX ``TrainState`` checkpoint;
    returns its ``step``."""
    from mvkpconv_tpu_torch.convert import load_jax_variables

    state = read_msgpack_state(path)
    _expect(state, ("step", "params", "batch_stats", "opt_state"), f"{path}: not a JAX TrainState")
    load_jax_variables(model, {"params": _numpy_tree(state["params"]),
                               "batch_stats": _numpy_tree(state["batch_stats"])})
    load_jax_opt_state(model, optimizer, state["opt_state"])
    return int(np.asarray(state["step"]))


@torch.no_grad()
def jax_opt_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> dict:
    """The inverse of :func:`load_jax_opt_state`: optax's state tree of
    ``optimizer`` (momentum zero where a parameter has none yet; the
    ``deform`` count that of ``train`` where the port has no deform group)."""
    from mvkpconv_tpu_torch.convert import nest

    leaves = _param_leaves(model)
    labels = _group_labels(model, optimizer)
    owner = {id(p): (lab, g) for g, lab in zip(optimizer.param_groups, labels) for p in g["params"]}
    counts = {lab: g["count"] for g, lab in zip(optimizer.param_groups, labels)}
    inner = {}
    for label in ("train", "deform"):
        flat = {}
        for fkey, (p, (to_flax, _)) in sorted(leaves.items()):
            if owner.get(id(p), (None,))[0] != label:
                flat[fkey] = {}
                continue
            buf = optimizer.state.get(p, {}).get("momentum_buffer")
            buf = torch.zeros_like(p) if buf is None else buf
            flat[fkey] = np.ascontiguousarray(to_flax(buf.detach().float().cpu().numpy()))
        count = counts.get(label, counts.get("train", 0))
        inner[label] = {"inner_state": {"0": {}, "1": {"0": {"trace": nest(flat)},
                                                       "1": {"count": np.asarray(count, np.int32)}}}}
    inner["frozen"] = {"inner_state": {}}
    return {"inner_states": inner}


def write_jax_checkpoint(path, model: torch.nn.Module, optimizer: torch.optim.Optimizer, step: int) -> Path:
    """Write ``model`` and ``optimizer`` as the JAX package's ``Checkpointer``
    writes a ``TrainState`` (``flax.serialization.to_bytes``), to ``path``."""
    from mvkpconv_tpu_torch.convert import jax_variables

    variables = jax_variables(model)
    tree = {"step": np.asarray(step, np.int32), "params": variables["params"],
            "batch_stats": variables["batch_stats"], "opt_state": jax_opt_state(model, optimizer)}
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(msgpack_serialize(tree))
    return path
