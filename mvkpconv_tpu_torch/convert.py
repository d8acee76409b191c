"""Weight bridge: JAX package variables → the port's ``state_dict``.

The port's submodules carry the flax scope names (``net_2d.layer1_0.conv1``,
``encoder.block_3.KPConv``, ``head.head_softmax`` …), so the bridge walks
the torch modules and reads each one's flax leaves at the same path, with
the layout changes:

  * Conv kernel HWIO → OIHW;
  * Dense kernel (in, out) → Linear weight (out, in);
  * flax ``ConvTranspose`` kernel (kh, kw, in, out) with
    ``transpose_kernel=False`` → torch (in, out, kh, kw) with BOTH spatial
    axes flipped: lax.conv_transpose correlates the stride-dilated input
    with the kernel as it is, so output pixel 2i+a takes kernel tap 1−a,
    where torch's transposed conv takes tap a;
  * BN ``scale``/``bias`` + ``batch_stats`` ``mean``/``var`` →
    ``weight``/``bias``/``running_mean``/``running_var``;
  * ``MaskedBatchNorm`` with ``use_bn=False`` → its bias only;
  * KPConv ``weights`` (M, Cin, Cout) as they are.

It raises on any flax leaf it did not use and on any torch parameter or
buffer it did not set.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from mvkpconv_tpu_torch.models.blocks import KPConvLayer, MaskedBatchNorm
from mvkpconv_tpu_torch.models.norm import BatchNorm


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


@torch.no_grad()
def load_jax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Fill ``model`` from ``{'params': ..., 'batch_stats': ...}`` (nested
    dicts of numpy arrays, as ``jax.tree.map(np.asarray, variables)`` gives
    them)."""
    leaves = {
        (col, key): val
        for col in ("params", "batch_stats")
        for key, val in _flatten(variables.get(col, {})).items()
    }
    extra_cols = set(variables) - {"params", "batch_stats"}
    if extra_cols:
        raise ValueError(f"unexpected flax collections {sorted(extra_cols)}")
    used = set()
    state = {}

    def take(col, key):
        if (col, key) not in leaves:
            raise KeyError(f"flax variables have no {col} leaf {key!r}")
        used.add((col, key))
        return leaves[(col, key)]

    for name, mod in model.named_modules():
        scope = name.replace(".", "/")

        def put(attr, col, leaf, fn=lambda a: a):
            key = f"{scope}/{leaf}" if scope else leaf
            state[f"{name}.{attr}" if name else attr] = np.ascontiguousarray(fn(take(col, key)))

        if isinstance(mod, nn.ConvTranspose2d):
            put("weight", "params", "kernel", lambda k: k.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
            if mod.bias is not None:
                put("bias", "params", "bias")
        elif isinstance(mod, nn.Conv2d):
            put("weight", "params", "kernel", lambda k: k.transpose(3, 2, 0, 1))
            if mod.bias is not None:
                put("bias", "params", "bias")
        elif isinstance(mod, nn.Linear):
            put("weight", "params", "kernel", lambda k: k.T)
            if mod.bias is not None:
                put("bias", "params", "bias")
        elif isinstance(mod, BatchNorm) or (
            isinstance(mod, MaskedBatchNorm) and mod.use_bn
        ):
            put("weight", "params", "scale")
            put("bias", "params", "bias")
            put("running_mean", "batch_stats", "mean")
            put("running_var", "batch_stats", "var")
        elif isinstance(mod, MaskedBatchNorm):
            put("bias", "params", "bias")
        elif isinstance(mod, KPConvLayer):
            put("weights", "params", "weights")

    unused = sorted(f"{c}:{k}" for c, k in set(leaves) - used)
    if unused:
        raise ValueError(f"flax leaves not used by the bridge: {unused}")
    expected = model.state_dict()
    unset = sorted(set(expected) - set(state))
    if unset:
        raise ValueError(f"torch parameters/buffers not set by the bridge: {unset}")
    for k, v in state.items():
        if tuple(v.shape) != tuple(expected[k].shape):
            raise ValueError(f"{k}: flax shape {v.shape} != torch {tuple(expected[k].shape)}")
    model.load_state_dict(
        {k: torch.tensor(v, dtype=expected[k].dtype) for k, v in state.items()},
        strict=True,
    )
    return model
