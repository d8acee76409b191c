"""Weight bridge: JAX package variables → the port's ``state_dict``.

The port's submodules carry the flax scope names (``net_2d.layer1_0.conv1``,
``encoder.block_3.KPConv``, ``head.head_softmax``, ``net_3d.sa0.mlp.dense0``,
``fp3``, ``mlp_seg``, ``seg_logit``, ``feat_aggreg`` …), so the bridge walks
the torch modules and reads each one's flax leaves at the same path: any
model of the port (MV-KPConv, KPFCNN, KPCNN, MVPNet3D, PN2SSG, or the UNet
alone, whose leaves sit at the root), with the layout changes:

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
  * KPConv ``weights`` (M, Cin, Cout) as they are, and a deformable
    layer's ``offset_bias`` (its ``offset_conv`` is a KPConv layer of its
    own).

A deformable model's variables also carry the ``intermediates`` collection
(the activations its layers sow for the fitting regularizer): it holds no
weights and is dropped.

It raises on any flax leaf it did not use and on any torch parameter or
buffer it did not set. :func:`jax_variables` is its inverse (the flax
variables of a model of the port), and :func:`leaf_map` the table both
walk, which the optimizer state's bridge (``training/jax_checkpoint.py``)
walks too.
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


def _same(a):
    return a


# (torch → flax, flax → torch) layout changes; each is the other's inverse
_LINEAR = (lambda w: w.T, lambda k: k.T)
_CONV = (lambda w: w.transpose(2, 3, 1, 0), lambda k: k.transpose(3, 2, 0, 1))
_CONV_T = (lambda w: w[:, :, ::-1, ::-1].transpose(2, 3, 0, 1),
           lambda k: k.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
_AS_IS = (_same, _same)


def leaf_map(model: nn.Module):
    """Every tensor the bridge sets, as ``(torch state_dict key, flax
    collection, flax key path 'a/b/leaf', (to_flax, to_torch))``, the layout
    changes acting on numpy arrays."""
    out = []
    for name, mod in model.named_modules():
        scope = name.replace(".", "/")

        def put(attr, col, leaf, fns=_AS_IS):
            key = f"{scope}/{leaf}" if scope else leaf
            out.append((f"{name}.{attr}" if name else attr, col, key, fns))

        if isinstance(mod, nn.ConvTranspose2d):
            put("weight", "params", "kernel", _CONV_T)
            if mod.bias is not None:
                put("bias", "params", "bias")
        elif isinstance(mod, nn.Conv2d):
            put("weight", "params", "kernel", _CONV)
            if mod.bias is not None:
                put("bias", "params", "bias")
        elif isinstance(mod, nn.Linear):
            put("weight", "params", "kernel", _LINEAR)
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
            if mod.deformable:
                put("offset_bias", "params", "offset_bias")
    return out


def nest(flat: Mapping[str, np.ndarray]) -> Dict:
    """'a/b/leaf' keys → nested dicts."""
    out: Dict = {}
    for key, val in flat.items():
        *path, leaf = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val
    return out


@torch.no_grad()
def jax_variables(model: nn.Module) -> Dict:
    """The inverse of :func:`load_jax_variables`: ``{'params': ...,
    'batch_stats': ...}`` of ``model`` as nested dicts of float32 numpy
    arrays in the flax layout."""
    state = model.state_dict()
    flat = {"params": {}, "batch_stats": {}}
    for key, col, fkey, (to_flax, _) in leaf_map(model):
        flat[col][fkey] = np.ascontiguousarray(to_flax(state[key].detach().float().cpu().numpy()))
    return {col: nest(leaves) for col, leaves in flat.items()}


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
    extra_cols = set(variables) - {"params", "batch_stats", "intermediates"}
    if extra_cols:
        raise ValueError(f"unexpected flax collections {sorted(extra_cols)}")
    state = {}
    for key, col, fkey, (_, to_torch) in leaf_map(model):
        if (col, fkey) not in leaves:
            raise KeyError(f"flax variables have no {col} leaf {fkey!r}")
        state[key] = np.ascontiguousarray(to_torch(leaves.pop((col, fkey))))
    unused = sorted(f"{c}:{k}" for c, k in leaves)
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
