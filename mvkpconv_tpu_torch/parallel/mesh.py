"""Device mesh and placements (``mvkpconv_tpu/parallel/mesh.py``) on
``torch.distributed``.

The JAX package's scaling story is data parallelism over a
``jax.sharding.Mesh``: batches sharded over the ``data`` axis, parameters
replicated, a second ``model`` axis kept for layouts that shard output-channel
dimensions. Here the mesh is a ``torch.distributed.device_mesh.DeviceMesh``
over the processes of the default group (one device each), a sharding is a
list of DTensor placements, one per mesh dimension, and the step that trains
over it is ``training/steps.py:make_train_step(..., mesh=)``.

:func:`shard_parameters` lays a model out over the ``model`` axis with FSDP2
(``fully_shard``): the parameters :func:`model_sharding` shards are stored
as DTensors sharded on their output-channel dimension over ``model`` (and gathered
for the forward and backward); the others are left out of FSDP, replicated,
and the step all-reduces their gradients over ``data``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn


def make_mesh(shape: Optional[Sequence[int]] = None, axis_names: Sequence[str] = ("data",),
              device_type: Optional[str] = None):
    """A mesh over every process of the default group (started first), a
    1-D ``data`` axis unless ``shape`` says otherwise. ``device_type`` is
    that of the model's device: ``cuda`` (the default) or ``cpu``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: start the process group first (torch.distributed.init_process_group)")
    shape = tuple(shape) if shape is not None else (dist.get_world_size(),)
    return init_device_mesh(device_type or "cuda", shape, mesh_dim_names=tuple(axis_names[:len(shape)]))


def batch_sharding(mesh, axis: str = "data") -> list:
    """Placements of a batch leaf: its leading dim split over ``axis``
    (``[Shard(0)]`` on a 1-D mesh), replicated over the other dimensions."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if name == axis else Replicate() for name in mesh.mesh_dim_names]


def replicated(mesh) -> list:
    """Placements of a leaf held whole by every process: ``[Replicate()]``
    per mesh dimension."""
    from torch.distributed.tensor import Replicate

    return [Replicate()] * mesh.ndim


def shard_batch(batch: Dict[str, torch.Tensor], mesh, axis: str = "data") -> Dict[str, torch.Tensor]:
    """This process's slice, along dim 0, of every leaf of a global batch:
    the block of rows of its coordinate on ``axis``. A mesh of one process
    on ``axis`` returns the batch as it is."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if n == 1:
        return batch
    i = mesh.get_local_rank(axis)
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"shard_batch: {k} has {v.shape[0]} rows, not a multiple of {n} on {axis!r}")
        rows = v.shape[0] // n
        out[k] = v[i * rows:(i + 1) * rows]
    return out


def channel_dims(params) -> Dict[str, Tuple[torch.Tensor, int]]:
    """Each named parameter of ``params`` (a module, or a mapping of names to
    tensors) with its output-channel dimension: the one the JAX package's
    layout keeps last. torch keeps it first in a ``Linear`` or ``Conv2d``
    weight, (out, in, …), and second in a ``ConvTranspose2d`` one, (in, out,
    kh, kw) (``convert.py``); every other parameter of the port (KPConv
    weights (M, Cin, Cout), biases, BN scales) has the JAX layout."""
    if not isinstance(params, nn.Module):
        return {name: (x, x.dim() - 1) for name, x in dict(params).items()}
    out = {}
    for mod_name, mod in params.named_modules():
        for attr, x in mod.named_parameters(recurse=False):
            dim = x.dim() - 1
            if attr == "weight" and isinstance(mod, nn.ConvTranspose2d):
                dim = 1
            elif attr == "weight" and isinstance(mod, (nn.Linear, nn.Conv2d)):
                dim = 0
            out[f"{mod_name}.{attr}" if mod_name else attr] = (x, dim)
    return out


def model_sharding(mesh, params, axis: str = "model", min_dim: int = 64) -> Dict[str, list]:
    """Tensor-parallel placements over the ``axis`` mesh dimension, by the
    JAX package's rule: a parameter whose output-channel dimension
    (:func:`channel_dims`; the last one in the JAX layout) is at least
    ``min_dim`` wide and divides by the axis size is split on it
    (``Shard(dim)``); every other one is replicated. ``params`` is a module
    or a mapping of names to tensors; returns the placements (one per mesh
    dimension) by name."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    size = mesh.size(names.index(axis)) if axis in names else 1
    out = {}
    for name, (x, dim) in channel_dims(params).items():
        split = size > 1 and x.dim() >= 1 and x.shape[dim] >= min_dim and x.shape[dim] % size == 0
        out[name] = [Shard(dim) if split and n == axis else Replicate() for n in names]
    return out


def shard_parameters(model: nn.Module, mesh, axis: str = "model", min_dim: int = 64) -> List[nn.Parameter]:
    """Store the parameters :func:`model_sharding` splits as DTensors
    sharded on their output-channel dimension over ``axis`` (FSDP2 ``fully_shard`` on
    ``mesh``: gathered for the forward and backward, their gradients
    reduce-scattered over ``axis`` and averaged over the others); returns
    the replicated ones, left out of FSDP, in the model's order, whose
    gradients the train step all-reduces over ``data``. Build the optimizer
    after this call: the sharded parameters are new objects."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    axis_dim = mesh.mesh_dim_names.index(axis)
    if axis_dim != mesh.ndim - 1:
        raise ValueError(f"shard_parameters: {axis!r} must be the mesh's last dimension (FSDP shards over it)")
    plan = model_sharding(mesh, model, axis, min_dim)
    split = {id(p): plan[n][axis_dim] for n, p in model.named_parameters()
             if isinstance(plan[n][axis_dim], Shard)}
    if not split:
        raise ValueError(f"shard_parameters: no parameter of at least {min_dim} channels divides over {axis!r}")
    kept = [p for p in model.parameters() if id(p) not in split]
    fully_shard(model, mesh=mesh, shard_placement_fn=lambda p: split[id(p)], ignored_params=set(kept))
    return kept
