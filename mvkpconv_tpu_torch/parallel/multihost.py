"""Multi-process data parallelism (``mvkpconv_tpu/parallel/multihost.py``):
scene sharding and per-process batch assembly.

  * every process owns a round-robin slice of the scene list
    (:func:`shard_scenes`): potentials, frame overlaps and sphere sampling
    stay process-local;
  * every process samples ``global_batch // world_size`` spheres
    (:func:`local_batch_size`) and wraps them as its shard of the global
    batch (:func:`global_batch_from_local`): a DTensor of the global shape,
    split on dim 0 over the mesh's ``data`` axis, which the data-parallel
    step unwraps with ``to_local()``;
  * each process writes its run to its own directory (:func:`rank_output_dir`).

Where the JAX package reads ``jax.process_index()`` / ``process_count()``,
the port reads the default process group's rank and size, or 0 and 1 where
no group is started. A single process is the degenerate case.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence

import torch


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def shard_scenes(scenes: Sequence, process_index: Optional[int] = None,
                 process_count: Optional[int] = None) -> list:
    """Round-robin slice of ``scenes`` owned by this process (shard sizes
    within 1 of each other); raises where a process would own none."""
    pi = _rank() if process_index is None else process_index
    pc = _world() if process_count is None else process_count
    if not 0 <= pi < pc:
        raise ValueError(f"process_index {pi} out of range for {pc} processes")
    shard = list(scenes[pi::pc])
    if not shard:
        raise ValueError(
            f"process {pi}/{pc} owns no scenes ({len(scenes)} total) — "
            "need at least one scene per host"
        )
    return shard


def local_batch_size(global_batch: int, process_count: Optional[int] = None) -> int:
    """Spheres a process samples; the global batch must divide evenly."""
    pc = _world() if process_count is None else process_count
    if global_batch % pc:
        raise ValueError(f"global batch {global_batch} not divisible by {pc} processes")
    return global_batch // pc


def global_batch_from_local(local_batch: Dict[str, torch.Tensor], mesh, axis: str = "data") -> Dict:
    """This process's slice as its shard of the global batch: each leaf a
    DTensor whose dim 0 is ``local × (processes on axis)``, split over
    ``axis`` and replicated over the mesh's other dimensions. The leaves
    must lie on the mesh's device type."""
    from torch.distributed.tensor import DTensor

    from mvkpconv_tpu_torch.parallel.mesh import batch_sharding

    placements = batch_sharding(mesh, axis)
    return {k: DTensor.from_local(torch.as_tensor(v), mesh, placements) for k, v in local_batch.items()}


def rank_output_dir(path) -> Path:
    """Where this process writes a run: ``path`` in a single process and on
    rank 0, ``path/rank<r>`` on rank r > 0."""
    rank = _rank()
    return Path(path) if rank == 0 else Path(path) / f"rank{rank}"
