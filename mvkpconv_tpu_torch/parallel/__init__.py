"""Data parallelism on ``torch.distributed`` (``mvkpconv_tpu/parallel/``)."""

from mvkpconv_tpu_torch.parallel.launch import dryrun_multichip, spawn
from mvkpconv_tpu_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    model_sharding,
    replicated,
    shard_batch,
    shard_parameters,
)
from mvkpconv_tpu_torch.parallel.multihost import (
    global_batch_from_local,
    local_batch_size,
    rank_output_dir,
    shard_scenes,
)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "model_sharding",
    "replicated",
    "shard_batch",
    "shard_parameters",
    "shard_scenes",
    "local_batch_size",
    "global_batch_from_local",
    "rank_output_dir",
    "spawn",
    "dryrun_multichip",
]
