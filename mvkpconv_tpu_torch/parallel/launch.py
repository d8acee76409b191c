"""Processes for data-parallel runs on one host, and the multichip dry run
(``__graft_entry__.dryrun_multichip``).

:func:`spawn` starts ``n`` processes (``torch.multiprocessing``, spawned),
each in a process group of ``n`` started through a file in a fresh
temporary directory (``init_method='file://…'``: no TCP port, so runs in
parallel cannot collide), runs ``fn(rank, n, *args)`` in each with one CPU
thread, and returns what each returned, by rank. It waits at most
``timeout`` seconds, then kills every process it started and raises; a
process that raises ends the run with its traceback.

:func:`dryrun_multichip` is the JAX dry run's counterpart: one full
early-fusion train step at its configuration over ``n`` gloo processes, on
a ``(data=n/2, model=2)`` mesh where ``n`` is even and at least 4 (the
parameters that ``model_sharding`` splits stored sharded over ``model``
by ``shard_parameters``), else a ``(data=n, model=1)`` one; the batch is
split over ``data`` only. The caller names the device: ``device='cpu'`` is
the counterpart of the JAX dry run on virtual CPU devices (n gloo processes
of one CPU thread each)::

    python -c "from mvkpconv_tpu_torch.parallel import dryrun_multichip; dryrun_multichip(4, device='cpu')"
"""

from __future__ import annotations

import math
import shutil
import tempfile
import time
from pathlib import Path
from typing import Callable, List

import torch


def _run(rank: int, fn: Callable, nprocs: int, backend: str, root: str, args: tuple):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{root}/init", rank=rank, world_size=nprocs)
    try:
        result = fn(rank, nprocs, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(result, f"{root}/rank{rank}.pt")


def spawn(fn: Callable, nprocs: int, *args, backend: str = "gloo", timeout: float = 600.0) -> List:
    """``[fn(rank, nprocs, *args) for rank in range(nprocs)]``, each in its
    own process of one group (``backend``); ``fn`` must be importable (a
    module-level function) and its result picklable by ``torch.save``."""
    import torch.multiprocessing as mp

    root = tempfile.mkdtemp(prefix="mvkp_spawn_")
    try:
        ctx = mp.start_processes(_run, args=(fn, nprocs, backend, root, args), nprocs=nprocs,
                                 join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"spawn: {nprocs} processes of {fn.__name__} still running after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(Path(root) / f"rank{r}.pt", weights_only=False) for r in range(nprocs)]
    finally:
        shutil.rmtree(root, ignore_errors=True)


def dryrun_config(n: int):
    """``__graft_entry__.dryrun_multichip``'s configuration: early fusion, 6
    blocks over 2 levels, N0=256, width 32, 2 views of 24x32, batch ``n``."""
    from mvkpconv_tpu_torch.training.config import KPConfig

    return KPConfig(
        fusion="early", in_features_dim=66,
        architecture=("simple", "resnetb", "resnetb_strided", "resnetb", "nearest_upsample", "unary"),
        num_points=(256, 64), conv_neighbors=(10, 10), pool_neighbors=(10,),
        first_features_dim=32,  # wide enough to shard over `model`
        num_views=2, image_height=24, image_width=32, batch_num=n,
    )


def dryrun_step(rank: int, n: int, device: str, reference: bool = False) -> dict:
    """One process of the dry run: its loss and accuracy (the global ones),
    the mesh's shape, the parameters it stores sharded over ``model`` (name:
    dimension) and the trained parameters after the step, gathered whole.
    With ``reference``, rank 0 then runs the same step in this process alone
    on the whole batch, from the same weights: its loss and trained
    parameters under ``'single'``."""
    import numpy as np
    from torch.distributed.tensor import DTensor, Shard

    from mvkpconv_tpu_torch.data.synthetic_batch import make_batch
    from mvkpconv_tpu_torch.infer import batch_to_device, make_model
    from mvkpconv_tpu_torch.parallel.mesh import make_mesh, shard_batch, shard_parameters
    from mvkpconv_tpu_torch.train import FROZEN_PREFIXES
    from mvkpconv_tpu_torch.training.optim import make_optimizer
    from mvkpconv_tpu_torch.training.steps import make_train_step

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    model_par = 2 if n % 2 == 0 and n >= 4 else 1
    mesh = make_mesh((n // model_par, model_par), ("data", "model"), device_type=dev.type)
    cfg = dryrun_config(n)
    model = make_model(cfg, dev, seed=0).train()
    if model_par > 1:
        shard_parameters(model, mesh, min_dim=16)
    optimizer = make_optimizer(model, cfg, frozen_prefixes=FROZEN_PREFIXES)
    step = make_train_step(model, cfg, optimizer, mesh=mesh)
    whole = batch_to_device(make_batch(cfg, n, np.random.RandomState(0)), dev)
    stats = step(shard_batch(whole, mesh))
    sharded = {name: p.placements[1].dim for name, p in model.named_parameters()
               if isinstance(p, DTensor) and isinstance(p.placements[1], Shard)}

    def trained(model):
        return {name: (p.full_tensor() if isinstance(p, DTensor) else p).detach().cpu()
                for name, p in model.named_parameters() if not name.startswith(FROZEN_PREFIXES)}

    out = {"loss": float(stats["loss"]), "accuracy": float(stats["accuracy"]),
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "sharded": sharded, "trained": trained(model)}
    if reference and rank == 0:
        model = make_model(cfg, dev, seed=0).train()
        single = make_train_step(model, cfg, make_optimizer(model, cfg, frozen_prefixes=FROZEN_PREFIXES))(whole)
        out["single"] = {"loss": float(single["loss"]), "trained": trained(model)}
    return out


def dryrun_multichip(n_devices: int, device: str, timeout: float = 600.0, reference: bool = False) -> float:
    """One full train step over ``n_devices`` gloo processes on ``device``
    (``'cpu'``, or ``'cuda'``: process r on card r mod the cards; see the
    module's docstring); prints a line and returns the loss. The
    processes' results stay on the function as ``dryrun_multichip.ranks``;
    ``reference`` adds rank 0's single-process step (``dryrun_step``)."""
    ranks = spawn(dryrun_step, n_devices, device, reference, timeout=timeout)
    dryrun_multichip.ranks = ranks
    loss = ranks[0]["loss"]
    if not all(math.isfinite(r["loss"]) and r["loss"] == loss for r in ranks):
        raise RuntimeError(f"dryrun_multichip: the processes' losses differ or are not finite: {ranks}")
    print(
        f"dryrun_multichip({n_devices}): one train step OK on {ranks[0]['mesh']} mesh "
        f"(batch over data, channel dims over model), loss={loss:.4f}, acc={ranks[0]['accuracy']:.4f}"
    )
    return loss


dryrun_multichip.ranks = []
