"""The data-parallel group of a train step, and the sums taken over it.

Under a JAX mesh the jitted step runs on the global batch as one array, so
every statistic it takes is global: batch-norm means and variances, the
masked cross-entropy's denominator, the class counts of
``segloss_balance='class'``, the deformable regularizer's denominators and
the accuracy. Here each process holds its slice of the batch. The step
names the group its batch is split over (:func:`data_parallel`) and each of
those statistics sums its local parts over it (:func:`global_sum`,
:func:`global_sums`), with ``torch.distributed.nn.functional.all_reduce``,
whose backward all-reduces the gradient: gradients flow through the sums.

Outside a step, and in a group of one process, the sums return their
arguments as they are, so a single process computes the same bits as it
did without this module.
"""

from __future__ import annotations

import contextlib
import contextvars
import warnings
from typing import Optional

import torch

_GROUP: contextvars.ContextVar = contextvars.ContextVar("data_parallel_group", default=None)


def group_size(group) -> int:
    """Processes in ``group`` (1 for None)."""
    if group is None:
        return 1
    import torch.distributed as dist

    return dist.get_world_size(group)


@contextlib.contextmanager
def data_parallel(group):
    """Batch statistics taken inside are sums over ``group`` (a process group
    of more than one process; None or one process: local)."""
    token = _GROUP.set(group if group_size(group) > 1 else None)
    try:
        yield
    finally:
        _GROUP.reset(token)


def current_group() -> Optional[object]:
    """The group of the enclosing :func:`data_parallel`, None if local."""
    return _GROUP.get()


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the data-parallel group, differentiably; ``t``
    itself outside one."""
    group = _GROUP.get()
    if group is None:
        return t
    from torch.distributed.nn.functional import all_reduce

    with warnings.catch_warnings():
        # the autograd collectives are deprecated for torch.compile's functional
        # ones, which have no backward
        warnings.simplefilter("ignore", FutureWarning)
        return all_reduce(t, group=group)


def global_sums(*tensors: torch.Tensor):
    """Each of ``tensors`` summed over the group in one all-reduce (they
    share a dtype); the tensors themselves outside one."""
    if _GROUP.get() is None:
        return tensors
    flat = global_sum(torch.cat([t.reshape(-1) for t in tensors]))
    return tuple(p.reshape(t.shape) for p, t in zip(flat.split([t.numel() for t in tensors]), tensors))
