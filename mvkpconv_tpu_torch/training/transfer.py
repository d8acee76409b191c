"""Parameter transfer between training runs
(``mvkpconv_tpu/training/transfer.py``): a 2D run's UNet weights into a
UNet, such as a fusion model's ``net_2d`` (the reference's
``torch.load(config.path_2D)`` into the frozen UNet,
architectures_sphere.py:226-237).

A 2D run's checkpoint is the port's own format (``training/checkpoint.py``)
whose ``model`` entry is the ``UNetResNet34``'s ``state_dict``, or, in a
run directory of the JAX package's ``train_2d``, its ``.msgpack``
``TrainState`` (``training/jax_checkpoint.py``).
"""

from __future__ import annotations

from pathlib import Path

import torch
from torch import nn

from mvkpconv_tpu_torch.training.checkpoint import BEST, Checkpointer
from mvkpconv_tpu_torch.training.jax_checkpoint import jax_checkpoint_path, load_jax_checkpoint


def load_2d_checkpoint(unet: nn.Module, run_dir) -> Path:
    """Fill a ``UNetResNet34`` (parameters and BN statistics) from the 2D run
    at ``run_dir``: its best-metric snapshot, else its latest checkpoint;
    returns the file read. Raises where the checkpoint's keys or shapes
    differ from the UNet's."""
    ck = Checkpointer(Path(run_dir) / "checkpoints")
    path = jax_checkpoint_path(ck.dir, best=True) or jax_checkpoint_path(ck.dir)
    if path is not None:
        load_jax_checkpoint(unet, path)
        return path
    path = ck.dir / BEST
    if not path.exists():
        path = ck.latest_path()
    if path is None:
        raise FileNotFoundError(f"no 2D checkpoint under {run_dir}/checkpoints")
    raw = ck.restore(path)["model"]
    target = unet.state_dict()
    if set(raw) != set(target):
        raise ValueError(
            f"2D checkpoint {path} does not hold the UNet: "
            f"missing {sorted(set(target) - set(raw))[:5]}, "
            f"unexpected {sorted(set(raw) - set(target))[:5]}"
        )
    for k, v in raw.items():
        if tuple(v.shape) != tuple(target[k].shape):
            raise ValueError(
                f"2D checkpoint {k} shape {tuple(v.shape)} does not match the "
                f"UNet's shape {tuple(target[k].shape)}"
            )
    with torch.no_grad():
        unet.load_state_dict({k: v.to(target[k].dtype) for k, v in raw.items()})
    return path

