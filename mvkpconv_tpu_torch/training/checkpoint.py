"""Checkpointing with last-tag, max_to_keep GC and best-metric tracking
(``mvkpconv_tpu/training/checkpoint.py``).

The same file layout as the JAX package's: ``ckpt_XXXXXXXX.pt`` per saved
step, the ``last_checkpoint`` tag file naming the newest, garbage
collection down to ``max_to_keep`` and a ``model_best.pt`` snapshot. A
checkpoint is ``torch.save`` of a dict; the Trainer's holds ``step``,
``model`` (the ``state_dict``: parameters and BN statistics) and
``optimizer`` (its ``state_dict``: momentum and the schedule's count). Each
file is written to a temporary name and moved into place with
``os.replace``, so a reader never sees half a file. The tag of a JAX run
directory names a ``.msgpack``, which this class never reads: the Trainer
resumes such a run through ``training/jax_checkpoint.py``. ``parameters.txt``
beside the checkpoints (written by the Trainer) makes a run directory
self-describing.
"""

from __future__ import annotations

import io
import os
import pickle
from pathlib import Path
from typing import Any, Dict, Optional

import torch

BEST = "model_best.pt"


def _write(path: Path, data: bytes) -> None:
    tmp = path.with_suffix(".tmp")
    tmp.write_bytes(data)
    os.replace(tmp, path)


class Checkpointer:
    def __init__(self, directory, max_to_keep: int = 5):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> Path:
        return self.dir / f"ckpt_{step:08d}.pt"

    def save(self, state: Dict[str, Any], step: int, is_best: bool = False) -> Path:
        buf = io.BytesIO()
        torch.save(state, buf)
        data = buf.getvalue()
        path = self._path(step)
        _write(path, data)
        (self.dir / "last_checkpoint").write_text(path.name)
        if is_best:
            _write(self.dir / BEST, data)
        self._gc()
        return path

    def _gc(self):
        ckpts = sorted(self.dir.glob("ckpt_*.pt"))
        for old in ckpts[: -self.max_to_keep]:
            old.unlink()

    def latest_path(self) -> Optional[Path]:
        """The ``ckpt_*.pt`` the ``last_checkpoint`` tag names, else the
        newest; a tag naming another kind of file (the JAX package's
        ``.msgpack``) is not followed."""
        tag = self.dir / "last_checkpoint"
        if tag.exists():
            p = self.dir / tag.read_text().strip()
            if p.suffix == ".pt" and p.exists():
                return p
        ckpts = sorted(self.dir.glob("ckpt_*.pt"))
        return ckpts[-1] if ckpts else None

    def restore(self, path: Optional[Path] = None) -> Optional[Dict[str, Any]]:
        """The dict saved at ``path`` (default: the latest), tensors on the
        CPU; None where no checkpoint exists. Raises, naming the file, on a
        file that is not one of the port's checkpoints."""
        path = path or self.latest_path()
        if path is None:
            return None
        if Path(path).suffix != ".pt":
            raise ValueError(f"{path}: not a checkpoint of the port (ckpt_*.pt); a JAX run's "
                             "*.msgpack is read by training/jax_checkpoint.py")
        try:
            return torch.load(path, map_location="cpu", weights_only=True)
        except (pickle.UnpicklingError, EOFError, RuntimeError) as err:  # they do not name the file
            raise ValueError(f"{path}: not a readable checkpoint of the port: {err}") from err

    def restore_best(self) -> Optional[Dict[str, Any]]:
        p = self.dir / BEST
        return self.restore(p) if p.exists() else None
