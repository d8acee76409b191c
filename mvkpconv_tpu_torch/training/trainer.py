"""Iteration-based trainer (``mvkpconv_tpu/training/trainer.py``).

Semantics kept from the JAX package's Trainer:
  * periodic validation (every ``val_period`` steps, default once per
    ``cfg.epoch_steps``) with best-metric checkpointing, and a final
    validation and snapshot when the loop ends;
  * ``training.txt`` convergence log, ``val_IoUs.txt``, ``scalars.jsonl``
    and ``parameters.txt`` in the output directory;
  * graceful stop by deleting the ``running_PID.txt`` kill file;
  * ``maybe_resume`` from the latest checkpoint, the port's or, in a JAX
    run's directory, the JAX package's with its optimizer state;
  * a prefetch thread that assembles the next host batch while the device
    runs the current step;
  * ``profile_steps``: a ``torch.profiler`` trace of steps [2, 2+N) under
    ``output/profile``.

Where the JAX Trainer carries a functional ``TrainState``, this one drives
the port's ``step(batch) -> {'loss', 'accuracy'}`` (``training/steps.py``),
which updates ``model`` and ``optimizer`` in place, and counts the steps
itself. Each numpy batch goes to the model's device as it is handed over
(strip host-only keys with ``data.spheres.device_batch`` first). There is no
mesh: data parallelism is not ported (ROADMAP queue 1, item 5).
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from mvkpconv_tpu_torch.data.prefetch import prefetch
from mvkpconv_tpu_torch.infer import batch_to_device
from mvkpconv_tpu_torch.training.checkpoint import Checkpointer
from mvkpconv_tpu_torch.training.jax_checkpoint import jax_checkpoint_path, load_jax_train_state
from mvkpconv_tpu_torch.training.logger import (
    MetricLogger,
    ScalarLog,
    TrainingLog,
    ValIoULog,
    setup_logger,
)


class Trainer:
    def __init__(
        self,
        train_step: Callable,
        model: nn.Module,
        optimizer: torch.optim.Optimizer,
        output_dir: str,
        cfg,
        eval_fn: Optional[Callable[[], object]] = None,
        log_period: int = 50,
        val_period: int = 0,  # 0 = once per epoch
        max_to_keep: int = 5,
        profile_steps: int = 0,  # capture a profiler trace of steps [2, 2+N)
    ):
        self.train_step = train_step
        self.model = model
        self.optimizer = optimizer
        self.device = next(model.parameters()).device
        self.step = 0
        self.cfg = cfg
        self.eval_fn = eval_fn
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.logger = setup_logger(output_dir=str(self.output_dir))
        self.meters = MetricLogger()
        self.training_log = TrainingLog(self.output_dir)
        self.scalar_log = ScalarLog(self.output_dir)
        self.val_iou_log = ValIoULog(self.output_dir)
        self.checkpointer = Checkpointer(self.output_dir / "checkpoints", max_to_keep)
        self.log_period = log_period
        self.val_period = val_period or cfg.epoch_steps
        self.best_metric = -np.inf
        self.kill_file = self.output_dir / "running_PID.txt"
        self.profile_steps = profile_steps
        self._profiler = None
        cfg.save(self.output_dir / "parameters.txt")

    def state_dict(self) -> Dict[str, object]:
        """What a checkpoint holds: the step, the model's parameters and BN
        statistics, and the optimizer's state."""
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def _maybe_profile(self, local_step: int):
        """A ``torch.profiler`` trace (Chrome format) of steps [2, 2+N)."""
        if not self.profile_steps:
            return
        if local_step == 2 and self._profiler is None:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=acts)
            self._profiler.__enter__()
        elif self._profiler is not None and local_step >= 2 + self.profile_steps:
            self._stop_profile()

    def _stop_profile(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.__exit__(None, None, None)
        out = self.output_dir / "profile"
        out.mkdir(exist_ok=True)
        self._profiler.export_chrome_trace(str(out / "trace.json"))
        self._profiler = None
        self.profile_steps = 0
        self.logger.info("profiler trace written to %s", out)

    def maybe_resume(self):
        """Resume from the latest checkpoint of the output directory: the
        port's ``ckpt_*.pt``, else a JAX run's ``ckpt_*.msgpack`` (model,
        BN statistics, momentum and the schedule's count)."""
        path = jax_checkpoint_path(self.checkpointer.dir)
        if path is not None:
            self.step = load_jax_train_state(self.model, self.optimizer, path)
            self.logger.info("resumed from step %d of the JAX checkpoint %s", self.step, path)
            return
        restored = self.checkpointer.restore()
        if restored is not None:
            self.model.load_state_dict(restored["model"])
            self.optimizer.load_state_dict(restored["optimizer"])
            self.step = int(restored["step"])
            self.logger.info("resumed from step %d", self.step)

    def fit(
        self,
        batches: Iterable,
        max_steps: Optional[int] = None,
        prefetch_depth: int = 2,
    ) -> int:
        """Run the training loop over an (in)finite iterator of numpy
        batches; returns the step reached.

        The iterator is wrapped in a background prefetch thread so the next
        host batch is assembled while the device runs; ``prefetch_depth=0``
        disables it.
        """
        self.kill_file.write_text(str(os.getpid()))
        max_steps = max_steps or self.cfg.max_epoch * self.cfg.epoch_steps
        producer = None
        if prefetch_depth > 0:
            batches = producer = prefetch(batches, depth=prefetch_depth)
        t_data = time.time()
        local_step = 0
        try:
            for batch in batches:
                if self.step >= max_steps:
                    break
                self._maybe_profile(local_step)
                local_step += 1
                if not self.kill_file.exists():  # graceful stop (trainer.py:133-137)
                    self.logger.info("kill file removed — stopping gracefully")
                    break
                data_time = time.time() - t_data
                t0 = time.time()
                stats = self.train_step(batch_to_device(batch, self.device))
                stats = {k: float(v) for k, v in stats.items()}
                step_time = time.time() - t0
                self.meters.update(data=data_time, time=step_time, **stats)
                self.step += 1
                step, epoch = self.step, self.step // self.cfg.epoch_steps
                if step % self.log_period == 0:
                    self.logger.info("step %d (epoch %d): %s", step, epoch, self.meters)
                    self.scalar_log.log(step, data_time=data_time, step_time=step_time, **stats)
                self.training_log.append(
                    epoch, step, stats.get("loss", 0.0), stats.get("offset_loss", 0.0),
                    stats.get("accuracy", 0.0),
                )
                if step % self.val_period == 0:
                    self._validate_and_checkpoint(step)
                t_data = time.time()
        finally:
            if self._profiler is not None:
                self._stop_profile()
            if producer is not None:
                producer.close()
        # final snapshot
        self._validate_and_checkpoint(self.step)
        if self.kill_file.exists():
            self.kill_file.unlink()
        return self.step

    def _validate_and_checkpoint(self, step: int):
        metric = None
        if self.eval_fn is not None:
            metric = self.eval_fn()
            self.logger.info("validation @ step %d: %s", step, metric)
            if isinstance(metric, dict):
                if "class_iou" in metric:
                    # reference's per-class val_IoUs.txt (trainer.py:445-452)
                    self.val_iou_log.append(metric["class_iou"])
                self.scalar_log.log(
                    step, **{f"val_{k}": v for k, v in metric.items() if np.ndim(v) == 0}
                )
                metric = metric.get("miou", metric.get("accuracy"))
        is_best = metric is not None and metric > self.best_metric
        if is_best:
            self.best_metric = metric
        self.checkpointer.save(self.state_dict(), step, is_best=is_best)
