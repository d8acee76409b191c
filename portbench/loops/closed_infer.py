"""The loop ``closed_infer``: one caller in a closed loop through
``tools/test_models.py``'s ``predict`` path: ``data.spheres.device_batch``
→ ``infer.batch_to_device`` → ``training.steps.make_eval_step(model, cfg)``
→ ``.cpu()`` of the probabilities. Each batch is timed from the hand-off of
its host arrays until its probabilities are on the host.

Set-up warms the window's own call on three batches. The check, after the
window: the fullest batch of those the window finished and three more drawn
from the seed, their probabilities as they reached the host against the
reference's (``check.compare_infer``).
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from portbench import check
from portbench.harness import Program, port_config, sync, to_device

KIND = "infer"
TRAINS = False
WARMUP = 3  # calls before the window
SAMPLE = 3  # window batches drawn from the seed for the check, besides the fullest


class Infer(Program):
    def __init__(self, model: Dict, conf: Dict, weights, device, overrides=None):
        from mvkpconv_tpu_torch.data.spheres import device_batch
        from mvkpconv_tpu_torch.infer import batch_to_device, make_model
        from mvkpconv_tpu_torch.training.steps import make_eval_step

        super().__init__(device)
        cfg = port_config(model, overrides)
        self.net = make_model(cfg, self.device, seed=0, freeze_2d=conf.get("freeze_2d", True))
        self.net.load_state_dict(weights, strict=True)
        self._step = make_eval_step(self.net, cfg)
        self._feed = lambda host: batch_to_device(device_batch(host), self.device)

    def call(self, host):
        """(probabilities on the host, a device flag that they are finite)."""
        with self.span("handoff"):
            batch = self._feed(host)
        out = self._step(batch)
        ok = torch.isfinite(out).all()
        with self.span("to_host"):
            return out.cpu(), ok


def build(model: Dict, conf: Dict, weights, device, overrides=None) -> Infer:
    return Infer(model, conf, weights, device, overrides)


def warm(prog: Infer, pool) -> Dict:
    for t in range(WARMUP):
        prog.call(pool.batches[t])
    return {}


def drive(prog: Infer, pool, seconds: float) -> Dict:
    n = len(pool.batches)
    order, flags, latencies, outputs = [], [], [], {}
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        j = len(order) % n
        t = time.perf_counter()
        probs, ok = prog.call(pool.batches[j])
        latencies.append(time.perf_counter() - t)
        outputs[j] = probs
        flags.append(ok)
        order.append(j)
    sync(prog.device)
    window = time.perf_counter() - start
    return {"order": order, "window_s": window, "latencies_s": latencies, "outputs": outputs,
            "failed": int(sum(not bool(x) for x in flags))}


def check_run(model: Dict, weights, pool, run: Dict, warmed: Dict, seed: int, device) -> Dict[str, float]:
    outputs = run.pop("outputs")
    done = sorted(outputs)
    rng = np.random.RandomState(seed)
    sample = {max(done, key=lambda j: pool.real_points[j])}
    sample |= set(rng.choice(done, min(SAMPLE, len(done)), replace=False).tolist())
    sample = sorted(sample)
    return check.compare_infer(model, weights, [to_device(pool.batches[j], device) for j in sample],
                               [outputs[j] for j in sample])


def half_batch(prog: Infer) -> None:
    """Half of the batch left out: the second half's answers never computed
    (uniform)."""
    step = prog._step

    def wrapped(batch):
        out = step(batch).clone()
        out[out.shape[0] // 2:] = 1.0 / out.shape[-1]
        return out

    prog._step = wrapped


def altered(prog: Infer) -> None:
    """An answer altered where it is produced: the first sphere's
    probabilities shifted by one class."""
    step = prog._step

    def wrapped(batch):
        out = step(batch).clone()
        out[0] = torch.roll(out[0], 1, dims=-1)
        return out

    prog._step = wrapped


FAULTS = {"half_batch": half_batch, "altered": altered}
