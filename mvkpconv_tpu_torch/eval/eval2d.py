"""Full-dataset 2D segmentation evaluation (``mvkpconv_tpu/eval/eval2d.py``).

Sweep a frame dataset once, accumulate the confusion, report the Evaluator
class table (the reference's mvpnet/test_2d.py). The same sweep is the
in-training validation metric of ``tools/train_2d.py``, so the number that
selects ``model_best`` there and the number ``tools/test_2d.py`` reports for
a saved checkpoint come from one code path.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from mvkpconv_tpu_torch.eval.evaluator import Evaluator


def evaluate_frames(probs_fn: Callable, dataset, batch_size: int = 8, ignore_label: int = -1) -> Evaluator:
    """Score ``probs_fn`` (numpy batch dict → (B, H, W, C) probabilities or
    logits; only the argmax is used) over every frame of a
    ``Frames2DDataset`` (anything with ``iter_batches``). The rows that wrap
    around to fill the last batch are left out of the confusion."""
    ev = Evaluator(ignore_label=ignore_label)
    for batch, count in dataset.iter_batches(batch_size):
        pred = np.asarray(probs_fn(batch)).argmax(-1)
        ev.update(pred[:count], batch["labels"][:count])
    return ev
