"""Voting sphere inference over whole clouds: a copy of
``mvkpconv_tpu/eval/voting.py``. ``predict_fn`` takes a numpy batch
(host-only keys stripped) and returns numpy probabilities; the port's CLIs
wrap ``training.steps.make_eval_step`` into one.

Re-design of KPConv-PyTorch/utils/tester.py:45-376 (``ModelTester.
cloud_segmentation_test``): potential-sampled spheres sweep each validation
cloud until every region has been visited ``num_votes`` times; per-sphere
probabilities are exponentially smoothed into per-(subsampled-)point buffers,
keeping only predictions within ``core_ratio``·in_radius of the sphere
center (tester.py:90,179-185); finally sub-cloud probs are reprojected to
the full-resolution points via precomputed 1-NN (``test_proj``,
tester.py:259-318) and scored.

Also provides the validation-time variant used during training
(utils/trainer.py:283-537: smoothing 0.95, confusion rescaled to true class
proportions).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from mvkpconv_tpu_torch.data.prefetch import prefetch
from mvkpconv_tpu_torch.data.spheres import SphereDataset, device_batch
from mvkpconv_tpu_torch.eval.evaluator import Evaluator
from mvkpconv_tpu_torch.training.metrics import (
    iou_from_confusion,
    rescale_confusion_to_proportions,
)


class VotingTester:
    def __init__(
        self,
        dataset: SphereDataset,
        predict_fn: Callable,  # (batch) -> (B, N0, C) probabilities
        num_classes: int,
        num_votes: float = 30.0,
        smooth: float = 0.95,
        core_ratio: float = 0.7,
        ignore_label: int = -1,
    ):
        self.ds = dataset
        self.predict_fn = predict_fn
        self.num_classes = num_classes
        self.num_votes = num_votes
        self.smooth = smooth
        self.core_ratio = core_ratio
        self.ignore_label = ignore_label
        # per-scene smoothed probability buffers over the subsampled clouds
        self.probs = [
            np.zeros((len(s["points"]), num_classes), np.float32)
            for s in self.ds.scenes
        ]

    def _accumulate(self, batch: Dict, probs: np.ndarray):
        core2 = (self.core_ratio * self.ds.cfg.in_radius) ** 2
        for b in range(probs.shape[0]):
            inds = batch["point_indices"][b]  # (n_valid,) into the sub cloud
            n = len(inds)
            pts = batch["points"][b][:n]  # centered sphere points
            core = batch["mask"][b][:n] & (np.sum(pts**2, axis=-1) < core2)
            target = inds[core]
            buf = self.probs[int(batch["scene_index"][b])]
            buf[target] = (
                self.smooth * buf[target]
                + (1 - self.smooth) * probs[b, :n][core]
            )

    def run(
        self,
        max_batches: int = 10000,
        batch_size: Optional[int] = None,
        log_every: int = 0,
        prefetch_depth: int = 2,
    ) -> Evaluator:
        """Sweep spheres until min potential exceeds num_votes, then score.

        Host sampling runs on a prefetch thread so the next sphere batch is
        assembled while the device evaluates the current one (potentials are
        updated at sample time, so the sweep-completion check already
        accounts for in-flight batches)."""

        def produce():
            n = 0
            while self.ds.min_potential() < self.num_votes and n < max_batches:
                yield self.ds.sample_batch(batch_size)
                n += 1

        batches = produce()
        if prefetch_depth > 0:
            batches = prefetch(batches, depth=prefetch_depth)
        for n, batch in enumerate(batches, 1):
            probs = np.asarray(self.predict_fn(device_batch(batch)))
            self._accumulate(batch, probs)
            if log_every and n % log_every == 0:
                print(
                    f"vote sweep: {n} batches, min potential "
                    f"{self.ds.min_potential():.2f}/{self.num_votes}"
                )
        return self.score()

    def score(self) -> Evaluator:
        """Confusion over subsampled clouds (full-cloud scoring via
        ``score_reprojected`` when scenes carry full-res points)."""
        ev = Evaluator(
            class_names=[str(i) for i in range(self.num_classes)],
            ignore_label=self.ignore_label,
        )
        ev.class_names = tuple(ev.class_names)
        for scene, probs in zip(self.ds.scenes, self.probs):
            pred = probs.argmax(-1)
            ev.update(pred, scene["labels"])
        return ev

    def save_artifacts(
        self, out_dir, prefix: str = "", html: bool = False,
        class_names=None,
    ) -> None:
        """Dump per-scene prediction and potentials PLYs (tester.py:320-365:
        predictions/probs plys every vote milestone, potentials clouds).
        With ``html=True`` also writes a standalone interactive viewer per
        scene (pred/gt/error clouds — `utils/html_viewer.py`)."""
        from pathlib import Path

        from mvkpconv_tpu_torch.utils.visualize import (
            save_potentials_ply,
            save_prediction_ply,
        )

        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        for i, (scene, probs) in enumerate(zip(self.ds.scenes, self.probs)):
            name = scene.get("scan_id", f"scene{i:03d}")
            save_prediction_ply(
                out / f"{prefix}{name}_pred.ply",
                scene["points"],
                probs.argmax(-1),
                scene.get("labels"),
            )
            save_potentials_ply(
                out / f"{prefix}{name}_potentials.ply",
                self.ds.pot_points[i],
                self.ds.potentials[i],
            )
            if html:
                from mvkpconv_tpu_torch.utils.html_viewer import (
                    prediction_viewer_html,
                )

                prediction_viewer_html(
                    out / f"{prefix}{name}_viewer.html",
                    scene["points"],
                    probs.argmax(-1),
                    scene.get("labels"),
                    class_names=class_names,
                    title=str(name),
                )

    def score_reprojected(
        self, full_scenes: Sequence[Dict[str, np.ndarray]]
    ) -> Evaluator:
        """Score on full-resolution clouds via 1-NN reprojection
        (test_proj, tester.py:259-318)."""
        from scipy.spatial import cKDTree

        ev = Evaluator(ignore_label=self.ignore_label)
        for scene, probs, full in zip(self.ds.scenes, self.probs, full_scenes):
            _, nn = cKDTree(scene["points"]).query(full["points"])
            pred = probs.argmax(-1)[nn]
            ev.update(pred, full["labels"])
        return ev


def validation_sweep(
    dataset: SphereDataset,
    predict_fn: Callable,
    num_classes: int,
    num_batches: int,
    val_proportions: Optional[np.ndarray] = None,
    smooth: float = 0.95,
    ignore_label: int = -1,
    artifact_dir=None,
) -> Dict[str, float]:
    """Training-time validation (trainer.py:283-537): a bounded sphere sweep
    with smoothed probs, confusion optionally rescaled to the true class
    proportions, returning mIoU. With ``artifact_dir``, also dumps the
    prediction/potentials PLYs the reference writes during validation
    (trainer.py:483-517)."""
    tester = VotingTester(
        dataset, predict_fn, num_classes, num_votes=np.inf, smooth=smooth,
        ignore_label=ignore_label,
    )
    for _ in range(num_batches):
        batch = dataset.sample_batch()
        probs = np.asarray(predict_fn(device_batch(batch)))
        tester._accumulate(batch, probs)
    if artifact_dir is not None:
        tester.save_artifacts(artifact_dir)
    conf = tester.score().confusion
    if val_proportions is not None:
        conf = rescale_confusion_to_proportions(conf, val_proportions)
    iou = iou_from_confusion(conf)
    return {"miou": float(iou.mean()), "class_iou": iou}
