"""The loop ``closed_infer_chunks``: one caller in a closed loop through
``tools/test_mvpnet.py``'s path: ``infer.make_model(cfg, kind="mvpnet")``
(its UNet frozen), ``training.steps.make_eval_step(model, cfg)``,
``infer.batch_to_device`` of the chunk batch with the keys that
``train_mvpnet.chunk_batch(..., no_images=False)`` keeps, ``.cpu()`` of the
probabilities. Each batch is timed from the hand-off of its host arrays
until its probabilities are on the host.

Only the program and its feed differ from ``closed_infer``: the warm-up,
the window, the check and the faults are that loop's. The configuration's
``num_centroids`` are the program's own (``make_model`` builds PN2SSG at
the published ones); ``build`` refuses a configuration that states others.
"""

from __future__ import annotations

from typing import Dict

from portbench.harness import Program
from portbench.loops.closed_infer import FAULTS, KIND, TRAINS, Infer, check_run, drive, warm

__all__ = ["FAULTS", "KIND", "TRAINS", "build", "check_run", "drive", "warm"]

BENCHMARK_KEYS = ("mask",)  # host keys the benchmark reads and the program is not handed


def port_config(model: Dict, overrides=None):
    """The program's ``KPConfig`` of the configuration's model dict, as
    ``tools/test_mvpnet.py`` loads a run's: the fields the dict names over
    the defaults, not validated (``validate`` checks the KP-FCNN feature
    widths, which MVPNet does not read)."""
    import dataclasses

    from mvkpconv_tpu_torch.training.config import KPConfig

    names = {f.name for f in dataclasses.fields(KPConfig)}
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in model.items() if k in names}
    return KPConfig(**kw).replace(**(overrides or {}))


class InferChunks(Infer):
    def __init__(self, model: Dict, conf: Dict, weights, device, overrides=None):
        from mvkpconv_tpu_torch.infer import batch_to_device, make_model
        from mvkpconv_tpu_torch.tools.train_mvpnet import chunk_batch
        from mvkpconv_tpu_torch.training.steps import make_eval_step

        Program.__init__(self, device)
        cfg = port_config(model, overrides)
        self.net = make_model(cfg, self.device, seed=0, freeze_2d=conf.get("freeze_2d", True), kind="mvpnet")
        built = [getattr(self.net.net_3d, f"sa{i}").num_centroids for i in range(self.net.net_3d.num_sa)]
        if built != list(model["num_centroids"]):
            raise ValueError(f"the program builds centroids {built}; the configuration states "
                             f"{model['num_centroids']}")
        self.net.load_state_dict(weights, strict=True)
        self._step = make_eval_step(self.net, cfg)
        self._feed = lambda host: batch_to_device(
            chunk_batch({k: v for k, v in host.items() if k not in BENCHMARK_KEYS}, False), self.device)


def build(model: Dict, conf: Dict, weights, device, overrides=None) -> InferChunks:
    return InferChunks(model, conf, weights, device, overrides)
