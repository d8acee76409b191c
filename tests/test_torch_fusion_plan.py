"""PyTorch port: the launch plan ``chip_smoke.py`` holds the card's train
steps to, checked on the CPU against what a train step of early, middle and
late fusion calls, on the default path (prebuilt influence cache) and the
fused one (K4).

``chip_smoke.py`` counts the kernels' launches on the card and compares them
with counts it reads off the model's plan: ``trunk_gathers`` (one K3 sum a
trunk gather whose features need a gradient), ``gather_vjp_widths`` (their
row widths) and ``conv_blocks`` (K4's forward and ``wf`` a rigid conv block,
``bwd_x`` a block whose input needs a gradient), all three through
``fed_raw`` (an encoder's first block fed the batch's own features has
neither a gather VJP nor a ``bwd_x``). Middle fusion has two encoders:
``encoder_3d``'s first block takes the base columns (no gradient), and
``encoder_2d``'s takes ones ⊕ the lifted features, whose gradient reaches
the trained FeatureAggregation (a gather VJP, 65 wide, or 68 with the
positions on the fused path, and a ``bwd_x``). Late fusion joins the lifted
features after the decoder: no gather of them. On CPU tensors every wrapper
runs its plain version, so the calls are counted at the functions the
gather VJP and the fused Function call.
"""

import collections

import numpy as np
import pytest

import chip_smoke
from mvkpconv_tpu_torch.data.synthetic_batch import make_batch
from mvkpconv_tpu_torch.infer import FUSED_OPTIONS, batch_to_device
from mvkpconv_tpu_torch.ops import gather
from mvkpconv_tpu_torch.ops.kernels import kpconv as k4
from mvkpconv_tpu_torch.train import make_trainer, train_steps
from mvkpconv_tpu_torch.training.config import KPConfig
from torch_threads import two_threads  # noqa: F401,E402  (autouse: two intra-op threads)

SMALL = dict(
    in_features_dim=66,
    architecture=("simple", "resnetb", "resnetb_strided", "resnetb", "nearest_upsample", "unary"),
    num_points=(256, 64), conv_neighbors=(10, 10), pool_neighbors=(10,),
    first_features_dim=16, num_views=2, image_height=24, image_width=32,
)


@pytest.mark.parametrize("fused", [False, True], ids=["default", "fused"])
@pytest.mark.parametrize("fusion", ["early", "middle", "late"])
def test_launch_plan_matches_the_train_step(fusion, fused, monkeypatch):
    cfg = KPConfig(**SMALL, fusion=fusion, **(FUSED_OPTIONS if fused else {}))
    trainer = make_trainer(cfg, "cpu", seed=0)
    batch = batch_to_device(make_batch(cfg, 2, np.random.RandomState(0)), "cpu")
    widths, calls = [], collections.Counter()
    segsum = gather.segsum

    def spy_segsum(rows, index, ns, round_bf16=False, plans=None):
        widths.append(rows.shape[1])
        return segsum(rows, index, ns, round_bf16, plans)

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(gather, "segsum", spy_segsum)
    for name in ("kpconv_fused_fwd", "kpconv_fused_bwd_x", "kpconv_wf"):
        monkeypatch.setattr(k4, name, counted(name, getattr(k4, name)))
    loss = float(train_steps(trainer, batch, 1)[0]["loss"])
    model = trainer.model

    assert np.isfinite(loss)
    assert chip_smoke.fed_raw(model) == (fusion != "early")
    assert len(widths) == chip_smoke.trunk_gathers(model)
    assert sorted(widths) == chip_smoke.gather_vjp_widths(model, cached=not fused)
    first_2d = cfg.feature_2d_dim + 1 + (3 if fused else 0)  # encoder_2d's first gather
    assert (first_2d in widths) == (fusion == "middle")
    n_conv, n_bwd_x = chip_smoke.conv_blocks(model)
    assert n_conv == 4 * len(model.encoders)  # the decoder has none at this architecture
    assert n_bwd_x == n_conv - (fusion != "early")
    assert chip_smoke.runs_k4(cfg) == fused
    want = {"kpconv_fused_fwd": n_conv, "kpconv_wf": n_conv, "kpconv_fused_bwd_x": n_bwd_x}
    assert dict(calls) == (want if fused else {})
    assert all(p.grad is not None for n, p in model.named_parameters() if not n.startswith("net_2d."))
