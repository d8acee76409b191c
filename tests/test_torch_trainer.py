"""PyTorch port: the training loop around the train step — ``Checkpointer``,
``Trainer``, ``load_2d_checkpoint``, the unfrozen 2D net and
``remat='blocks'`` — on the CPU (every kernel as its plain version), and
against the JAX package's ``Trainer`` and train step.

Contracts:
  * ``Trainer.fit`` against the JAX ``Trainer`` (KPFCNN, the CLI test size,
    gather VJP ``scatter``, the same scenes and dataset seed, the same
    weights through ``convert.py``): each step's loss within rtol 2e-4 and
    accuracy within 5e-3 (the train-step contract, ROADMAP queue 3), the
    checkpointed parameters and BN statistics within rtol 2e-4, atol 2e-5;
  * the unfrozen early-fusion step against JAX on a full sphere batch (no
    padded row): the loss within 1e-5 relative, every gradient (the UNet's
    and FeatureAggregation's as a whole, below) and the state after the
    step within rtol 2e-4, atol 2e-5. The lift's gradients follow rounding
    once the UNet trains (ReLU flips in the UNet and in FeatureAggregation,
    and biases before a train-mode BN, whose true gradient is 0): with every
    weight scaled by 1 + 1e-7·N(0, 1), JAX against itself moves
    ``net_2d.layer1_0.conv1``'s by 11.7× that allowance (seed 1), the port
    against itself ``feat_aggreg.mlp.dense0``'s by 29× (seed 2), and all the
    UNet's together by up to 8.5e-4 of their norm; so the lift's gradients
    are held together: ‖port − JAX‖ ≤ 2e-3 · ‖JAX‖ (read: 3.9e-4). On a
    padded sphere batch FeatureAggregation's BN, which takes no mask in
    either package, normalizes over the padded rows' pixel neighbors, which
    the two packages' pixel selections pick differently where their d² tie;
    there the train-mode forward differs (N0=384 with 8 and 65 padded rows:
    loss 3.25540 against JAX's 3.24936, logits by 1.9 of 7.1), while JAX
    against itself with a 1e-7 weight jitter moves by 7e-5 (ROADMAP queue
    3);
  * the UNet in training mode with ``compute_dtype=bfloat16``: BN returns
    f32 and ``feature`` is f32, as far from the f32 UNet's as JAX's bf16
    one (within 2×);
  * ``remat='blocks'`` against ``remat='none'``: loss, gradients, parameters
    and BN running statistics equal bit for bit after 2 steps;
  * resume: 2 steps, a checkpoint, 2 more from it equal 4 straight steps bit
    for bit (parameters, statistics, momentum and the schedule's count).
"""

import functools
import json

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from mvkpconv_tpu.data import native as jax_native  # noqa: E402
from mvkpconv_tpu.data import spheres as jax_spheres  # noqa: E402
from mvkpconv_tpu.data import synthetic as jax_synthetic  # noqa: E402
from mvkpconv_tpu.models import KPFCNN as JaxKPFCNN  # noqa: E402
from mvkpconv_tpu.models import MVKPConv as JaxMVKPConv  # noqa: E402
from mvkpconv_tpu.models.unet2d import UNetResNet34 as JaxUNet  # noqa: E402
from mvkpconv_tpu.ops.pyramid import build_pyramid as jax_build_pyramid  # noqa: E402
from mvkpconv_tpu.training.config import KPConfig as JaxConfig  # noqa: E402
from mvkpconv_tpu.training.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from mvkpconv_tpu.training.steps import (  # noqa: E402
    create_train_state,
    make_apply_fn,
    make_train_step as jax_make_train_step,
)
from mvkpconv_tpu.training.trainer import Trainer as JaxTrainer  # noqa: E402
from mvkpconv_tpu_torch.convert import load_jax_variables  # noqa: E402
from mvkpconv_tpu_torch.data import native, spheres, synthetic  # noqa: E402
from mvkpconv_tpu_torch.infer import batch_to_device  # noqa: E402
from mvkpconv_tpu_torch.models import norm  # noqa: E402
from mvkpconv_tpu_torch.models.kpfcnn import KPFCNN  # noqa: E402
from mvkpconv_tpu_torch.models.mvkpconv import MVKPConv  # noqa: E402
from mvkpconv_tpu_torch.models.unet2d import UNetResNet34  # noqa: E402
from mvkpconv_tpu_torch.train import make_trainer, train_steps  # noqa: E402
from mvkpconv_tpu_torch.training.checkpoint import Checkpointer  # noqa: E402
from mvkpconv_tpu_torch.training.config import KPConfig  # noqa: E402
from mvkpconv_tpu_torch.training.init import init_parameters  # noqa: E402
from mvkpconv_tpu_torch.training.optim import make_optimizer  # noqa: E402
from mvkpconv_tpu_torch.training.steps import forward_backward, make_train_step  # noqa: E402
from mvkpconv_tpu_torch.training.trainer import Trainer  # noqa: E402
from mvkpconv_tpu_torch.training.transfer import load_2d_checkpoint  # noqa: E402
from test_torch_slice import random_variables  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-5)
ACC_ABS = 5e-3

# tests/test_tools.py's TINY, the JAX CLI test size
TINY = dict(
    architecture=("simple", "resnetb_strided", "nearest_upsample", "unary"),
    num_points=(256, 64), conv_neighbors=(8, 8), pool_neighbors=(8,),
    first_features_dim=16, first_subsampling_dl=0.1, in_radius=1.0,
    batch_num=2, epoch_steps=2, validation_size=2,
    num_views=2, image_height=24, image_width=32,
)
BASELINE = dict(TINY, fusion="none", in_features_dim=2, gather_transpose="scatter")
EARLY = dict(TINY, fusion="early", in_features_dim=66, gather_transpose="scatter",
             pixel_patch_dtype="float32")


def make_scenes(pkg, views):
    out = []
    for s in range(2):
        scene = pkg.make_scene(seed=s, num_points=6000)
        if views:
            scene.update(pkg.render_views(scene, 6, 24, 32, seed=s))
        out.append(scene)
    return out


def port_dataset(kw, seed=0):
    return spheres.SphereDataset(make_scenes(synthetic, kw["fusion"] != "none"),
                                 KPConfig(**kw), training=True, seed=seed)


def jax_dataset(kw, monkeypatch, seed=0):
    """The JAX package's dataset on its numpy host ops; the port's native
    library is switched off as well, for the port's dataset built after it."""
    monkeypatch.setattr(jax_native, "_load", lambda: None)
    monkeypatch.setattr(native, "_load", lambda: None)
    return jax_spheres.SphereDataset(make_scenes(jax_synthetic, kw["fusion"] != "none"),
                                     JaxConfig(**kw), training=True, seed=seed)


def jax_variables(model, jcfg, batch):
    """Random flax variables of ``model`` for ``batch``'s shapes (no flax
    init is run)."""
    def init():
        b = {k: jnp.asarray(v) for k, v in batch.items()}
        pyr = jax_build_pyramid(b["points"], b["mask"], jcfg.pyramid_spec())
        x = b["features"] if jcfg.fusion == "none" else b
        return model.init(jax.random.PRNGKey(0), x, pyr)

    return random_variables(jax.eval_shape(init))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def assert_states_close(got, want, what, skip=()):
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        if k.startswith(skip):
            continue
        np.testing.assert_allclose(got[k].detach().float().numpy(), w.detach().float().numpy(),
                                   err_msg=f"{what}: {k}", **TOL)


def scalars(run_dir):
    out = {}
    for line in (run_dir / "scalars.jsonl").read_text().splitlines():
        rec = json.loads(line)
        out.setdefault(rec["tag"], {})[rec["step"]] = rec["value"]
    return out


# ---------------------------------------------------------------- checkpoints

def test_checkpointer_round_trip_gc_tag_and_best(tmp_path):
    ck = Checkpointer(tmp_path / "ck", max_to_keep=2)
    assert ck.restore() is None and ck.latest_path() is None and ck.restore_best() is None
    states = {s: {"step": s, "model": {"w": torch.full((3,), float(s))}} for s in (1, 2, 3)}
    for s, st in states.items():
        ck.save(st, s, is_best=(s == 2))
    assert sorted(p.name for p in ck.dir.glob("ckpt_*")) == ["ckpt_00000002.pt", "ckpt_00000003.pt"]
    assert (ck.dir / "last_checkpoint").read_text() == "ckpt_00000003.pt"
    assert not list(ck.dir.glob("*.tmp"))
    got = ck.restore()
    assert got["step"] == 3 and torch.equal(got["model"]["w"], states[3]["model"]["w"])
    assert ck.restore_best()["step"] == 2
    assert ck.restore(ck.dir / "ckpt_00000002.pt")["step"] == 2
    (ck.dir / "last_checkpoint").write_text("ckpt_00000009.pt")  # a tag to a collected file
    assert ck.latest_path().name == "ckpt_00000003.pt"


# ---------------------------------------------------------------- Trainer

def port_setup(kw, out, seed=0, **trainer_kw):
    cfg = KPConfig(**kw)
    setup = make_trainer(cfg, "cpu", seed=seed)
    return Trainer(setup.step, setup.model, setup.optimizer, str(out), cfg, **trainer_kw)


def fixed_batches(n):
    ds = port_dataset(BASELINE)
    return [spheres.device_batch(ds.sample_batch()) for _ in range(n)]


def test_trainer_fit_writes_its_files_and_resumes(tmp_path):
    """3 steps: training.txt, scalars.jsonl, val_IoUs.txt, parameters.txt,
    checkpoints every epoch (2 steps) and at the end, the kill file gone, a
    profiler trace of step 3; then a second Trainer on the same directory
    resumes at step 3."""
    batches = fixed_batches(3)
    evals = []

    def eval_fn():
        evals.append(1)
        return {"miou": 0.5 + len(evals), "class_iou": np.full(20, 0.25)}

    tr = port_setup(BASELINE, tmp_path, eval_fn=eval_fn, log_period=1, profile_steps=1)
    assert tr.val_period == 2
    assert tr.fit(iter(batches), max_steps=3) == 3
    assert json.loads((tmp_path / "profile" / "trace.json").read_text())["traceEvents"]
    lines = (tmp_path / "training.txt").read_text().splitlines()
    assert lines[0] == "epochs steps out_loss offset_loss train_accuracy time"
    assert [ln.split()[:2] for ln in lines[1:]] == [["0", "1"], ["1", "2"], ["1", "3"]]
    assert len(evals) == 2  # at step 2, and the final validation at 3
    assert len((tmp_path / "val_IoUs.txt").read_text().splitlines()) == 2
    tags = scalars(tmp_path)
    assert sorted(tags["loss"]) == [1, 2, 3] and sorted(tags["val_miou"]) == [2, 3]
    assert all(np.isfinite(v) for v in tags["loss"].values())
    assert KPConfig.load(tmp_path / "parameters.txt") == KPConfig(**BASELINE)
    ck = tmp_path / "checkpoints"
    assert sorted(p.name for p in ck.glob("ckpt_*")) == ["ckpt_00000002.pt", "ckpt_00000003.pt"]
    assert (ck / "last_checkpoint").read_text() == "ckpt_00000003.pt"
    assert torch.load(ck / "model_best.pt", weights_only=True)["step"] == 3
    assert not (tmp_path / "running_PID.txt").exists()

    again = port_setup(BASELINE, tmp_path, seed=5)
    again.maybe_resume()
    assert again.step == 3
    saved = torch.load(ck / "ckpt_00000003.pt", weights_only=True)
    for k, v in again.model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k


def test_trainer_stops_when_the_kill_file_goes(tmp_path):
    batches = fixed_batches(3)
    tr = port_setup(BASELINE, tmp_path)

    def source():
        yield batches[0]
        (tmp_path / "running_PID.txt").unlink()  # a user deletes it mid-run
        yield from batches[1:]

    assert tr.fit(source(), max_steps=3, prefetch_depth=0) == 1
    assert (tmp_path / "checkpoints" / "last_checkpoint").read_text() == "ckpt_00000001.pt"


def test_resumed_run_equals_an_uninterrupted_one(tmp_path):
    """4 steps (the learning rate decays at step 2: epoch_steps=2, lr_decay
    0.5) straight, against 2 steps, a new Trainer resumed from their
    checkpoint, then 2 more: equal bit for bit."""
    kw = dict(BASELINE, lr_decay=0.5)
    batches = fixed_batches(4)
    straight = port_setup(kw, tmp_path / "a")
    straight.fit(iter(batches), max_steps=4, prefetch_depth=0)
    first = port_setup(kw, tmp_path / "b")
    first.fit(iter(batches), max_steps=2, prefetch_depth=0)
    resumed = port_setup(kw, tmp_path / "b", seed=9)
    resumed.maybe_resume()
    resumed.fit(iter(batches[resumed.step:]), max_steps=4, prefetch_depth=0)
    want, got = straight.state_dict(), resumed.state_dict()
    assert got["step"] == want["step"] == 4
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    assert [g["count"] for g in got["optimizer"]["param_groups"]] == [4]
    for i, st in want["optimizer"]["state"].items():
        assert torch.equal(got["optimizer"]["state"][i]["momentum_buffer"], st["momentum_buffer"]), i


def test_trainer_fit_matches_jax_trainer(tmp_path, monkeypatch):
    """2 steps of both Trainers (KPFCNN) on the same scenes, dataset seed
    and weights: the per-step loss and accuracy (``scalars.jsonl``, logged
    every step; ``training.txt`` agrees to its 3 decimals) and the
    checkpointed state."""
    jcfg = JaxConfig(**BASELINE)
    jds = jax_dataset(BASELINE, monkeypatch)
    ds = port_dataset(BASELINE)
    jmodel = JaxKPFCNN(jcfg)
    variables = jax_variables(jmodel, jcfg, jax_spheres.device_batch(
        jax_dataset(BASELINE, monkeypatch, seed=1).sample_batch()))
    tx = jax_make_optimizer(jcfg)
    jstep = jax_make_train_step(make_apply_fn(jmodel, jcfg, "kpfcnn"), tx, jcfg)
    jt = JaxTrainer(jstep, create_train_state(variables, tx), str(tmp_path / "jax"), jcfg, log_period=1)
    jt.fit((jax_spheres.device_batch(b) for b in jds.batches()), max_steps=2)

    cfg = KPConfig(**BASELINE)
    model = load_jax_variables(KPFCNN(cfg), np_tree(variables))
    opt = make_optimizer(model, cfg)
    tr = Trainer(make_train_step(model, cfg, opt), model, opt, str(tmp_path / "port"), cfg, log_period=1)
    tr.fit((spheres.device_batch(b) for b in ds.batches()), max_steps=2)

    got, want = scalars(tmp_path / "port"), scalars(tmp_path / "jax")
    assert sorted(got["loss"]) == sorted(want["loss"]) == [1, 2]
    np.testing.assert_allclose([got["loss"][s] for s in (1, 2)], [want["loss"][s] for s in (1, 2)], rtol=2e-4)
    for s in (1, 2):
        assert abs(got["accuracy"][s] - want["accuracy"][s]) <= ACC_ABS
    rows = [[ln.split()[:3] for ln in (tmp_path / d / "training.txt").read_text().splitlines()[1:]]
            for d in ("port", "jax")]
    assert [r[:2] for r in rows[0]] == [r[:2] for r in rows[1]]
    np.testing.assert_allclose([float(r[2]) for r in rows[0]], [float(r[2]) for r in rows[1]], atol=1.5e-3)
    saved = Checkpointer(tmp_path / "port" / "checkpoints").restore()
    assert saved["step"] == int(jt.state.step) == 2
    jstate = load_jax_variables(KPFCNN(cfg), {"params": np_tree(jt.state.params),
                                              "batch_stats": np_tree(jt.state.batch_stats)})
    assert_states_close(saved["model"], jstate.state_dict(), "checkpoint after 2 steps")


# ---------------------------------------------------------------- the unfrozen 2D net

def test_unet_train_mode_bn_is_f32_and_matches_jax():
    """The JAX UNet's BN has ``dtype=None`` in training mode: with a bf16
    compute dtype its outputs, the residual sums and ``feature`` are f32.
    The port's does the same. Against the f32 UNet's ``feature`` (train
    mode, the same weights) the port's bf16 one is as far as JAX's bf16 one:
    within 2× JAX's largest and mean distance (read: 0.167 against 0.113,
    0.0086 against 0.0066, of max |feature| 5.87); at eval the output is
    bf16."""
    img = np.random.RandomState(0).rand(2, 24, 32, 3).astype(np.float32)
    jnet = JaxUNet(20, dtype=jnp.bfloat16)
    variables = random_variables(jax.eval_shape(
        lambda: jnet.init(jax.random.PRNGKey(0), jnp.asarray(img))))
    def train_mode(net):
        return jax.jit(lambda v, x: net.apply(v, x, train=True, mutable=["batch_stats"])[0])(
            variables, jnp.asarray(img))

    want = train_mode(jnet)
    truth = np.asarray(train_mode(JaxUNet(20, dtype=jnp.float32))["feature"])
    net = load_jax_variables(UNetResNet34(20, dtype=torch.bfloat16), np_tree(variables)).train()
    bns = [m for m in net.modules() if isinstance(m, norm.BatchNorm)]
    bn_out = []
    for mod in bns:
        mod.register_forward_hook(lambda m, i, o: bn_out.append(o.dtype))
    with torch.no_grad():
        got = net(torch.from_numpy(img))
    assert bn_out == [torch.float32] * len(bns) and len(bns) == 44
    assert got["feature"].dtype == torch.float32 and want["feature"].dtype == jnp.float32
    err = np.abs(got["feature"].numpy() - truth)
    jerr = np.abs(np.asarray(want["feature"]) - truth)
    assert err.max() <= 2 * jerr.max() and err.mean() <= 2 * jerr.mean(), (err.max(), jerr.max())
    net.eval()
    with torch.no_grad():
        assert net(torch.from_numpy(img))["feature"].dtype == torch.bfloat16


@functools.lru_cache(maxsize=None)
def early_inputs():
    """A sphere batch with views (full: no padded row) and random JAX
    variables."""
    with pytest.MonkeyPatch.context() as mp:
        batch = spheres.device_batch(jax_dataset(EARLY, mp).sample_batch())
    jcfg = JaxConfig(**EARLY)
    return batch, jax_variables(JaxMVKPConv(jcfg, freeze_2d=False), jcfg, batch)


@pytest.mark.slow  # ~17 s on one CPU core set: JAX compiles the step with the UNet
def test_unfrozen_early_fusion_step_matches_jax():
    """One train step of MV-KPConv early fusion with the UNet trained end to
    end (BN batch statistics, gradients through the lift gather), on a full
    sphere batch: loss, gradients before the update (the UNet's too), and
    parameters and statistics after it."""
    batch, variables = early_inputs()
    assert batch["mask"].all()  # see the module docstring on padded rows
    jcfg = JaxConfig(**EARLY)
    jmodel = JaxMVKPConv(jcfg, freeze_2d=False)
    from test_torch_deformable import recording

    tx = recording(jax_make_optimizer(jcfg))
    jstep = jax_make_train_step(make_apply_fn(jmodel, jcfg, "mvkpconv"), tx, jcfg, donate=False)
    state, jm = jstep(create_train_state(variables, tx), {k: jnp.asarray(v) for k, v in batch.items()})
    jgrads = state.opt_state[1]
    cfg = KPConfig(**EARLY)
    want_grads = dict(load_jax_variables(MVKPConv(cfg, freeze_2d=False), {
        "params": np_tree(jgrads), "batch_stats": variables["batch_stats"]}).named_parameters())
    want_state = load_jax_variables(MVKPConv(cfg, freeze_2d=False), {
        "params": np_tree(state.params), "batch_stats": np_tree(state.batch_stats)}).state_dict()

    setup = make_trainer(cfg, "cpu", freeze_2d=False)
    load_jax_variables(setup.model, np_tree(variables))
    tb = batch_to_device(batch, "cpu")
    setup.optimizer.zero_grad()
    loss, _ = forward_backward(setup.model, cfg, tb)
    np.testing.assert_allclose(float(loss), float(jm["loss"]), rtol=1e-5)
    # the 2D head (``logit``) reaches no 3D loss: no gradient (JAX's zeros)
    assert {n for n, p in setup.model.named_parameters() if p.grad is None} == {
        "net_2d.logit.weight", "net_2d.logit.bias"}
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in setup.model.named_parameters()}
    lift = sorted(n for n in grads if n.startswith(("net_2d.", "feat_aggreg.")))
    got_lift = torch.cat([grads[n].flatten() for n in lift])
    want_lift = torch.cat([want_grads[n].detach().flatten() for n in lift])
    assert float((got_lift - want_lift).norm()) <= 2e-3 * float(want_lift.norm())
    assert_states_close({k: v for k, v in grads.items() if k not in lift},
                        {k: v for k, v in want_grads.items() if k not in lift}, "grad")
    setup.optimizer.step()
    assert_states_close(setup.model.state_dict(), want_state, "state after 1")


def test_load_2d_checkpoint_into_fills_net_2d_and_a_frozen_net_stays(tmp_path):
    cfg = KPConfig(**EARLY)
    unet = init_parameters(UNetResNet34(cfg.num_classes), seed=3)
    Checkpointer(tmp_path / "run2d" / "checkpoints").save({"step": 7, "model": unet.state_dict()}, 7)
    setup = make_trainer(cfg, "cpu", seed=0, freeze_2d=True)
    load_2d_checkpoint(setup.model.net_2d, tmp_path / "run2d")
    for k, v in unet.state_dict().items():
        assert torch.equal(setup.model.net_2d.state_dict()[k], v), k
    before = {k: v.clone() for k, v in setup.model.state_dict().items()}
    batch = batch_to_device(early_inputs()[0], "cpu")
    train_steps(setup, batch, 1)
    after = setup.model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items() if k.startswith("net_2d."))
    assert all(not torch.equal(p, before[n]) for n, p in setup.model.named_parameters()
               if not n.startswith("net_2d."))

    wide = UNetResNet34(cfg.num_classes + 1)
    Checkpointer(tmp_path / "wide" / "checkpoints").save({"step": 1, "model": wide.state_dict()}, 1)
    with pytest.raises(ValueError, match="logit.weight shape"):
        load_2d_checkpoint(setup.model.net_2d, tmp_path / "wide")
    with pytest.raises(FileNotFoundError):
        load_2d_checkpoint(setup.model.net_2d, tmp_path / "nothing")


def test_unfrozen_2d_net_trains():
    cfg = KPConfig(**EARLY)
    setup = make_trainer(cfg, "cpu", seed=0, freeze_2d=False)
    assert setup.model.net_2d.training
    n_2d = sum(1 for n, _ in setup.model.named_parameters() if n.startswith("net_2d."))
    assert sum(len(g["params"]) for g in setup.optimizer.param_groups) == len(list(setup.model.parameters()))
    before = {k: v.clone() for k, v in setup.model.net_2d.state_dict().items()}
    train_steps(setup, batch_to_device(early_inputs()[0], "cpu"), 1)
    moved = {k for k, v in setup.model.net_2d.state_dict().items() if not torch.equal(v, before[k])}
    # every weight and statistic but the 2D head's, which no 3D loss reaches
    assert moved == {k for k in before if not k.startswith("logit.")} and n_2d > 0


# ---------------------------------------------------------------- remat

def test_remat_blocks_equals_none_bit_for_bit():
    """``remat='blocks'`` recomputes every rigid conv block in the backward:
    2 steps from the same weights give the same loss, gradients,
    parameters and BN running statistics as ``remat='none'`` (the
    recompute updates no running statistic)."""
    batch = batch_to_device(fixed_batches(1)[0], "cpu")
    runs = {}
    for remat in ("none", "blocks"):
        cfg = KPConfig(**dict(BASELINE, remat=remat, gather_transpose="banded_bf16"))
        setup = make_trainer(cfg, "cpu", seed=0)
        losses = [float(m["loss"]) for m in train_steps(setup, batch, 2)]
        grads = {n: p.grad.clone() for n, p in setup.model.named_parameters() if p.grad is not None}
        runs[remat] = losses, grads, setup.model.state_dict()
    (l0, g0, s0), (l1, g1, s1) = runs["none"], runs["blocks"]
    assert l0 == l1 and sorted(g0) == sorted(g1)
    for k, v in g0.items():
        assert torch.equal(g1[k], v), f"grad {k}"
    for k, v in s0.items():
        assert torch.equal(s1[k], v), f"state {k}"


@pytest.mark.slow  # a witness: 4 CPU Trainer steps at the card parity's size, the UNet trained (~20 s)
@pytest.mark.parametrize("host_ops", ["numpy", "native"])
def test_unfrozen_trainer_steps_follow_rounding_on_the_native_ops_batches(host_ops, tmp_path, monkeypatch):
    """The witness of why ``chip_smoke.py`` ``trainer_parity`` builds its
    dataset on the numpy host ops. At its configuration (ARCHITECTURE_DEEPER,
    N0=1024, width 32, 3 views of 24x32, B=5, the UNet trained, 'banded'),
    2 Trainer steps of the port against themselves with a 1e-7 relative
    weight jitter, on the first batches of ``SphereDataset(seed=0)`` over
    ``synthetic:1``: on the numpy host ops every tensor stays within 0.001
    of the card parity's allowance (rtol 1e-3, atol 1e-5·max|param|); on
    the native ops (voxels listed in first-seen order, so other spheres)
    the UNet's statistics and weights move by 28x it (150 tensors outside),
    the card against the CPU by 20.9x (NVIDIA H100 80GB HBM3, 700 W)."""
    from mvkpconv_tpu_torch.tools.common import load_scenes
    from mvkpconv_tpu_torch.training.config import ARCHITECTURE_DEEPER

    if host_ops == "numpy":
        monkeypatch.setattr(native, "_load", lambda: None)
    elif not native.available():
        pytest.skip("the native host ops do not build here")
    cfg = KPConfig(fusion="early", in_features_dim=66, architecture=ARCHITECTURE_DEEPER,
                   num_points=(1024, 256, 64, 32, 16), conv_neighbors=(16,) * 5, pool_neighbors=(16,) * 4,
                   first_features_dim=32, num_views=3, image_height=24, image_width=32,
                   gather_transpose="banded", epoch_steps=100)
    scenes = load_scenes("synthetic:1", True, cfg.num_views, (cfg.image_height, cfg.image_width))
    states = []
    for jitter in (0.0, 1e-7):
        setup = make_trainer(cfg, "cpu", seed=1, freeze_2d=False)
        if states:
            setup.model.load_state_dict(states[0][0])
            gen = torch.Generator().manual_seed(5)
            with torch.no_grad():
                for p in setup.model.parameters():
                    p.mul_(1 + jitter * torch.randn(p.shape, generator=gen))
        start = {k: v.clone() for k, v in setup.model.state_dict().items()}
        ds = spheres.SphereDataset(scenes, cfg, training=True, seed=0)
        trainer = Trainer(setup.step, setup.model, setup.optimizer, str(tmp_path / str(jitter)), cfg)
        trainer.fit((spheres.device_batch(b) for b in ds.batches()), max_steps=2)
        states.append((start, trainer.model.state_dict()))
    want, got = states[0][1], states[1][1]
    atol = 1e-5 * max(float(v.abs().max()) for v in want.values() if v.is_floating_point())
    over = {k: float(((got[k] - v).abs() / (1e-3 * v.abs() + atol)).max())
            for k, v in want.items() if v.is_floating_point()}
    worst = max(over.values())
    if host_ops == "numpy":
        assert worst < 0.01, worst
    else:
        assert worst > 10 and max(over, key=over.get).startswith("net_2d."), (worst, max(over, key=over.get))
