"""PyTorch port: data parallelism (``mvkpconv_tpu_torch/parallel/``) against
the JAX package's ``parallel/`` and its single-device step.

Checked, on the CPU over gloo process groups (``parallel.spawn``: a file
rendezvous, one thread a process, a timeout that kills what it started):

  * ``shard_scenes`` / ``local_batch_size`` equal JAX's, errors included;
  * ``model_sharding`` decides, parameter by parameter, as JAX's does on a
    (4, 2) mesh of its 8 virtual CPU devices (the same weights, their names
    converted; the port splits the dimension that is JAX's last);
  * the world-2 data-parallel step (KPFCNN at ``tests/test_parallel.py``'s
    (4, 2)-mesh configuration, 4 spheres, 2 a process; the same with a
    deformable block, and with ``segloss_balance='class'``) against the
    port's single-process step on the whole batch, at the tolerances JAX
    holds its own sharded step to (loss rtol 1e-5; parameters and BN
    statistics rtol 1e-4, atol 1e-6), and against JAX's single-device
    ``make_train_step`` from the same weights under the train-step contract
    (f32, ``scatter``: rtol 2e-4, atol 2e-5); the same step with one global
    sum left local (a planted fault: the masked BN's statistics, the
    regularizer's denominators, the loss's class counts) must fail the
    first comparison;
  * ``Trainer.fit`` over 2 processes, as ``tests/multihost_worker.py``
    drives the JAX Trainer, with the global batch of
    ``global_batch_from_local`` and its content summed across the processes;
  * ``train_scannet`` as ``torchrun`` starts it in 2 processes: each owns
    its share of the scenes, samples its share of the batch from its own
    seed, writes its own run directory, and both end with equal weights;
  * ``dryrun_multichip(4, device='cpu')`` on its (data=2, model=2) mesh: a
    finite loss, parameters stored sharded over ``model``, the loss and the
    trained parameters of the single-process step on the whole batch.

The workers are this module's functions; JAX is imported only inside the
tests, so the spawned processes load torch and the port alone. The
single-process references run on rank 0 of the spawned one-thread
processes: in this (pytest) process the CPU kernels sum in another order
now and then, and at these small sizes that can flip a leaky ReLU and move
a parameter past the tolerance (one failure in about 25 runs when the
reference ran here).
"""

import contextlib
import functools

import numpy as np
import pytest
import torch
from torch import nn

from mvkpconv_tpu_torch.parallel import (
    dryrun_multichip,
    global_batch_from_local,
    local_batch_size,
    make_mesh,
    model_sharding,
    shard_batch,
    shard_scenes,
    spawn,
)
from mvkpconv_tpu_torch.training.config import KPConfig
from torch_threads import two_threads  # noqa: F401,E402  (autouse: two intra-op threads)

# tests/test_parallel.py:112-124, the KPFCNN of the (data=4, model=2) test
CFG = dict(
    fusion="none", num_points=(256, 64), conv_neighbors=(10, 10), pool_neighbors=(10,),
    architecture=("simple", "resnetb_strided", "nearest_upsample", "unary"),
    in_radius=1.0, first_subsampling_dl=0.1, in_features_dim=2, first_features_dim=64,
    num_classes=20, batch_num=4, gather_transpose="scatter",
)
# the world-2 step's cases: the KPFCNN, with a deformable block, with class-balanced loss
CASES = {
    "kpfcnn": CFG,
    "deform": dict(CFG, architecture=("simple", "resnetb_deformable_strided", "nearest_upsample", "unary")),
    "class": dict(CFG, segloss_balance="class"),
}
SHARDED = dict(loss_rtol=1e-5, rtol=1e-4, atol=1e-6)  # JAX's sharded step against its single-device one
TRAIN_STEP = dict(rtol=2e-4, atol=2e-5)  # the port's train step against JAX's, f32 scatter
TIMEOUT = 300.0


@functools.lru_cache(maxsize=None)
def sphere_batch():
    """4 spheres of one synthetic scene (numpy), as tests/test_parallel.py samples them."""
    from mvkpconv_tpu_torch.data import synthetic
    from mvkpconv_tpu_torch.data.spheres import SphereDataset, device_batch

    ds = SphereDataset([synthetic.make_scene(seed=0, num_points=8000)], KPConfig(**CFG), training=False, seed=0)
    return device_batch(ds.sample_batch(4))


def build(case, state):
    from mvkpconv_tpu_torch.models.kpfcnn import KPFCNN
    from mvkpconv_tpu_torch.training.optim import make_optimizer

    cfg = KPConfig(**CASES[case])
    model = KPFCNN(cfg)
    model.load_state_dict(state)
    return cfg, model.train(), make_optimizer(model, cfg)


def step_result(model, metrics):
    return {"loss": float(metrics["loss"]), "accuracy": float(metrics["accuracy"]),
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


@contextlib.contextmanager
def planted_fault(case):
    """The case's statistic left to each process: the masked BN's sums
    (``kpfcnn``), the deformable regularizer's denominators (``deform``),
    the loss's class counts (``class``, its one 1-d sum)."""
    from mvkpconv_tpu_torch.models import blocks
    from mvkpconv_tpu_torch.training import losses

    saved = blocks.global_sum, blocks.global_sums, losses.global_sum, losses.p2p_fitting_regularizer
    real_sum, real_p2p = losses.global_sum, losses.p2p_fitting_regularizer

    def local_p2p(*args, **kw):
        losses.global_sum = lambda t: t
        try:
            return real_p2p(*args, **kw)
        finally:
            losses.global_sum = real_sum

    if case == "kpfcnn":
        blocks.global_sum = lambda t: t
        blocks.global_sums = lambda *t: t
    elif case == "deform":
        losses.p2p_fitting_regularizer = local_p2p
    else:
        losses.global_sum = lambda t: t if t.ndim == 1 else real_sum(t)
    try:
        yield
    finally:
        blocks.global_sum, blocks.global_sums, losses.global_sum, losses.p2p_fitting_regularizer = saved


def dp_steps(rank, world, states, batch):
    """A process of the world-2 step, for each case: the data-parallel step
    on its half of the batch (handed over as the global batch's shard,
    ``global_batch_from_local``); on rank 0 the single-process step on the
    whole batch, in the same one-thread process (the parent's threads sum
    in another order, which can flip a leaky ReLU of this small model);
    then the data-parallel step from the same state under the case's
    planted fault."""
    from mvkpconv_tpu_torch.infer import batch_to_device
    from mvkpconv_tpu_torch.training.steps import make_train_step

    mesh = make_mesh(device_type="cpu")
    whole = batch_to_device(batch, "cpu")
    local = shard_batch(whole, mesh)
    out = {}
    for case, state in states.items():
        cfg, model, opt = build(case, state)
        step = make_train_step(model, cfg, opt, mesh=mesh)
        res = {"dp": step_result(model, step(global_batch_from_local(local, mesh)))}
        if rank == 0:
            cfg, model, opt = build(case, state)
            res["single"] = step_result(model, make_train_step(model, cfg, opt)(whole))
        with planted_fault(case):
            cfg, model, opt = build(case, state)
            res["fault"] = step_result(model, make_train_step(model, cfg, opt, mesh=mesh)(local))
        out[case] = res
    return out


def assert_state_close(got, want, rtol, atol):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.detach().numpy(), rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("count", [1, 2, 3])
def test_shard_scenes_and_local_batch_match_jax(count):
    from mvkpconv_tpu import parallel as jp

    scenes = list(range(5))
    for index in range(count):
        assert shard_scenes(scenes, index, count) == jp.shard_scenes(scenes, index, count)
    for bad in ((count, count), (-1, count)):
        with pytest.raises(ValueError, match="out of range") as err:
            shard_scenes(scenes, *bad)
        with pytest.raises(ValueError) as jerr:
            jp.shard_scenes(scenes, *bad)
        assert str(err.value) == str(jerr.value)
    if count > 1:
        with pytest.raises(ValueError, match="owns no scenes") as err:
            shard_scenes([1], count - 1, count)
        with pytest.raises(ValueError) as jerr:
            jp.shard_scenes([1], count - 1, count)
        assert str(err.value) == str(jerr.value)
    for global_batch in (4, 5, 6):
        if global_batch % count:
            with pytest.raises(ValueError, match="not divisible"):
                local_batch_size(global_batch, count)
            with pytest.raises(ValueError):
                jp.local_batch_size(global_batch, count)
        else:
            assert local_batch_size(global_batch, count) == jp.local_batch_size(global_batch, count)
    # no process group: the defaults are this one process of one
    assert shard_scenes(scenes) == scenes and local_batch_size(6) == 6


@pytest.mark.parametrize("min_dim", [16, 64])
def test_model_sharding_matches_jax(min_dim):
    """Each parameter split or replicated as JAX's rule decides for the same
    weights on a (4, 2) mesh; split on the port dimension that holds JAX's
    last one (``convert.leaf_map``'s layout changes)."""
    import jax
    from jax.sharding import PartitionSpec as P
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard

    from mvkpconv_tpu.parallel import make_mesh as jax_make_mesh
    from mvkpconv_tpu.parallel import model_sharding as jax_model_sharding
    from mvkpconv_tpu_torch.convert import leaf_map

    port, variables = dryrun_weights()
    jplan = jax_model_sharding(jax_make_mesh((4, 2), ("data", "model")), variables["params"], min_dim=min_dim)
    mesh = DeviceMesh("cpu", torch.arange(8).reshape(4, 2), mesh_dim_names=("data", "model"),
                      _init_backend=False, _rank=0)
    plan = model_sharding(mesh, port, min_dim=min_dim)
    params = dict(port.named_parameters())
    seen = split = 0
    for key, col, fkey, (to_flax, _) in leaf_map(port):
        if col != "params":
            continue
        node = jplan
        for part in fkey.split("/"):
            node = node[part]
        want_split = node.spec != P()
        assert plan[key][0] == Replicate(), key
        got = plan[key][1]
        assert isinstance(got, Shard) == want_split, (key, got, node.spec)
        if want_split:
            # the port's split dimension becomes JAX's last one in the flax layout
            marker = np.zeros(tuple(params[key].shape), np.float32)
            marker[(slice(None),) * got.dim + (0,)] = 1.0
            assert to_flax(marker)[..., 0].all() and not to_flax(marker)[..., 1:].any(), key
            split += 1
        seen += 1
    assert seen == len(plan) and split > 0


@functools.lru_cache(maxsize=None)
def dryrun_weights():
    """The dry run's MV-KPConv in the port holding random JAX variables
    (drawn from ``jax.eval_shape`` of the JAX model's init), and those."""
    import jax

    from mvkpconv_tpu.models import MVKPConv as JaxMVKPConv
    from mvkpconv_tpu_torch.convert import load_jax_variables
    from mvkpconv_tpu_torch.models.mvkpconv import MVKPConv
    from mvkpconv_tpu_torch.parallel.launch import dryrun_config
    from test_torch_slice import random_variables

    cfg = dryrun_config(4)
    variables = random_variables(jax.eval_shape(
        lambda: JaxMVKPConv(cfg_jax(cfg)).init(jax.random.PRNGKey(0), *jax_inputs(cfg))))
    return load_jax_variables(MVKPConv(cfg), variables), variables


def cfg_jax(cfg):
    from mvkpconv_tpu.training.config import KPConfig as JaxConfig

    return JaxConfig(**{f: getattr(cfg, f) for f in ("fusion", "in_features_dim", "architecture", "num_points",
                                                      "conv_neighbors", "pool_neighbors", "first_features_dim",
                                                      "num_views", "image_height", "image_width", "batch_num")})


def jax_inputs(cfg):
    import jax.numpy as jnp

    from mvkpconv_tpu.ops.pyramid import build_pyramid
    from mvkpconv_tpu_torch.data.synthetic_batch import make_batch

    batch = {k: jnp.asarray(v) for k, v in make_batch(cfg, 1, np.random.RandomState(0)).items()}
    return batch, build_pyramid(batch["points"], batch["mask"], cfg_jax(cfg).pyramid_spec())


def jax_case(case, batch):
    """The JAX config, batch and random variables of a world-2 case."""
    import jax
    import jax.numpy as jnp

    from mvkpconv_tpu.models import KPFCNN as JaxKPFCNN
    from mvkpconv_tpu.ops.pyramid import build_pyramid
    from mvkpconv_tpu.training.config import KPConfig as JaxConfig
    from test_torch_slice import random_variables

    jcfg = JaxConfig(**CASES[case])
    jb = {k: jnp.asarray(batch[k]) for k in ("points", "mask", "features", "labels")}
    jpyr = jax.jit(lambda p, m: build_pyramid(p, m, jcfg.pyramid_spec()))(jb["points"], jb["mask"])
    variables = random_variables(jax.eval_shape(
        lambda: JaxKPFCNN(jcfg).init(jax.random.PRNGKey(0), jb["features"], jpyr)))
    return jcfg, jb, variables


@functools.lru_cache(maxsize=None)
def world2():
    """Every case's world-2 results, from one spawn of 2 processes."""
    from mvkpconv_tpu_torch.convert import load_jax_variables
    from mvkpconv_tpu_torch.models.kpfcnn import KPFCNN

    batch = sphere_batch()
    states = {case: load_jax_variables(KPFCNN(KPConfig(**cfg)), jax_case(case, batch)[2]).state_dict()
              for case, cfg in CASES.items()}
    return spawn(dp_steps, 2, states, batch, timeout=TIMEOUT)


@pytest.mark.parametrize("case", list(CASES))
def test_world2_step_matches_single_process_and_jax(case):
    import jax

    from mvkpconv_tpu.models import KPFCNN as JaxKPFCNN
    from mvkpconv_tpu.training.optim import make_optimizer as jax_make_optimizer
    from mvkpconv_tpu.training.steps import create_train_state, make_apply_fn
    from mvkpconv_tpu.training.steps import make_train_step as jax_make_train_step
    from mvkpconv_tpu_torch.convert import load_jax_variables
    from mvkpconv_tpu_torch.models.kpfcnn import KPFCNN

    ranks = [r[case] for r in world2()]
    single = ranks[0]["single"]
    for r in ranks:
        got = r["dp"]
        np.testing.assert_allclose(got["loss"], single["loss"], rtol=SHARDED["loss_rtol"])
        assert abs(got["accuracy"] - single["accuracy"]) <= 1e-6
        assert_state_close(got["state"], single["state"], SHARDED["rtol"], SHARDED["atol"])
    assert ranks[0]["dp"]["loss"] == ranks[1]["dp"]["loss"]
    # the planted fault: one of the case's statistics over half the batch
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(ranks[0]["fault"]["loss"], single["loss"], rtol=SHARDED["loss_rtol"])
        assert_state_close(ranks[0]["fault"]["state"], single["state"], SHARDED["rtol"], SHARDED["atol"])

    jcfg, jb, variables = jax_case(case, sphere_batch())
    tx = jax_make_optimizer(jcfg)
    apply_fn = make_apply_fn(JaxKPFCNN(jcfg), jcfg, "kpfcnn")
    jstate, jm = jax_make_train_step(apply_fn, tx, jcfg, donate=False)(create_train_state(variables, tx), jb)
    after = load_jax_variables(KPFCNN(KPConfig(**CASES[case])), {
        "params": jax.tree.map(np.asarray, jstate.params),
        "batch_stats": jax.tree.map(np.asarray, jstate.batch_stats)}).state_dict()
    np.testing.assert_allclose(ranks[0]["dp"]["loss"], float(jm["loss"]), **TRAIN_STEP)
    assert_state_close(ranks[0]["dp"]["state"], after, **TRAIN_STEP)


class Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(3))

    def forward(self, x):
        return self.w.expand_as(x)


def toy_step(model, apply, optimizer, group, size):
    """The data-parallel step of mean((x − w)²) over the global batch, as the
    port's step takes it: a local sum over the global count, the backward of
    the loss times the group's size under DDP's averaging."""
    from mvkpconv_tpu_torch.parallel.collectives import data_parallel, global_sum

    def step(batch):
        x = batch["x"]
        optimizer.zero_grad()
        with data_parallel(group):
            loss = ((x - apply(x)) ** 2).sum() / global_sum(torch.tensor(float(x.numel())))
            (loss * size).backward()
            optimizer.step()
            return {"loss": global_sum(loss.detach())}

    return step


def trainer_fit(rank, world, out_root):
    """``tests/multihost_worker.py`` for the port: the helpers under a real
    world of 2, the global batch and its content, 4 ``Trainer.fit`` steps."""
    import torch.distributed as dist

    from mvkpconv_tpu_torch.training.trainer import Trainer

    scenes = list(range(5))
    assert shard_scenes(scenes) == scenes[rank::2]
    assert local_batch_size(4) == 2
    mesh = make_mesh(device_type="cpu")
    local = {"x": np.arange(6, dtype=np.float32).reshape(2, 3) + 100.0 * rank,
             "labels": np.full((2,), rank, np.int32)}
    gb = global_batch_from_local({k: torch.from_numpy(v) for k, v in local.items()}, mesh)
    assert tuple(gb["x"].shape) == (4, 3) and tuple(gb["labels"].shape) == (4,)
    total = float(gb["x"].full_tensor().sum()) + float(gb["labels"].full_tensor().sum())
    model = Toy()
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    ddp = nn.parallel.DistributedDataParallel(model, broadcast_buffers=False)
    group = mesh.get_group("data")
    trainer = Trainer(toy_step(model, ddp, opt, group, dist.get_world_size(group)), model, opt,
                      str(out_root), KPConfig(epoch_steps=4), log_period=1, mesh=mesh)
    trainer.fit(({"x": local["x"] + i} for i in range(4)), max_steps=4, prefetch_depth=0)
    lines = (trainer.output_dir / "training.txt").read_text().splitlines()
    return {"total": total, "step": trainer.step, "w": model.w.detach().clone(),
            "dir": str(trainer.output_dir), "losses": [float(ln.split()[2]) for ln in lines[1:]]}


def test_trainer_fit_world2_through_global_batch(tmp_path):
    ranks = spawn(trainer_fit, 2, tmp_path, timeout=TIMEOUT)
    # both processes contribute: sum(arange(6)) * 2 + 100*6 + (0*2 + 1*2)
    assert [r["total"] for r in ranks] == [15.0 * 2 + 600.0 + 2.0] * 2
    assert [r["step"] for r in ranks] == [4, 4]
    assert ranks[0]["dir"] == str(tmp_path) and ranks[1]["dir"] == str(tmp_path / "rank1")
    # one process on the global batch, the same updates
    model = Toy()
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    step = toy_step(model, model, opt, None, 1)
    x = np.concatenate([np.arange(6, dtype=np.float32).reshape(2, 3) + 100.0 * r for r in range(2)])
    losses = [float(step({"x": torch.from_numpy(x + i)})["loss"]) for i in range(4)]
    for r in ranks:
        torch.testing.assert_close(r["w"], model.w.detach(), rtol=1e-6, atol=0)
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-3)  # training.txt keeps 3 decimals
    assert float(model.w.detach().abs().sum()) > 0


def train_scannet_process(rank, world, config, output):
    """``train_scannet`` in a process ``torchrun`` would start (its group is
    up, so the CLI does not start one): early fusion with the UNet trained
    end to end (its unused logit head included), 2 steps on the CPU; what
    each of its datasets was given (a fingerprint of each scene, the seed,
    the batch sizes drawn), its trained state, steps and output directory."""
    import os

    from mvkpconv_tpu_torch.data import spheres
    from mvkpconv_tpu_torch.tools import train_scannet

    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank))
    seen = []

    class Recorded(spheres.SphereDataset):
        def __init__(self, scenes, cfg, training=True, seed=0, **kw):
            super().__init__(scenes, cfg, training=training, seed=seed, **kw)
            self.record = {"training": training, "seed": seed, "batch_sizes": [],
                           "scenes": [float(np.asarray(sc["points"], np.float64).sum()) for sc in scenes]}
            seen.append(self.record)

        def batches(self, num_batches=None, batch_size=None):
            self.record["batch_sizes"].append(batch_size)
            return super().batches(num_batches, batch_size)

    spheres.SphereDataset = Recorded
    trainer = train_scannet.main(["--fusion", "early", "--data", "synthetic:4", "--config", config,
                                  "--output", output, "--steps", "2", "--device", "cpu"])
    return {"datasets": seen, "step": trainer.step, "dir": str(trainer.output_dir),
            "state": {k: v.clone() for k, v in trainer.model.state_dict().items()}}


def test_train_scannet_under_torchrun_world2(tmp_path):
    from mvkpconv_tpu_torch.tools.common import load_scenes
    from test_torch_cli import write_config

    config = write_config(tmp_path, fusion="early", in_features_dim=66, batch_num=4)
    run = tmp_path / "run"
    ranks = spawn(train_scannet_process, 2, config, str(run), timeout=TIMEOUT)

    def fingerprints(spec, offset):
        return [float(np.asarray(sc["points"], np.float64).sum())
                for sc in load_scenes(spec, True, 2, (24, 32), seed_offset=offset)]

    train, val = fingerprints("synthetic:4", 0), fingerprints("synthetic:2", 100)
    for r, res in enumerate(ranks):
        ds_train, ds_val = res["datasets"]
        assert ds_train["training"] and not ds_val["training"]
        assert ds_train["scenes"] == train[r::2] and ds_val["scenes"] == val[r::2]
        assert (ds_train["seed"], ds_val["seed"]) == (1000 * r, 1000 * r + 1)
        assert ds_train["batch_sizes"] == [2]  # local_batch_size(4) of 2 processes
        assert res["step"] == 2
    assert ranks[0]["dir"] == str(run) and ranks[1]["dir"] == str(run / "rank1")
    for d in (run, run / "rank1"):
        assert (d / "checkpoints" / "last_checkpoint").read_text() == "ckpt_00000002.pt"
    logged = [(d / "training.txt").read_text().splitlines()[1:] for d in (run, run / "rank1")]
    assert [ln.split()[2] for ln in logged[0]] == [ln.split()[2] for ln in logged[1]]  # the global loss
    a, b = ranks[0]["state"], ranks[1]["state"]
    assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_dryrun_multichip_on_a_2x2_mesh():
    loss = dryrun_multichip(4, device="cpu", timeout=TIMEOUT, reference=True)
    ranks = dryrun_multichip.ranks
    assert np.isfinite(loss) and len(ranks) == 4
    assert all(r["mesh"] == {"data": 2, "model": 2} and r["loss"] == loss for r in ranks)
    assert ranks[0]["sharded"] and all(r["sharded"] == ranks[0]["sharded"] for r in ranks)
    assert "encoder.block_0.KPConv.weights" in ranks[0]["sharded"]
    # the same step in one process on the whole batch
    single = ranks[0]["single"]
    np.testing.assert_allclose(loss, single["loss"], rtol=SHARDED["loss_rtol"])
    assert_state_close(ranks[0]["trained"], single["trained"], SHARDED["rtol"], SHARDED["atol"])
