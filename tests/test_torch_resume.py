"""PyTorch port: a JAX run directory resumed by the port's ``Trainer``, with
optax's optimizer state (``mvkpconv_tpu_torch/training/jax_checkpoint.py``,
``training/checkpoint.py``, ``training/trainer.py``).

  * the fault once open as F1: ``Trainer.maybe_resume`` on a directory the
    JAX ``Checkpointer`` wrote followed its ``last_checkpoint`` tag to the
    ``.msgpack`` and handed it to ``torch.load``; now it restores the JAX
    ``TrainState``, and a file of the wrong kind raises naming the file;
  * the port's msgpack encoder gives ``msgpack.packb``'s bytes on every
    type and length class, and its writer gives the bytes of
    ``flax.serialization.to_bytes`` on the same tree (a dict tree, and a
    ``TrainState``'s state dict after one step), and a
    checkpoint the port writes is restored by the JAX ``Checkpointer`` into
    the JAX ``TrainState`` and read back by the port, equal;
  * a JAX ``Trainer`` after 2 steps, resumed in the port: step 3 of both
    from there, on one batch, meets the train-step contract of ROADMAP
    queue 3 (``scatter``: loss and state within rtol 2e-4, atol 2e-5), the
    momentum buffers and the learning rate included (``lr_decay=0.5`` at
    ``epoch_steps=2``: step 3 runs at the decayed rate); on the KPFCNN and
    on a deformable KPFCNN, whose offset parameters sit in optax's
    ``deform`` label and the port's ``deform`` group.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import flax.serialization as ser  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from mvkpconv_tpu.models import KPFCNN as JaxKPFCNN  # noqa: E402
from mvkpconv_tpu.training.checkpoint import Checkpointer as JaxCheckpointer  # noqa: E402
from mvkpconv_tpu.training.config import KPConfig as JaxConfig  # noqa: E402
from mvkpconv_tpu.training.optim import lr_schedule  # noqa: E402
from mvkpconv_tpu.training.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from mvkpconv_tpu.training.steps import create_train_state, make_apply_fn  # noqa: E402
from mvkpconv_tpu.training.steps import make_train_step as jax_make_train_step  # noqa: E402
from mvkpconv_tpu.training.trainer import Trainer as JaxTrainer  # noqa: E402
from mvkpconv_tpu_torch.convert import load_jax_variables  # noqa: E402
from mvkpconv_tpu_torch.infer import batch_to_device  # noqa: E402
from mvkpconv_tpu_torch.models.kpfcnn import KPFCNN  # noqa: E402
from mvkpconv_tpu_torch.train import make_trainer  # noqa: E402
from mvkpconv_tpu_torch.training.checkpoint import Checkpointer  # noqa: E402
from mvkpconv_tpu_torch.training.config import KPConfig  # noqa: E402
from mvkpconv_tpu_torch.training.jax_checkpoint import (  # noqa: E402
    ExtType,
    load_jax_opt_state,
    load_jax_train_state,
    read_msgpack_state,
    msgpack_serialize,
    packb,
    write_jax_checkpoint,
)
from mvkpconv_tpu_torch.training.trainer import Trainer  # noqa: E402
from test_torch_deformable import CONFIGS, padded_batch  # noqa: E402
from test_torch_jax_checkpoint import cases, msgpack  # noqa: E402
from test_torch_slice import random_variables  # noqa: E402
from torch_threads import two_threads  # noqa: F401,E402  (autouse: two intra-op threads)

TOL = dict(rtol=2e-4, atol=2e-5)
KW = {
    "kpfcnn": dict(CONFIGS["deform"], architecture=(
        "simple", "resnetb", "resnetb_strided", "resnetb", "nearest_upsample", "unary")),
    "deform": CONFIGS["deform"],
}
SCHEDULE = dict(epoch_steps=2, lr_decay=0.5, gather_transpose="scatter")


def jax_state(kw, batch):
    """(JAX config, train step, initial TrainState) of the KPFCNN of ``kw``
    with random weights (no flax init is run)."""
    jcfg = JaxConfig(**kw, **SCHEDULE)
    model = JaxKPFCNN(jcfg)
    from mvkpconv_tpu.ops.pyramid import build_pyramid

    def init():
        pyr = build_pyramid(jnp.asarray(batch["points"]), jnp.asarray(batch["mask"]), jcfg.pyramid_spec())
        return model.init(jax.random.PRNGKey(0), jnp.asarray(batch["features"]), pyr)

    tx = jax_make_optimizer(jcfg)
    step = jax_make_train_step(make_apply_fn(model, jcfg, "kpfcnn"), tx, jcfg, donate=False)
    return jcfg, step, create_train_state(random_variables(jax.eval_shape(init)), tx)


def port_trainer(kw, out):
    cfg = KPConfig(**kw, **SCHEDULE)
    setup = make_trainer(cfg, "cpu", seed=3)
    return Trainer(setup.step, setup.model, setup.optimizer, str(out), cfg)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def numpy_in_order(tree):
    """``tree`` with numpy leaves and every dict in its own order (a
    ``jax.tree.map`` would sort the keys)."""
    if isinstance(tree, dict):
        return {k: numpy_in_order(v) for k, v in tree.items()}
    return np.asarray(tree)


def merged_trace(opt_state):
    """The momentum of every parameter as one params tree: the ``train`` and
    ``deform`` traces, each ``{}`` where its label masks a leaf out."""
    def masked(x):
        return isinstance(x, optax.MaskedNode) or (isinstance(x, dict) and not x)

    def merge(a, b):
        if masked(a):
            return b
        if masked(b):
            return a
        return {k: merge(a[k], b[k]) for k in a}

    traces = [np_tree(opt_state.inner_states[label].inner_state[1][0].trace)
              for label in ("train", "deform")]
    return merge(*traces)


def test_maybe_resume_reads_the_jax_checkpointers_run_directory(tmp_path):
    """F1: the JAX ``Checkpointer`` writes ``ckpt_00000007.msgpack`` and a tag
    naming it; the port's ``Trainer`` resumes from it (before the repair,
    ``torch.load`` of the msgpack raised ``IndexError``)."""
    batch = padded_batch(KPConfig(**KW["kpfcnn"]))
    _jcfg, _step, state = jax_state(KW["kpfcnn"], batch)
    state = state._replace(step=jnp.asarray(7, jnp.int32))
    JaxCheckpointer(tmp_path / "run" / "checkpoints").save(state, 7)
    tr = port_trainer(KW["kpfcnn"], tmp_path / "run")
    assert tr.checkpointer.latest_path() is None  # the tag names no .pt
    tr.maybe_resume()
    assert tr.step == 7
    want = load_jax_variables(KPFCNN(tr.cfg), {"params": np_tree(state.params),
                                               "batch_stats": np_tree(state.batch_stats)})
    for k, v in want.state_dict().items():
        assert torch.equal(tr.model.state_dict()[k], v), k
    assert all(g["count"] == 0 for g in tr.optimizer.param_groups)
    with pytest.raises(ValueError, match="ckpt_00000007.msgpack"):
        Checkpointer(tmp_path / "run" / "checkpoints").restore(
            tmp_path / "run" / "checkpoints" / "ckpt_00000007.msgpack")
    (tmp_path / "run" / "checkpoints" / "ckpt_00000008.pt").write_bytes(b"\x93garbage")
    with pytest.raises(ValueError, match="ckpt_00000008.pt"):
        Checkpointer(tmp_path / "run" / "checkpoints").restore()


def test_packb_equals_msgpack_on_every_type_width():
    """The reader's cases (every type and length class) encode to the bytes
    ``msgpack.packb`` gives them."""
    def port(x):
        if isinstance(x, msgpack.ExtType):
            return ExtType(x.code, x.data)
        if isinstance(x, dict):
            return {k: port(v) for k, v in x.items()}
        if isinstance(x, list):
            return [port(v) for v in x]
        return x

    for case in cases():
        assert packb(port(case)) == msgpack.packb(case), repr(case)[:80]


def test_writer_equals_flax_and_round_trips_through_the_jax_checkpointer(tmp_path):
    rng = np.random.RandomState(0)
    tree = {"a": rng.rand(3, 4).astype(np.float32), "b": {"c": np.asarray(5, np.int32), "d": {}},
            "e": np.float32(1.5), "f": np.arange(70000, dtype=np.int64), "g": "x" * 40,
            "h": {f"k{i}": np.zeros((i,), np.float64) for i in range(20)}, "i": -129, "j": 2.5}
    assert msgpack_serialize(tree) == ser.to_bytes(tree) == ser.msgpack_serialize(tree, in_place=True)

    kw = KW["deform"]
    batch = padded_batch(KPConfig(**kw))
    jcfg, step, state = jax_state(kw, batch)
    state = jax.device_get(step(state, {k: jnp.asarray(batch[k]) for k in
                                        ("points", "mask", "features", "labels")})[0])
    assert msgpack_serialize(numpy_in_order(ser.to_state_dict(state))) == ser.to_bytes(state)

    tr = port_trainer(kw, tmp_path / "a")
    tr.maybe_resume()  # nothing there yet
    tr.train_step(batch_to_device(batch, "cpu"))
    path = write_jax_checkpoint(tmp_path / "ck" / "ckpt_00000001.msgpack", tr.model, tr.optimizer, 1)
    (tmp_path / "ck" / "last_checkpoint").write_text(path.name)
    restored = JaxCheckpointer(tmp_path / "ck").restore(state)  # flax's reader, JAX's tree
    assert int(restored.step) == 1
    again = port_trainer(kw, tmp_path / "b")
    assert load_jax_train_state(again.model, again.optimizer, path) == 1
    for k, v in tr.model.state_dict().items():
        assert torch.equal(again.model.state_dict()[k], v), k
    want = load_jax_variables(KPFCNN(tr.cfg), {"params": merged_trace(restored.opt_state),
                                               "batch_stats": np_tree(restored.batch_stats)})
    for (name, p), q in zip(tr.model.named_parameters(), again.model.parameters()):
        buf = tr.optimizer.state[p]["momentum_buffer"]
        assert torch.equal(again.optimizer.state[q]["momentum_buffer"], buf), name
        assert torch.equal(dict(want.named_parameters())[name], buf), name
    assert [g["count"] for g in again.optimizer.param_groups] == [1, 1]


@pytest.mark.parametrize("name", ["kpfcnn", "deform"])
def test_jax_trainer_resumed_in_the_port_meets_the_step_contract(name, tmp_path):
    kw = KW[name]
    batch = padded_batch(KPConfig(**kw))
    jb = {k: jnp.asarray(batch[k]) for k in ("points", "mask", "features", "labels")}
    jcfg, step, state = jax_state(kw, batch)
    jt = JaxTrainer(step, state, str(tmp_path / "run"), jcfg, log_period=1)
    assert jt.fit(iter([jb, jb]), max_steps=2, prefetch_depth=0) is not False
    assert int(jt.state.step) == 2
    want_state, want = step(jt.state, jb)  # JAX's step 3

    tr = port_trainer(kw, tmp_path / "run")
    tr.maybe_resume()
    assert tr.step == 2
    labels = ["train", "deform"] if name == "deform" else ["train"]
    assert len(tr.optimizer.param_groups) == len(labels)
    assert [g["count"] for g in tr.optimizer.param_groups] == [2] * len(labels)
    got = tr.train_step(batch_to_device(batch, "cpu"))

    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=TOL["rtol"])
    sched = lr_schedule(jcfg)
    assert sched(1) == jcfg.learning_rate and sched(2) == jcfg.learning_rate * 0.5
    for g, label in zip(tr.optimizer.param_groups, labels):
        factor = jcfg.deform_lr_factor if label == "deform" else 1.0
        np.testing.assert_allclose(g["lr"], float(sched(2)) * factor, rtol=1e-7)
        assert g["count"] == int(np.asarray(
            want_state.opt_state.inner_states[label].inner_state[1][1].count)) == 3
    ref = load_jax_variables(KPFCNN(tr.cfg), {"params": np_tree(want_state.params),
                                              "batch_stats": np_tree(want_state.batch_stats)})
    for k, v in ref.state_dict().items():
        np.testing.assert_allclose(tr.model.state_dict()[k].numpy(), v.numpy(), err_msg=k, **TOL)
    momentum = load_jax_variables(KPFCNN(tr.cfg), {"params": merged_trace(want_state.opt_state),
                                                   "batch_stats": np_tree(want_state.batch_stats)})
    bufs = dict(momentum.named_parameters())
    offsets = 0
    for n, p in tr.model.named_parameters():
        offsets += "offset_" in n
        np.testing.assert_allclose(tr.optimizer.state[p]["momentum_buffer"].numpy(),
                                   bufs[n].detach().numpy(), err_msg=n, **TOL)
    assert (offsets > 0) == (name == "deform")


def test_an_optimizer_leaf_left_over_or_missing_raises(tmp_path):
    """As ``load_jax_variables`` raises on a weight leaf it does not use: a
    momentum leaf of no parameter, a parameter without momentum, a label of
    no optax state, a ``frozen`` state that is not empty."""
    kw = KW["deform"]
    tr = port_trainer(kw, tmp_path)
    path = write_jax_checkpoint(tmp_path / "c.msgpack", tr.model, tr.optimizer, 0)

    def opt_state():
        return read_msgpack_state(path)["opt_state"]

    load_jax_opt_state(tr.model, tr.optimizer, opt_state())
    cases = []
    extra = opt_state()
    extra["inner_states"]["train"]["inner_state"]["1"]["0"]["trace"]["ghost"] = np.zeros(3, np.float32)
    cases.append((extra, "ghost"))
    missing = opt_state()
    missing["inner_states"]["deform"]["inner_state"]["1"]["0"]["trace"] = {}
    cases.append((missing, "no momentum"))
    label = opt_state()
    label["inner_states"]["other"] = {}
    cases.append((label, "unknown labels"))
    frozen = opt_state()
    frozen["inner_states"]["frozen"]["inner_state"] = {"x": np.zeros(1, np.float32)}
    cases.append((frozen, "frozen"))
    for tree, match in cases:
        with pytest.raises(ValueError, match=match):
            load_jax_opt_state(tr.model, tr.optimizer, tree)
