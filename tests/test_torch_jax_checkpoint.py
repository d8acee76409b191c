"""PyTorch port: the reader of the JAX package's flax ``.msgpack``
checkpoints (``mvkpconv_tpu_torch/training/jax_checkpoint.py``).

  * the port's msgpack decoder equals ``msgpack.unpackb`` (this test may
    import msgpack; the port does not) on every type and width: nil, bool,
    positive and negative fixints, u/int 8-64, float 32/64, str and bin of
    each length class, arrays and maps of each size class, fixext 1-16 and
    ext 8/16/32;
  * flax's extension types (ndarray of every dtype the checkpoints hold,
    ``bfloat16`` through ``torch.bfloat16``, numpy scalars, complex) and its
    chunked arrays decode to what ``flax.serialization.msgpack_restore``
    gives;
  * the weight bridge: a small MV-KPConv ``TrainState`` (two views of
    24×32) saved by the JAX ``Checkpointer`` fills the port's model through
    ``load_jax_checkpoint``: logits within 1e-4·max|logit| of JAX's in f32
    (the contract of ``tests/test_torch_slice.py``), the step equal; a leaf
    left out of the file, or one too many, raises;
  * ``restore_run`` takes the port's ``.pt`` where a run holds any, else
    the JAX package's latest or best ``.msgpack``; ``load_2d_checkpoint``
    fills a UNet from a JAX ``train_2d`` run.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
msgpack = pytest.importorskip("msgpack")

import flax.serialization as ser  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from mvkpconv_tpu.training.checkpoint import Checkpointer as JaxCheckpointer  # noqa: E402
from mvkpconv_tpu.training.config import KPConfig as JaxConfig  # noqa: E402
from mvkpconv_tpu.training.optim import make_optimizer  # noqa: E402
from mvkpconv_tpu.training.steps import create_train_state  # noqa: E402
from mvkpconv_tpu_torch.infer import batch_to_device, infer  # noqa: E402
from mvkpconv_tpu_torch.models.mvkpconv import MVKPConv  # noqa: E402
from mvkpconv_tpu_torch.training.checkpoint import Checkpointer  # noqa: E402
from mvkpconv_tpu_torch.training.config import KPConfig  # noqa: E402
from mvkpconv_tpu_torch.training.jax_checkpoint import (  # noqa: E402
    jax_checkpoint_path,
    load_jax_checkpoint,
    read_msgpack_state,
    restore_run,
    unpackb,
)
from test_torch_slice import CONFIGS, assert_logits_close, jax_logits, setup  # noqa: E402
from torch_threads import two_threads  # noqa: F401,E402  (autouse: two intra-op threads)

SIZES = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]


def cases():
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
            -1, -32, -33, -128, -129, -32768, -32769, -(2**31), -(2**31) - 1, -(2**63)]
    out = [None, True, False, *ints, 0.5, -1e300, float("inf")]
    out += ["é" * (n // 2) + "a" * (n % 2) for n in SIZES]
    out += [bytes(range(256)) * (n // 256) + bytes(n % 256) for n in SIZES]
    out += [list(range(n)) for n in (0, 15, 16, 65536)]
    out += [{f"k{i}": i for i in range(n)} for n in (0, 15, 16, 65536)]
    out += [msgpack.ExtType(5, b"x" * n) for n in (1, 2, 4, 8, 16, 0, 3, 255, 256, 65535, 65536)]
    out.append({"nested": [{"a": [None, 1.25, b"\x00"]}, [[], {}]], "neg": -7})
    return out


def same_value(got, want):
    """Equal values of equal types, down the tree; an extension as a
    ``(code, data)`` pair."""
    if isinstance(want, msgpack.ExtType):
        return tuple(got) == tuple(want)
    if type(got) is not type(want):
        return False
    if isinstance(want, dict):
        return got.keys() == want.keys() and all(same_value(got[k], want[k]) for k in want)
    if isinstance(want, list):
        return len(got) == len(want) and all(same_value(a, b) for a, b in zip(got, want))
    return got == want


def test_unpackb_equals_msgpack_on_every_type_width():
    for obj in cases():
        for single in (False, True):
            data = msgpack.packb(obj, use_bin_type=True, use_single_float=single)
            got, want = unpackb(data), msgpack.unpackb(data, strict_map_key=False)
            assert same_value(got, want), (repr(obj)[:60], single)
    # every width of each length class was hit: fixstr/str8/16/32, bin8/16/32, ...
    firsts = {msgpack.packb(o, use_bin_type=True)[0] for o in cases()}
    assert {0xC0, 0xC2, 0xC3, 0xCB, 0xCC, 0xCD, 0xCE, 0xCF, 0xD0, 0xD1, 0xD2, 0xD3, 0xD9, 0xDA, 0xDB,
            0xC4, 0xC5, 0xC6, 0xDC, 0xDD, 0xDE, 0xDF, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xC7, 0xC8, 0xC9} <= firsts
    assert 0xCA in {msgpack.packb(0.5, use_single_float=True)[0]}
    with pytest.raises(ValueError, match="after the object"):
        unpackb(msgpack.packb(1) + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        unpackb(msgpack.packb("abc")[:-1])


def assert_tree_equal(got, want, what=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            assert_tree_equal(got[k], want[k], f"{what}/{k}")
        return
    if getattr(want, "dtype", None) == jnp.bfloat16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, what
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32), err_msg=what)
        assert tuple(got.shape) == np.shape(want), what
        return
    assert type(got) is type(want), (what, type(got), type(want))
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def flax_tree(rng):
    return {
        "f32": rng.randn(3, 4).astype(np.float32), "f64": rng.randn(5), "i32": np.arange(6, dtype=np.int32),
        "i64": np.arange(-3, 3), "u8": np.arange(7, dtype=np.uint8), "bool": rng.rand(2, 2) > 0.5,
        "f16": rng.randn(4).astype(np.float16), "scalar0d": np.asarray(3.5, np.float32),
        "empty": np.zeros((0, 3), np.float32),
        "bf16": jnp.asarray(rng.randn(2, 3), jnp.bfloat16), "bf16_0d": jnp.asarray(1.5, jnp.bfloat16),
        "bf16_empty": jnp.zeros((0, 2), jnp.bfloat16), "bf16_scalar": jnp.bfloat16(0.75),
        "npscalar": np.float32(2.25), "npint": np.int64(-9), "complex": 1.5 - 2j,
        "nested": {"step": np.int32(12), "deep": {"w": rng.randn(2).astype(np.float32)}, "none": {}},
    }


def test_flax_extension_types_and_chunked_arrays(tmp_path, monkeypatch, rng):
    tree = flax_tree(rng)
    path = tmp_path / "tree.msgpack"
    path.write_bytes(ser.msgpack_serialize(tree))
    want = ser.msgpack_restore(path.read_bytes())
    assert_tree_equal(read_msgpack_state(path), want)
    # arrays over flax's chunk size (2**30 bytes; made small here) are
    # written as chunk maps and put back together
    monkeypatch.setattr(ser, "MAX_CHUNK_SIZE", 40)
    big = {"a": rng.randn(7, 5).astype(np.float32), "b": jnp.asarray(rng.randn(61), jnp.bfloat16),
           "c": {"d": np.arange(100, dtype=np.int64)}}
    data = ser.msgpack_serialize(big)
    assert b"__msgpack_chunked_array__" in data
    path.write_bytes(data)
    assert_tree_equal(read_msgpack_state(path), ser.msgpack_restore(data))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX run's checkpoint directory: a small MV-KPConv ``TrainState`` at
    step 12 saved by the JAX ``Checkpointer`` (and as the best)."""
    jcfg, batch, pyr, variables = setup("small")
    state = create_train_state(variables, make_optimizer(jcfg))._replace(step=jnp.asarray(12, jnp.int32))
    ckdir = tmp_path_factory.mktemp("jax_run") / "checkpoints"
    JaxCheckpointer(ckdir).save(state, 12, is_best=True)
    return ckdir, state


def port_model():
    return MVKPConv(KPConfig(**CONFIGS["small"])).eval()


def test_jax_train_state_fills_the_port_model(jax_run):
    ckdir, _ = jax_run
    jcfg, batch, pyr, variables = setup("small")
    model = port_model()
    assert load_jax_checkpoint(model, ckdir / "ckpt_00000012.msgpack") == 12
    got = infer(model, batch_to_device(batch, "cpu"))
    assert got.dtype == torch.float32
    assert_logits_close(got, jax_logits(jcfg, "float32", variables, batch, pyr), batch["mask"], 1e-4)


def test_a_leaf_left_out_or_added_raises(jax_run, tmp_path):
    _, state = jax_run
    sd = ser.to_state_dict(state)
    head = sd["params"]["head"]
    dropped = next(iter(head))
    short = dict(sd, params=dict(sd["params"], head={k: v for k, v in head.items() if k != dropped}))
    (tmp_path / "short.msgpack").write_bytes(ser.msgpack_serialize(short))
    with pytest.raises(KeyError, match="no params leaf"):
        load_jax_checkpoint(port_model(), tmp_path / "short.msgpack")
    extra = dict(sd, params=dict(sd["params"], stray={"kernel": np.ones((2, 2), np.float32)}))
    (tmp_path / "extra.msgpack").write_bytes(ser.msgpack_serialize(extra))
    with pytest.raises(ValueError, match="not used by the bridge"):
        load_jax_checkpoint(port_model(), tmp_path / "extra.msgpack")
    (tmp_path / "params_only.msgpack").write_bytes(ser.msgpack_serialize({"opt_state": {}}))
    with pytest.raises(ValueError, match="not a JAX TrainState"):
        load_jax_checkpoint(port_model(), tmp_path / "params_only.msgpack")


def test_restore_run_prefers_the_port_and_reads_a_jax_run(jax_run, tmp_path):
    ckdir, _ = jax_run
    assert jax_checkpoint_path(ckdir).name == "ckpt_00000012.msgpack"
    assert jax_checkpoint_path(ckdir, best=True).name == "model_best.msgpack"
    model = port_model()
    step, path = restore_run(model, ckdir, best=True)
    assert (step, path.name) == (12, "model_best.msgpack")
    # a run of the port: its .pt, even beside msgpack files
    port_dir = tmp_path / "checkpoints"
    other = port_model()
    with torch.no_grad():
        for p in other.parameters():
            p.add_(1.0)
    Checkpointer(port_dir).save({"step": 3, "model": other.state_dict()}, 3)
    (port_dir / "ckpt_00000099.msgpack").write_bytes((ckdir / "ckpt_00000012.msgpack").read_bytes())
    assert jax_checkpoint_path(port_dir) is None
    step, path = restore_run(model, port_dir)
    assert (step, path.name) == (3, "ckpt_00000003.pt")
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(), other.state_dict().values()))
    assert restore_run(model, tmp_path / "empty") is None


def test_a_jax_2d_run_fills_a_unet_through_transfer(tmp_path):
    """``load_2d_checkpoint`` (``train_scannet --path-2d``, ``precompute_2d``)
    on a JAX ``train_2d`` run directory: its best ``TrainState`` of a
    UNet-ResNet34 (variables at the root) gives the state the weight bridge
    gives from the same variables."""
    import jax

    from mvkpconv_tpu.models.unet2d import UNetResNet34 as JaxUNet
    from mvkpconv_tpu_torch.convert import load_jax_variables
    from mvkpconv_tpu_torch.models.unet2d import UNetResNet34
    from mvkpconv_tpu_torch.training.transfer import load_2d_checkpoint
    from test_torch_slice import random_variables

    jcfg = JaxConfig(**CONFIGS["small"])
    net = JaxUNet(jcfg.num_classes)
    shapes = jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0), jnp.zeros((1, 24, 32, 3)), train=False))
    variables = random_variables(shapes, seed=4)
    state = create_train_state(variables, make_optimizer(jcfg))._replace(step=jnp.asarray(3, jnp.int32))
    JaxCheckpointer(tmp_path / "checkpoints").save(state, 3, is_best=True)
    unet = UNetResNet34(jcfg.num_classes)
    assert load_2d_checkpoint(unet, tmp_path).name == "model_best.msgpack"
    want = load_jax_variables(UNetResNet34(jcfg.num_classes), variables).state_dict()
    got = unet.state_dict()
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
