"""PyTorch port: middle and late fusion, and the fused KPConv path (K4) of
all three fusions, held against the JAX package on the same numpy batch and
the same weights (random, from a numpy seed, bridged with ``convert.py``).

The K4 configurations set ``use_pallas_kpconv=True`` with
``influence_cache='none'`` in both packages: the port's conv blocks then run
the fused kernel's plain version (CPU tensors), the JAX blocks their einsum
path (off the TPU ``pallas_supported()`` is false). In f32 the two are one
function up to reassociation and the form of d², so the logits are held to
the slice's bound; in bf16 the JAX package itself rounds the influence and the
weights on the einsum path and not on the fused one, so there the K4 path is
held against the port's own einsum path at the bf16 bound.

Logits are compared on mask-valid points. Tolerances: f32 max |Δ| ≤
1e-4 · max |logit|; bf16 max |Δ| ≤ 2e-2 · max |logit|. The train step is in
``test_torch_fusion_train.py``.
"""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from mvkpconv_tpu.models import MVKPConv as JaxMVKPConv  # noqa: E402
from mvkpconv_tpu.ops.pyramid import build_pyramid as jax_build_pyramid  # noqa: E402
from mvkpconv_tpu.training.config import KPConfig as JaxConfig  # noqa: E402
from mvkpconv_tpu_torch import tracing  # noqa: E402
from mvkpconv_tpu_torch.convert import load_jax_variables  # noqa: E402
from mvkpconv_tpu_torch.infer import batch_to_device, infer  # noqa: E402
from mvkpconv_tpu_torch.models.mvkpconv import MVKPConv  # noqa: E402
from mvkpconv_tpu_torch.training.config import KPConfig  # noqa: E402
from test_torch_slice import CONFIGS as SLICE_CONFIGS, REL, assert_logits_close, random_variables  # noqa: E402
from torch_threads import two_threads  # noqa: F401,E402  (autouse: two intra-op threads)

K4_FLAGS = dict(use_pallas_kpconv=True, influence_cache="none")
SMALL = SLICE_CONFIGS["small"]
CONFIGS = {
    "middle": dict(SMALL, fusion="middle"),
    "late": dict(SMALL, fusion="late"),
    "early_k4": dict(SMALL, **K4_FLAGS),
    "middle_k4": dict(SMALL, fusion="middle", **K4_FLAGS),
    "late_k4": dict(SMALL, fusion="late", **K4_FLAGS),
}


@functools.lru_cache(maxsize=None)
def setup(name):
    """(JAX config, numpy batch with padded rows, the same batch unpadded,
    JAX pyramid of the padded batch, variables)."""
    jcfg = JaxConfig(**CONFIGS[name])
    unpadded = graft._make_batch(jcfg, 2, np.random.RandomState(0))
    batch = {k: v.copy() for k, v in unpadded.items()}
    batch["mask"][-1, -24:] = False
    batch["points"] = np.where(batch["mask"][..., None], batch["points"], np.float32(1e6))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    pyr = jax.jit(functools.partial(jax_build_pyramid, spec=jcfg.pyramid_spec()))(
        jb["points"], jb["mask"]
    )
    model = JaxMVKPConv(jcfg)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jb, pyr, train=False))
    return jcfg, batch, unpadded, pyr, random_variables(shapes)


def port_model(name, dtype, variables, **overrides):
    cfg = KPConfig(**{**CONFIGS[name], **overrides}, compute_dtype=getattr(torch, dtype))
    return load_jax_variables(MVKPConv(cfg), variables).eval()


def count_fused_calls(monkeypatch):
    """Count the conv blocks that go through the fused KPConv Function."""
    from mvkpconv_tpu_torch.models import blocks

    calls = []
    fused = blocks.kpconv_fused
    monkeypatch.setattr(blocks, "kpconv_fused", lambda *a: calls.append(1) or fused(*a))
    return calls


CASES = [("middle", "float32"), ("middle", "bfloat16"), ("late", "float32"), ("late", "bfloat16"),
         ("early_k4", "float32"), ("middle_k4", "float32"), ("late_k4", "float32")]


@pytest.mark.parametrize("name,dtype", CASES, ids=[f"{n}-{d}" for n, d in CASES])
def test_logits_match_jax(name, dtype, monkeypatch):
    jcfg, batch, _unpadded, pyr, variables = setup(name)
    model = JaxMVKPConv(jcfg.replace(compute_dtype=jnp.dtype(dtype)))
    fn = jax.jit(lambda v, b, p: model.apply(v, b, p, train=False))
    want = np.asarray(fn(variables, {k: jnp.asarray(x) for k, x in batch.items()}, pyr))
    port = port_model(name, dtype, variables)
    calls = count_fused_calls(monkeypatch)
    got = infer(port, batch_to_device(batch, "cpu"))
    assert got.dtype == torch.float32
    assert_logits_close(got, want, batch["mask"], REL[dtype])
    # 4 conv blocks per encoder at this architecture; two encoders in middle fusion
    expected = {"early_k4": 4, "middle_k4": 8, "late_k4": 4}.get(name, 0)
    assert len(calls) == expected


@pytest.mark.parametrize("fusion", ["early", "middle", "late"])
def test_bf16_fused_path_agrees_with_the_einsum_path(fusion, monkeypatch):
    name = f"{fusion}_k4"
    _jcfg, batch, _unpadded, _pyr, variables = setup(name)
    tb = batch_to_device(batch, "cpu")
    want = infer(port_model(name, "bfloat16", variables, use_pallas_kpconv=False), tb)
    calls = count_fused_calls(monkeypatch)
    got = infer(port_model(name, "bfloat16", variables), tb)
    assert calls and not torch.equal(got, want)  # another rounding, not the same path
    assert_logits_close(got, want.numpy(), batch["mask"], REL["bfloat16"])


def test_prebuilt_cache_wins_over_the_fused_flag(monkeypatch):
    """``use_pallas_kpconv=True`` alone, under the default prebuilt influence
    cache, runs no fused kernel (as in the JAX package); a cache over its
    budget leaves the blocks to the fused kernel."""
    _jcfg, batch, _unpadded, _pyr, variables = setup("early_k4")
    tb = batch_to_device(batch, "cpu")
    calls = count_fused_calls(monkeypatch)
    infer(port_model("early_k4", "float32", variables, influence_cache="prebuilt"), tb)
    assert not calls
    infer(port_model("early_k4", "float32", variables, influence_cache="prebuilt",
                     influence_cache_budget_mb=1e-6), tb)
    assert len(calls) == 4
    assert tracing.launch_counts()["kpconv_fused_fwd"] == 0  # CPU tensors: the plain version, no launch


@pytest.mark.parametrize("fusion", ["middle", "late"])
def test_bridge_walks_the_fusion_variants_name_for_name(fusion):
    """Every flax leaf is used and every port tensor set (the bridge raises
    otherwise); the scope names of the two middle-fusion encoders and the
    widths that differ from early fusion are the JAX model's."""
    _jcfg, _batch, _unpadded, _pyr, variables = setup(fusion)
    model = port_model(fusion, "float32", variables)
    names = set(variables["params"])
    assert {n for n, _ in model.named_children()} == names
    if fusion == "middle":
        assert {"encoder_3d", "encoder_2d"} <= names and "encoder" not in names
        assert len(model.encoders) == 2
        # skips of both streams are concatenated: the decoder's unary after the upsample
        k = np.asarray(variables["params"]["decoder"]["block_1"]["mlp"]["kernel"])
        assert model.decoder.block_1.mlp.weight.shape == k.T.shape
    else:
        k = np.asarray(variables["params"]["head"]["head_mlp"]["mlp"]["kernel"])
        assert k.shape[0] == model.decoder.plan[-1][2] + model.cfg.feature_2d_dim
    with pytest.raises((KeyError, ValueError), match="no params leaf|not used|not set|shape"):
        load_jax_variables(MVKPConv(KPConfig(**CONFIGS["early_k4"])), variables)
