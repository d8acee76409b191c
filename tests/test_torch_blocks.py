"""PyTorch port: gathers, rigid KPConv and one of each KPFCNN block, held
against the JAX package on a JAX-built pyramid with the same weights
(bridged with ``convert.py``), plus the bridge's completeness checks.

Tolerances: f32 max |Δ| ≤ 1e-4 · max |out| (1e-5 for the f32 geometry of
the influence weights); bf16 max |Δ| ≤ 2e-2 · max |out|. Gathers are exact.
"""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from flax import linen as fnn  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from mvkpconv_tpu.models import blocks as JB  # noqa: E402
from mvkpconv_tpu.models import kpfcnn as JK  # noqa: E402
from mvkpconv_tpu.models.kernel_points import kernel_point_positions  # noqa: E402
from mvkpconv_tpu.ops import gather as JG  # noqa: E402
from mvkpconv_tpu.ops.pyramid import build_pyramid as jax_build_pyramid  # noqa: E402
from mvkpconv_tpu.training.config import KPConfig as JaxConfig  # noqa: E402
from mvkpconv_tpu_torch import convert  # noqa: E402
from mvkpconv_tpu_torch.models import blocks as B  # noqa: E402
from mvkpconv_tpu_torch.models import kpfcnn as K  # noqa: E402
from mvkpconv_tpu_torch.models.mvkpconv import MVKPConv  # noqa: E402
from mvkpconv_tpu_torch.ops import gather as G  # noqa: E402
from mvkpconv_tpu_torch.ops.pyramid import Pyramid  # noqa: E402
from mvkpconv_tpu_torch.training.config import KPConfig  # noqa: E402

REL = {"float32": 1e-4, "bfloat16": 2e-2}
GEOM_REL = 1e-5

CFG = dict(
    fusion="early", in_features_dim=66,
    architecture=("simple", "resnetb", "resnetb_strided", "resnetb",
                  "nearest_upsample", "unary"),
    num_points=(256, 64), conv_neighbors=(10, 10), pool_neighbors=(10,),
    first_features_dim=32, num_views=2, image_height=24, image_width=32,
)


@functools.lru_cache(maxsize=None)
def pyramids():
    jcfg = JaxConfig(**CFG)
    batch = graft._make_batch(jcfg, 2, np.random.RandomState(0))
    mask = batch["mask"].copy()
    mask[-1, -20:] = False
    pts = np.where(mask[..., None], batch["points"], np.float32(1e6))
    jpyr = jax.jit(functools.partial(jax_build_pyramid, spec=jcfg.pyramid_spec()))(
        jnp.asarray(pts), jnp.asarray(mask)
    )
    tpyr = Pyramid(*(tuple(torch.from_numpy(np.array(t)) for t in f) for f in jpyr))
    return jpyr, tpyr


def randomize(variables, seed):
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return (0.1 * rng.randn(*x.shape)).astype(np.float32)
        return np.asarray(x, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.tree.map(np.asarray, variables))


def assert_close_rel(got, want, rel, rows=None):
    got = np.asarray(got.detach().float().numpy(), np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    if rows is not None:
        got, want = got[rows], want[rows]
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, (err, scale, rel)


def test_gathers_match_jax():
    rng = np.random.RandomState(0)
    feat = rng.randn(2, 30, 5).astype(np.float32)
    idx = rng.randint(0, 31, (2, 12, 4)).astype(np.int32)
    want = JG.group_points(JG.pad_shadow_row(jnp.asarray(feat)), jnp.asarray(idx))
    got = G.group_points(G.pad_shadow_row(torch.from_numpy(feat)), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[np.asarray(idx) == 30] == 0).all()
    sel = rng.randint(0, 30, (2, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        G.batch_index_select(torch.from_numpy(feat), torch.from_numpy(sel)).numpy(),
        np.asarray(JG.batch_index_select(jnp.asarray(feat), jnp.asarray(sel))),
    )
    xyz = rng.randn(2, 30, 3).astype(np.float32)
    fb = torch.from_numpy(rng.randn(2, 30, 8).astype(np.float32)).to(torch.bfloat16)
    idx_in = torch.from_numpy(np.minimum(idx, 29))
    gx, gf = G.group_points_joint(torch.from_numpy(xyz), fb, idx_in)
    jx, jf = JG.group_points_packed(
        jnp.asarray(xyz), jnp.asarray(fb.float().numpy()).astype(jnp.bfloat16), jnp.asarray(idx_in.numpy())
    )
    assert gf.dtype == torch.bfloat16
    np.testing.assert_array_equal(gx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(gf.float().numpy(), np.asarray(jf, np.float32))


@pytest.mark.parametrize("kind", ["conv", "pool"])
def test_rigid_influence_and_cache_match_jax(kind):
    jpyr, tpyr = pyramids()
    kp = kernel_point_positions(0.1, 15)
    q_l, s_l = (1, 0) if kind == "pool" else (0, 0)
    inds = jpyr.pools[0] if kind == "pool" else jpyr.neighbors[0]
    tinds = tpyr.pools[0] if kind == "pool" else tpyr.neighbors[0]
    for infl, agg in (("linear", "sum"), ("gaussian", "closest"), ("constant", "sum")):
        want = JB.rigid_influence(jpyr.points[q_l], jpyr.points[s_l], inds, jnp.asarray(kp), 0.05, infl, agg)
        got = B.rigid_influence(tpyr.points[q_l], tpyr.points[s_l], tinds, torch.from_numpy(kp), 0.05, infl, agg)
        assert_close_rel(got, np.asarray(want), GEOM_REL)
    jcfg, cfg = JaxConfig(**CFG), KPConfig(**CFG)
    jplans = JK.plan_architecture(jcfg)[:2]
    plans = K.plan_architecture(cfg)[:2]
    assert plans == jplans
    want = JK.build_influence_cache(jcfg, jplans, jpyr)
    got = K.make_influence_cache(cfg, plans, tpyr)
    assert sorted(got) == sorted(want)
    for key in want:
        assert_close_rel(got[key], np.asarray(want[key]), GEOM_REL)
    assert K.make_influence_cache(cfg.replace(influence_cache="none"), plans, tpyr) is None
    assert K.make_influence_cache(cfg.replace(influence_cache_budget_mb=1e-6), plans, tpyr) is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kpconv_apply_both_paths_match_jax(dtype):
    jpyr, tpyr = pyramids()
    rng = np.random.RandomState(3)
    x = rng.randn(2, 256, 12).astype(np.float32)
    w = (rng.randn(15, 12, 7) / 10).astype(np.float32)
    kp = kernel_point_positions(0.1, 15)
    jargs = (jpyr.points[0], jpyr.points[0], jpyr.neighbors[0], jnp.asarray(x), jnp.asarray(kp), jnp.asarray(w), 0.12)
    targs = (tpyr.points[0], tpyr.points[0], tpyr.neighbors[0], torch.from_numpy(x), torch.from_numpy(kp), torch.from_numpy(w), 0.12)
    cd_j, cd_t = jnp.dtype(dtype), getattr(torch, dtype)
    want = np.asarray(JB.kpconv_apply(*jargs, compute_dtype=cd_j))
    got = B.kpconv_apply(*targs, compute_dtype=cd_t)
    assert got.dtype == torch.float32
    assert_close_rel(got, want, REL[dtype])
    infl = B.rigid_influence(targs[0], targs[1], targs[2], targs[4], 0.12).to(cd_t)
    got_pre = B.kpconv_apply(*targs, compute_dtype=cd_t, precomputed_influence=infl)
    jinfl = JB.rigid_influence(jargs[0], jargs[1], jargs[2], jargs[4], 0.12).astype(cd_j)
    want_pre = np.asarray(JB.kpconv_apply(*jargs, compute_dtype=cd_j, precomputed_influence=jinfl, tail="einsum"))
    assert_close_rel(got_pre, want_pre, REL[dtype])


BLOCKS = [
    # (name, in_dim, out_dim, radius, layer)
    ("simple", 66, 32, 0.1, 0),
    ("resnetb", 16, 32, 0.1, 0),
    ("resnetb_strided", 32, 32, 0.1, 0),
    ("resnetb", 64, 64, 0.2, 1),
    ("unary", 96, 32, 0.1, 0),
    ("nearest_upsample", 64, 64, 0.2, 1),
    ("max_pool", 32, 32, 0.1, -1),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("spec", BLOCKS, ids=[f"{b[0]}-{b[4]}" for b in BLOCKS])
def test_block_matches_jax(spec, dtype):
    name, cin, cout, r, layer = spec
    jpyr, tpyr = pyramids()
    jcfg = JaxConfig(**CFG, compute_dtype=jnp.dtype(dtype))
    cfg = KPConfig(**CFG, compute_dtype=getattr(torch, dtype))
    level = max(layer, 0)  # level of the input features
    n_in = jpyr.points[level].shape[1]
    x = np.random.RandomState(4).randn(2, n_in, cin).astype(np.float32)
    jblock = JB.block_decider(name, r, cin, cout, layer, jcfg)
    jx = jnp.asarray(x)
    if name == "unary":
        call = lambda m, v: m.apply(v, jx, jpyr.masks[0])  # noqa: E731
        variables = jblock.init(jax.random.PRNGKey(0), jx, jpyr.masks[0])
    elif isinstance(jblock, (JB.SimpleBlock, JB.ResnetBottleneckBlock)):
        call = lambda m, v: m.apply(v, jx, jpyr, False, None)  # noqa: E731
        variables = jblock.init(jax.random.PRNGKey(0), jx, jpyr, False, None)
    else:
        call = lambda m, v: m.apply(v, jx, jpyr)  # noqa: E731
        variables = {}
    variables = randomize(variables, 5) if variables else {}
    want = np.asarray(call(jblock, variables))
    block = B.block_decider(name, r, cin, cout, layer, cfg).eval()
    convert.load_jax_variables(block, variables)
    tx = torch.from_numpy(x)
    with torch.no_grad():
        if name == "unary":
            got = block(tx, tpyr.masks[0])
        else:
            got = block(tx, tpyr)
    out_level = {"nearest_upsample": layer - 1, "max_pool": 1}.get(
        name, layer + ("strided" in name))
    rows = np.asarray(jpyr.masks[out_level])
    assert_close_rel(got, want, REL[dtype], rows)


def test_unported_variants_raise():
    cfg = KPConfig(**CFG)
    with pytest.raises(NotImplementedError, match="P7"):
        B.block_decider("resnetb_deformable", 0.1, 16, 32, 0, cfg)
    with pytest.raises(NotImplementedError, match="P7"):
        B.block_decider("global_average", 0.1, 16, 32, 0, cfg)
    for fusion in ("middle", "late"):
        with pytest.raises(NotImplementedError, match="P7"):
            MVKPConv(cfg.replace(fusion=fusion))
    with pytest.raises(NotImplementedError, match="P7"):
        MVKPConv(cfg.replace(pixel_assoc="exact")).lift_2d_features(
            {"images": torch.zeros(1, 1, 8, 8, 3), "image_xyz": torch.zeros(1, 1, 8, 8, 3)},
            torch.zeros(1, 4, 3),
        )


def test_convert_raises_on_unused_or_unset_leaves():
    layer = fnn.Dense(4)
    variables = randomize(layer.init(jax.random.PRNGKey(0), jnp.zeros((1, 3))), 0)
    mod = torch.nn.Linear(3, 4)
    convert.load_jax_variables(mod, variables)
    np.testing.assert_array_equal(mod.weight.detach().numpy(), variables["params"]["kernel"].T)
    extra = {"params": dict(variables["params"], stray=np.zeros(2, np.float32))}
    with pytest.raises(ValueError, match="not used"):
        convert.load_jax_variables(mod, extra)
    with pytest.raises(KeyError):
        convert.load_jax_variables(mod, {"params": {"kernel": variables["params"]["kernel"]}})
    holder = torch.nn.Module()
    holder.dense = torch.nn.Linear(3, 4)
    holder.register_buffer("stray", torch.zeros(2))
    with pytest.raises(ValueError, match="not set"):
        convert.load_jax_variables(holder, {"params": {"dense": variables["params"]}})
    with pytest.raises(ValueError, match="shape"):
        convert.load_jax_variables(torch.nn.Linear(3, 5), variables)
