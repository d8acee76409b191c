"""PyTorch port: gathers, rigid KPConv and one of each KPFCNN block, held
against the JAX package on a JAX-built pyramid with the same weights
(bridged with ``convert.py``), plus the bridge's completeness checks.

Tolerances: f32 max |Δ| ≤ 1e-4 · max |out|; bf16 max |Δ| ≤ 2e-2 · max |out|;
the influence weights within the rounding of their f32 expansion of the
float64 truth (``influence_allowance``). Gathers are exact.
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
from torch_threads import two_threads  # noqa: F401,E402  (autouse: two intra-op threads)

REL = {"float32": 1e-4, "bfloat16": 2e-2}

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


F32_U = 2.0**-24  # float32 unit roundoff
EXPANSION_C = 10.0  # see influence_allowance
ULP_TERM = 8 * F32_U


def influence_allowance(q_pts, s_pts, inds, kp, extent, influence):
    """float64 truth of the rigid influence (B, Nq, K, M) and, per element,
    how far one float32 evaluation of it may lie from that truth.

    Both packages form the squared distance by the expansion
    ``sq = (|n|² − 2 n·y) + |y|²`` in f32 from the same f32 offsets n (the
    gathered support minus the query: one exact-input subtraction, equal in
    both) and kernel points y. With u = 2⁻²⁴: |n|² and |y|² as sums of three
    rounded squares are each within 3u of their value, n·y within 3u·|n||y|
    (a three-term dot, fused or not), the subtraction adds u·(|n|² + 2|n·y|)
    and the final addition u·(|n|² + 2|n·y| + |y|²). Summed, with
    2|n||y| ≤ |n|² + |y|²: |sq − sq₆₄| ≤ 5u|n|² + 10u|n||y| + 4u|y|²
    ≤ ε = c·u·(|n|² + |y|²) with c = 10 (terms in u² dropped). The clamp at 0
    does not widen it. The linear influence 1 − √sq/extent then moves by
    |√a − √b| / extent, with a the f32 sq and b its float64 value:
    |√a − √b| = |a − b| / (√a + √b) ≤ ε / (√sq_lo + √sq), sq_lo = max(sq − ε,
    0) the least a can be, and also ≤ √|a − b| ≤ √ε. The smaller of the two
    is the bound: ε / (2√sq) away from the kernel points, √ε where a neighbor
    sits on one (sq ≈ 0), where the cross term's rounding, which differs
    between JAX's ``dot_general`` and torch's CPU ``matmul`` and between code
    paths of the latter, reaches the weights as a square root. The gaussian
    exp(−sq/(2σ²)) moves by at most c·u·(|n|²+|y|²)/(2σ²). The rounding of
    sqrt, the division, 1 − x and exp, and of the extent to f32, add a few u
    (``ULP_TERM`` = 8u: each of those steps is within u of an argument ≤ 1, or
    relative u of a result ≤ 1)."""
    s_pad = np.concatenate([s_pts, np.full_like(s_pts[:, :1], 1e6)], axis=1)
    n = np.take_along_axis(s_pad[:, None, :, :], inds[..., None].astype(np.int64), axis=2)
    n = (n - q_pts[:, :, None, :]).astype(np.float64)  # the f32 subtraction, then exact
    y = np.asarray(kp, np.float32).astype(np.float64)
    sq = ((n[..., None, :] - y) ** 2).sum(-1)  # (B, Nq, K, M), exact enough
    eps = EXPANSION_C * F32_U * ((n * n).sum(-1)[..., None] + (y * y).sum(-1))
    if influence == "linear":
        w = np.maximum(1.0 - np.sqrt(sq) / extent, 0.0)
        sq_lo = np.maximum(sq - eps, 0.0)
        denom = np.sqrt(sq_lo) + np.sqrt(sq)
        step = np.sqrt(eps)
        np.minimum(step, eps / np.where(denom > 0, denom, 1.0), out=step, where=denom > 0)
        allow = step / extent + ULP_TERM
    elif influence == "gaussian":
        two_var = 2.0 * (0.3 * extent) ** 2
        w = np.exp(-sq / two_var)
        allow = eps / two_var + ULP_TERM
    else:
        w, allow = np.ones_like(sq), np.zeros_like(sq)
    return w, sq, eps, allow


def assert_influence_matches_truth(got, q_pts, s_pts, inds, kp, extent, influence, aggregation):
    """One package's influence within ``influence_allowance`` of the float64
    truth. With ``closest`` each (query, neighbor) row keeps one kernel point:
    the one chosen must be an argmin of sq up to both evaluations' rounding
    (a tie may fall either way), and its weight is held like a ``sum`` one."""
    got = np.asarray(got, np.float64)
    w, sq, eps, allow = influence_allowance(q_pts, s_pts, inds, kp, extent, influence)
    assert got.shape == w.shape and np.isfinite(got).all()
    if aggregation == "closest":
        assert ((got != 0).sum(-1) <= 1).all(), "closest keeps one kernel point"
        chosen = np.where((got != 0).any(-1), np.argmax(got != 0, axis=-1), np.argmin(sq, axis=-1))
        pick = lambda a: np.take_along_axis(a, chosen[..., None], -1)[..., 0]  # noqa: E731
        best = np.argmin(sq, axis=-1)[..., None]
        slack = pick(eps) + np.take_along_axis(eps, best, -1)[..., 0]
        assert (pick(sq) <= np.take_along_axis(sq, best, -1)[..., 0] + slack).all(), \
            "closest chose a kernel point that is no argmin within rounding"
        w = w * (np.arange(w.shape[-1]) == chosen[..., None])
    over = np.abs(got - w) - allow
    assert (over <= 0).all(), (float(np.abs(got - w).max()), float(over.max()))


@pytest.mark.parametrize("kind", ["conv", "pool"])
def test_rigid_influence_and_cache_match_jax(kind):
    """Both packages' rigid influences, and the prebuilt caches, within the
    rounding of the shared f32 expansion of sq of the float64 truth
    (``influence_allowance``), so within twice that of each other; the
    constant influence exactly."""
    jpyr, tpyr = pyramids()
    kp = kernel_point_positions(0.1, 15)
    q_l, s_l = (1, 0) if kind == "pool" else (0, 0)
    inds = jpyr.pools[0] if kind == "pool" else jpyr.neighbors[0]
    tinds = tpyr.pools[0] if kind == "pool" else tpyr.neighbors[0]
    q_np, s_np, i_np = (np.asarray(a) for a in (jpyr.points[q_l], jpyr.points[s_l], inds))
    for infl, agg in (("linear", "sum"), ("gaussian", "closest"), ("constant", "sum")):
        want = JB.rigid_influence(jpyr.points[q_l], jpyr.points[s_l], inds, jnp.asarray(kp), 0.05, infl, agg)
        got = B.rigid_influence(tpyr.points[q_l], tpyr.points[s_l], tinds, torch.from_numpy(kp), 0.05, infl, agg)
        assert got.dtype == torch.float32
        for side in (got.numpy(), np.asarray(want)):
            assert_influence_matches_truth(side, q_np, s_np, i_np, kp, 0.05, infl, agg)
    jcfg, cfg = JaxConfig(**CFG), KPConfig(**CFG)
    jplans = JK.plan_architecture(jcfg)[:2]
    plans = K.plan_architecture(cfg)[:2]
    assert plans == jplans
    want = JK.build_influence_cache(jcfg, jplans, jpyr)
    got = K.make_influence_cache(cfg, plans, tpyr)
    assert sorted(got) == sorted(want)
    for key, r in K._influence_keys(plans).items():
        q, site_inds = K._site(*key, tpyr)
        args = (q.numpy(), tpyr.points[key[1]].numpy(), site_inds.numpy(),
                kernel_point_positions(r, cfg.num_kernel_points), r * cfg.kp_extent / cfg.conv_radius,
                cfg.kp_influence, cfg.aggregation_mode)
        for side in (got[key].numpy(), np.asarray(want[key])):
            assert_influence_matches_truth(side, *args)
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


CONV_BLOCKS = [b for b in BLOCKS if "simple" in b[0] or "resnetb" in b[0]]


@pytest.mark.parametrize("spec", CONV_BLOCKS, ids=[f"{b[0]}-{b[4]}" for b in CONV_BLOCKS])
def test_fused_block_matches_jax(spec, monkeypatch):
    """A conv block on the fused KPConv path (``use_pallas_kpconv=True``, no
    influence cache; on CPU tensors the kernel's plain version) against the
    JAX block under the same flags, which off the TPU runs its einsum path:
    the same function up to reassociation and the form of d², f32, 1e-4."""
    name, cin, cout, r, layer = spec
    jpyr, tpyr = pyramids()
    flags = dict(use_pallas_kpconv=True, influence_cache="none")
    jcfg, cfg = JaxConfig(**CFG, **flags), KPConfig(**CFG, **flags)
    x = np.random.RandomState(4).randn(2, jpyr.points[layer].shape[1], cin).astype(np.float32)
    jblock = JB.block_decider(name, r, cin, cout, layer, jcfg)
    variables = randomize(jblock.init(jax.random.PRNGKey(0), jnp.asarray(x), jpyr, False, None), 5)
    want = np.asarray(jblock.apply(variables, jnp.asarray(x), jpyr, False, None))
    block = B.block_decider(name, r, cin, cout, layer, cfg).eval()
    assert block.KPConv.use_fused
    convert.load_jax_variables(block, variables)
    calls = []
    fused = B.kpconv_fused
    monkeypatch.setattr(B, "kpconv_fused", lambda *a: calls.append(a[1].shape) or fused(*a))
    with torch.no_grad():
        got = block(torch.from_numpy(x), tpyr)
    assert len(calls) == 1 and calls[0][-1] == block.KPConv.weights.shape[1]
    rows = np.asarray(jpyr.masks[layer + ("strided" in name)])
    assert_close_rel(got, want, REL["float32"], rows)


def test_fused_branch_is_taken_under_the_jax_conditions_only(monkeypatch):
    """No precomputed influence, linear influence, sum aggregation; a cache
    that exists wins, and any other variant runs the einsum path."""
    _, tpyr = pyramids()
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 256, 12).astype(np.float32))
    w = torch.from_numpy((rng.randn(15, 12, 7) / 10).astype(np.float32))
    kp = torch.from_numpy(kernel_point_positions(0.1, 15))
    args = (tpyr.points[0], tpyr.points[0], tpyr.neighbors[0], x, kp, w, 0.12)
    calls = []
    fused = B.kpconv_fused
    monkeypatch.setattr(B, "kpconv_fused", lambda *a: calls.append(a[1].dtype) or fused(*a))
    ref = B.kpconv_apply(*args)
    assert not calls  # the flag is off by default
    got = B.kpconv_apply(*args, use_fused=True)
    assert calls == [torch.float32]
    assert_close_rel(got, ref.numpy(), 1e-5)
    B.kpconv_apply(*args, use_fused=True, compute_dtype=torch.bfloat16)
    assert calls == [torch.float32, torch.bfloat16]  # only the features are rounded
    infl = B.rigid_influence(*args[:3], kp, 0.12)
    B.kpconv_apply(*args, use_fused=True, precomputed_influence=infl)
    B.kpconv_apply(*args, use_fused=True, influence="gaussian")
    B.kpconv_apply(*args, use_fused=True, aggregation="closest")
    assert len(calls) == 2
    # the train path: features carry a gradient, the geometry none
    xg = x.clone().requires_grad_(True)
    wg = w.clone().requires_grad_(True)
    B.kpconv_apply(*args[:3], xg, kp, wg, 0.12, use_fused=True).sum().backward()
    want = torch.autograd.grad(B.kpconv_apply(*args[:3], xg, kp, wg, 0.12).sum(), (xg, wg))
    np.testing.assert_allclose(xg.grad.numpy(), want[0].numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(wg.grad.numpy(), want[1].numpy(), rtol=1e-4, atol=1e-4)


def test_unported_variants_raise():
    cfg = KPConfig(**CFG)
    with pytest.raises(ValueError, match="fusion"):
        MVKPConv(cfg.replace(fusion="none"))
    # the brute-force pixel association is ported now: it runs, and takes
    # the global nearest pixels (tests/test_torch_pn2.py holds it to JAX)
    lifted = MVKPConv(cfg.replace(pixel_assoc="exact")).lift_2d_features(
        {"images": torch.zeros(1, 1, 8, 8, 3), "image_xyz": torch.zeros(1, 1, 8, 8, 3)},
        torch.zeros(1, 4, 3),
    )
    assert lifted.shape == (1, 4, cfg.feature_2d_dim)


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
