"""PyTorch port: the ``group_points`` VJP in its three modes against the JAX
package's ``_group_points`` VJP, K3's plain version against a numpy
``np.add.at`` oracle, its ``round_bf16`` option against rows rounded by
``Tensor.to(torch.bfloat16)``, and a PyTorch mirror of the CUDA kernel's
order of summation (rows grouped by target, a warp of row slots a target,
long targets in pieces) against the oracle, a numpy mirror of its plan's
radix sort against a stable sort, and the pyramid's plans handed through
the gather to K3.

Shapes follow ``tests/test_gather_transpose.py``: random targets with
shadow collisions, a batch-split-sized case, wide C, voxel-sorted bands
with shadow rows, a residual case (targets spread past the TPU window
budget). JAX's banded modes run their Pallas kernel in interpret mode here;
the port's K3 runs as its plain version. Tolerances: f32 rows rtol 1e-5
(atol 1e-5 for sums that cancel to near zero); ``banded_bf16``: the rows
rounded to bf16 equal JAX's bit for bit, and the sums agree within the
same tolerance of that f32 accumulation.
"""

import warnings

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from mvkpconv_tpu.ops import gather as JG  # noqa: E402
from mvkpconv_tpu_torch.ops import gather as G  # noqa: E402
from mvkpconv_tpu_torch.ops.kernels import segsum as K3  # noqa: E402
from mvkpconv_tpu_torch.ops.kernels.segsum import segsum, segsum_plain  # noqa: E402
from mvkpconv_tpu_torch.training import config as port_config  # noqa: E402
from mvkpconv_tpu_torch.training.config import KPConfig  # noqa: E402
from torch_threads import two_threads  # noqa: F401,E402  (autouse: two intra-op threads)

TOL = dict(rtol=1e-5, atol=1e-5)


def random_case(b, ns, nq, k, c, seed=0):
    rng = np.random.RandomState(seed)
    feats = rng.randn(b, ns, c).astype(np.float32)
    index = rng.randint(0, ns, (b, nq, k)).astype(np.int32)
    index[rng.rand(b, nq, k) < 0.1] = ns - 1  # shadow-row collisions
    ct = rng.randn(b, nq, k, c).astype(np.float32)
    return feats, index, ct


def banded_case(b=2, ns=6000, nq=1500, k=4, c=5, seed=0):
    """Voxel-sorted regime: targets near 4·q with jitter, plus shadows."""
    rng = np.random.RandomState(seed)
    q = np.arange(nq)[None, :, None] * (ns // nq)
    idx = np.clip(q + rng.randint(-100, 100, (b, nq, k)), 0, ns - 2)
    idx[rng.rand(b, nq, k) < 0.1] = ns - 1
    feats = rng.randn(b, ns, c).astype(np.float32)
    return feats, idx.astype(np.int32), rng.randn(b, nq, k, c).astype(np.float32)


def jax_vjp(feats, index, ct, mode):
    with JG.gather_transpose(mode):
        _, pull = jax.vjp(lambda f: JG.group_points(f, jnp.asarray(index)), jnp.asarray(feats))
    return np.asarray(jax.jit(pull)(jnp.asarray(ct))[0])


def port_vjp(feats, index, ct, mode):
    f = torch.from_numpy(feats).requires_grad_(True)
    with G.gather_transpose(mode):
        out = G.group_points(f, torch.from_numpy(index))
    out.backward(torch.from_numpy(ct))
    return f.grad.numpy()


CASES = {
    "random-a": lambda: random_case(2, 37, 29, 5, 8),
    "random-k1": lambda: random_case(1, 64, 64, 1, 3),
    "random-c": lambda: random_case(3, 16, 40, 7, 10),
    "batch-split": lambda: random_case(2, 12000, 500, 4, 70),
    "wide-256": lambda: random_case(2, 1025, 200, 1, 256),
    "wide-512": lambda: random_case(2, 257, 200, 1, 512),
    "residual": lambda: random_case(1, 6000, 120, 4, 3),
    "voxel-band": banded_case,
}


@pytest.mark.parametrize("mode", ["scatter", "banded", "banded_bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_vjp_matches_jax(case, mode):
    feats, index, ct = CASES[case]()
    got = port_vjp(feats, index, ct, mode)
    want = jax_vjp(feats, index, ct, mode)
    assert got.dtype == np.float32 and got.shape == feats.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_banded_bf16_rounds_rows_like_jax():
    _, _, ct = random_case(2, 37, 29, 5, 8)
    ct[0, 0, 0, :4] = [1 + 2**-8, 1 + 3 * 2**-8, -(1 + 2**-8), 3.0e38]  # ties to even, overflow
    got = torch.from_numpy(ct).to(torch.bfloat16).view(torch.int16).numpy()
    want = np.asarray(jnp.asarray(ct).astype(jnp.bfloat16)).view(np.int16)
    np.testing.assert_array_equal(got, want)


def test_shadow_rows_through_pad_match_jax():
    """Shadow index Ns lands on the padded row, whose gradient the pad's
    slice drops, in both packages."""
    rng = np.random.RandomState(1)
    feats = rng.randn(2, 24, 5).astype(np.float32)
    index = rng.randint(0, 25, (2, 18, 4)).astype(np.int32)
    for mode in G.TRANSPOSE_MODES:
        with JG.gather_transpose(mode):
            want = jax.grad(lambda x: jnp.sum(JG.group_points(JG.pad_shadow_row(x), index) ** 2))(
                jnp.asarray(feats)
            )
        f = torch.from_numpy(feats).requires_grad_(True)
        with G.gather_transpose(mode):
            (G.group_points(G.pad_shadow_row(f), torch.from_numpy(index)) ** 2).sum().backward()
        np.testing.assert_allclose(f.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 37, 29, 5, 8), (1, 64, 64, 1, 3), (3, 1000, 300, 7, 66)])
def test_segsum_plain_matches_numpy_oracle(shape, dtype):
    b, ns, nq, k, c = shape
    _, index, ct = random_case(b, ns, nq, k, c)
    rows = torch.from_numpy(ct.reshape(-1, c)).to(dtype)
    got = segsum(rows, torch.from_numpy(index), ns)
    assert got.dtype == torch.float32 and got.shape == (b, ns, c)
    flat = (index.astype(np.int64) + np.arange(b)[:, None, None] * ns).reshape(-1)
    want = np.zeros((b * ns, c), np.float64)
    np.add.at(want, flat, rows.float().numpy().astype(np.float64))
    np.testing.assert_allclose(got.numpy().reshape(-1, c), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, segsum_plain(rows, torch.from_numpy(index), ns))


def test_mode_is_taken_at_forward_and_joint_gather_scatters():
    feats, index, ct = random_case(2, 37, 29, 5, 8)
    f = torch.from_numpy(feats).requires_grad_(True)
    with G.gather_transpose("banded_bf16"):
        out = G.group_points(f, torch.from_numpy(index))
    out.backward(torch.from_numpy(ct))  # outside the scope: still banded_bf16
    want = jax_vjp(feats, index, ct, "banded_bf16")
    np.testing.assert_allclose(f.grad.numpy(), want, **TOL)
    assert not np.allclose(f.grad.numpy(), jax_vjp(feats, index, ct, "scatter"), rtol=1e-7, atol=0)

    xyz = torch.from_numpy(feats[..., :3].copy()).requires_grad_(True)
    fb = torch.from_numpy(feats).requires_grad_(True)
    idx = torch.from_numpy(np.minimum(index, 36))
    with G.gather_transpose("banded_bf16"):
        gx, gf = G.group_points_joint(xyz, fb, idx)
    (gx.sum() + (gf * torch.from_numpy(ct)).sum()).backward()
    want = jax_vjp(feats, np.minimum(index, 36), ct, "scatter")
    np.testing.assert_allclose(fb.grad.numpy(), want, **TOL)
    with pytest.raises(ValueError):
        with G.gather_transpose("window"):
            pass


def test_config_maps_tpu_transposes_to_k3():
    port_config._WARNED.clear()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        for mode in G.TRANSPOSE_MODES:
            assert KPConfig(gather_transpose=mode).port_option("gather_transpose") == mode
        assert KPConfig(gather_transpose="sorted").port_option("gather_transpose") == "banded"
        assert KPConfig(gather_transpose="window").port_option("gather_transpose") == "banded"
        assert KPConfig(gather_transpose="window").port_option("gather_transpose") == "banded"
    assert len(rec) == 2
    assert KPConfig().port_option("gather_transpose") == "banded_bf16"


@pytest.mark.parametrize("shape", [(2, 37, 29, 5, 8), (1, 64, 64, 1, 3), (3, 1000, 300, 7, 66)])
def test_segsum_round_bf16_equals_rows_rounded_first(shape):
    """``round_bf16`` on f32 rows gives, bit for bit, the sums of the rows
    rounded by ``Tensor.to(torch.bfloat16)`` (ties to even, overflow to inf)."""
    b, ns, nq, k, c = shape
    _, index, ct = random_case(b, ns, nq, k, c)
    rows = ct.reshape(-1, c)
    rows[0, :2] = [1 + 2**-8, 1 + 3 * 2**-8]  # ties to even, down and up
    rows[1, :1] = [3.4e38]  # above the largest bf16: rounds to inf
    rows_t, index_t = torch.from_numpy(rows), torch.from_numpy(index)
    want = segsum_plain(rows_t.to(torch.bfloat16), index_t, ns)
    for got in (segsum_plain(rows_t, index_t, ns, round_bf16=True), segsum(rows_t, index_t, ns, round_bf16=True)):
        assert got.dtype == torch.float32
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.isinf(want).any()


def test_banded_bf16_hands_f32_rows_to_k3(monkeypatch):
    """In ``banded_bf16`` an f32 cotangent reaches K3 as it is, with
    ``round_bf16`` (the kernel rounds it: no cast pass); ``banded`` passes
    f32 rows unrounded and a bf16 cotangent as it is."""
    feats, index, ct = random_case(2, 37, 29, 5, 8)
    calls = []

    def spy(rows, idx, ns, round_bf16=False, plans=None):
        calls.append((rows.dtype, round_bf16))
        return segsum(rows, idx, ns, round_bf16, plans)

    monkeypatch.setattr(G, "segsum", spy)
    for mode, dtype, want in (("banded_bf16", torch.float32, (torch.float32, True)),
                              ("banded", torch.float32, (torch.float32, False)),
                              ("banded", torch.bfloat16, (torch.bfloat16, False)),
                              ("banded_bf16", torch.bfloat16, (torch.bfloat16, False))):
        f = torch.from_numpy(feats).to(dtype).requires_grad_(True)
        with G.gather_transpose(mode):
            out = G.group_points(f, torch.from_numpy(index))
        out.backward(torch.from_numpy(ct).to(dtype))
        assert calls[-1] == want, (mode, dtype, calls[-1])
    assert len(calls) == 4


def piece_width(c, dtype):
    """Elements a lane loads at once in ``csrc/segsum.cu`` (``dispatch_sum``)
    for contiguous rows: 16 bytes where C allows, else 8, 4 or one element."""
    for v in ((8, 4, 2) if dtype == torch.bfloat16 else (4, 2)):
        if c % v == 0:
            return v
    return 1


def k3_mirror(rows, index, ns, round_bf16=False):
    """PyTorch mirror of ``csrc/segsum.cu``'s order of summation. Rows are
    grouped by target in row order (the plan, a stable sort: see
    ``plan_sort_mirror``) and cut into pieces of ``LONG``
    rows. A piece is one warp a group of at most ``GROUP`` pieces of
    ``piece_width`` elements (a wider row is split into groups, each a warp
    of its own, which changes no element's order): R = 32 / P' row slots,
    P' the group's pieces rounded up to a power of two; slot s sums rows s,
    s + R, s + 2R, … in f32 in that order, and
    the slots meet pairwise (s with s ^ 1, then pairs of pairs: the
    ``__shfl_xor_sync`` butterfly). A target of one piece stores its sum; a
    longer one's pieces are added in piece order, from zero, by the last to
    finish. Returns the (B, Ns, C) sums and the pieces of long targets."""
    if round_bf16:
        rows = rows.to(torch.bfloat16)
    b, nq, k = index.shape
    c = rows.shape[1]
    n_pc = c // piece_width(c, rows.dtype)
    pp = min(K3.GROUP, 1 << max(0, (n_pc - 1).bit_length()))
    slots = 32 // pp
    key = (index.long() + torch.arange(b)[:, None, None] * ns).reshape(-1)
    x = rows.float()
    keep = (index.reshape(-1) >= 0) & (index.reshape(-1) < ns)
    key, x = key[keep], x[keep]
    order = torch.argsort(key, stable=True)
    key, x = key[order], x[order]
    targets, counts = torch.unique_consecutive(key, return_counts=True)
    pos = torch.arange(len(key)) - torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    n_pieces = (counts + K3.LONG - 1) // K3.LONG
    piece = pos // K3.LONG
    within = pos % K3.LONG
    # (target, piece, slot) groups, each summed in order of its rows
    first_piece = torch.repeat_interleave(torch.cumsum(n_pieces, 0) - n_pieces, counts)
    group = ((first_piece + piece) * slots + within % slots)
    step = within // slots
    n_groups = int(n_pieces.sum()) * slots
    dense = torch.zeros(n_groups, K3.LONG // slots + 1, c)
    dense[group, step] = x
    acc = torch.zeros(n_groups, c)
    for j in range(dense.shape[1]):
        acc = acc + dense[:, j]
    acc = acc.reshape(-1, slots, c)
    while acc.shape[1] > 1:
        acc = acc[:, 0::2] + acc[:, 1::2]
    partial = acc[:, 0]
    out = torch.zeros(b * ns, c)
    start = torch.cumsum(n_pieces, 0) - n_pieces
    for t, s0, np_ in zip(targets.tolist(), start.tolist(), n_pieces.tolist()):
        if np_ == 1:
            out[t] = partial[s0]
        else:
            total = torch.zeros(c)
            for q in range(np_):
                total = total + partial[s0 + q]
            out[t] = total
    return out.reshape(b, ns, c), int(n_pieces[counts > K3.LONG].sum())


def level0_like(b, n, k, seed=0):
    """Neighbor lists shaped like the bench pyramid's level 0, scaled down:
    query q's targets near q (a voxel-sorted cloud), min(5, k) to k of them, the rest
    on the shadow row n."""
    rng = np.random.RandomState(seed)
    index = np.clip(np.arange(n)[None, :, None] + rng.randint(-150, 150, (b, n, k)), 0, n - 1)
    index[..., 0] = np.arange(n)
    valid = rng.randint(min(5, k), k + 1, (b, n, 1))
    index = np.where(np.arange(k)[None, None, :] < valid, np.sort(index, -1), n)
    return index.astype(np.int32)


MIRROR_CASES = {
    "level0_c32": lambda: (level0_like(2, 2048, 30), 2049, 32),
    "one_target": lambda: (np.full((1, 700, 30), 3, np.int32), 2049, 32),
    "all_shadow": lambda: (np.full((2, 300, 30), 2048, np.int32), 2049, 32),
    "fused_c35": lambda: (level0_like(2, 1024, 30, 1), 1025, 35),
    "fused_c69": lambda: (level0_like(1, 1024, 30, 2), 1025, 69),
    "k1": lambda: (level0_like(2, 2048, 1, 3), 2049, 64),
}


@pytest.mark.parametrize("rows_kind", ["float32", "bfloat16", "float32_round"])
@pytest.mark.parametrize("case", list(MIRROR_CASES))
def test_k3_order_of_summation_mirror_matches_oracle(case, rows_kind):
    """The kernel's order of summation, mirrored, within 2⁻¹⁸·Σ|rows into a
    target| of the float64 oracle (the allowance ``chip_smoke.py`` holds the
    kernel to on the card), with a long target (more than ``LONG`` rows,
    such as the shadow row) cut into as many pieces as the plan lists."""
    index, ns, c = MIRROR_CASES[case]()
    rng = np.random.RandomState(7)
    rows = torch.from_numpy(rng.randn(index.size, c).astype(np.float32))
    if rows_kind == "bfloat16":
        rows = rows.to(torch.bfloat16)
    rnd = rows_kind == "float32_round"
    got, pieces = k3_mirror(rows, torch.from_numpy(index), ns, rnd)
    summed = (rows.to(torch.bfloat16) if rnd else rows).double().numpy()
    flat = (index.astype(np.int64) + np.arange(index.shape[0])[:, None, None] * ns).reshape(-1)
    want, scale = np.zeros((index.shape[0] * ns, c)), np.zeros((index.shape[0] * ns, c))
    np.add.at(want, flat, summed)
    np.add.at(scale, flat, np.abs(summed))
    err = np.abs(got.numpy().reshape(-1, c) - want)
    assert (err <= 2.0**-18 * scale + 1e-30).all(), float((err / (scale + 1e-30)).max())
    assert torch.equal(segsum(rows, torch.from_numpy(index), ns, rnd), segsum_plain(rows, torch.from_numpy(index), ns, rnd))
    counts = np.bincount(flat, minlength=index.shape[0] * ns)
    assert pieces == int(sum(-(-n // K3.LONG) for n in counts if n > K3.LONG))
    if case in ("one_target", "all_shadow"):
        assert pieces > 1


# csrc/segsum.cu's plan sort: kDigit, kTile, and the entries a warp ranks
SORT_DIGIT, SORT_TILE, SORT_WARP_RUN = 9, 3072, 384


def plan_sort_mirror(index, ns):
    """numpy mirror of ``csrc/segsum.cu``'s plan sort: keys b·ns + t (b·ns
    for a target out of range), sorted on their bits in passes of equal
    width, at most ``SORT_DIGIT`` bits; per pass a digit histogram per tile
    of ``SORT_TILE`` entries, its exclusive scan digit-major, then each entry
    to its (digit, tile) place plus its rank among the entries of its digit
    in its warp's run of ``SORT_WARP_RUN`` (in entry order), after the runs
    of the warps before it in the tile. Returns the row order and the
    number of passes."""
    b = index.shape[0]
    m = b * ns
    t = index.reshape(b, -1).astype(np.int64)
    keys = np.where((t >= 0) & (t < ns), t + np.arange(b)[:, None] * ns, m).reshape(-1)
    rows = np.arange(keys.size)
    n = keys.size
    bits = int(m).bit_length()  # keys run from 0 to m
    passes = -(-bits // SORT_DIGIT)
    width = -(-bits // passes)
    tiles = -(-n // SORT_TILE)
    runs_a_tile = SORT_TILE // SORT_WARP_RUN
    pos = np.arange(n)
    run, tile = pos // SORT_WARP_RUN, pos // SORT_TILE
    for p in range(passes):
        nb = 1 << width
        d = (keys >> (p * width)) & (nb - 1)
        hist = np.zeros((nb, tiles), np.int64)
        np.add.at(hist, (d, tile), 1)
        flat = hist.reshape(-1)
        offsets = (np.cumsum(flat) - flat).reshape(nb, tiles)
        cnt = np.zeros((tiles * runs_a_tile, nb), np.int64)
        np.add.at(cnt, (run, d), 1)
        per_tile = cnt.reshape(tiles, runs_a_tile, nb)
        first = offsets.T[:, None, :] + np.cumsum(per_tile, axis=1) - per_tile  # (tiles, runs, nb)
        first = first.reshape(-1, nb)
        # rank: earlier entries of the same (run, digit)
        grouped = np.lexsort((pos, d, run))
        g_run, g_d = run[grouped], d[grouped]
        new = np.r_[True, (g_run[1:] != g_run[:-1]) | (g_d[1:] != g_d[:-1])]
        starts = np.maximum.accumulate(np.where(new, np.arange(n), 0))
        rank = np.empty(n, np.int64)
        rank[grouped] = np.arange(n) - starts
        at = first[run, d] + rank
        assert np.array_equal(np.sort(at), pos), "a pass must place every entry once"
        out_k, out_r = np.empty_like(keys), np.empty_like(rows)
        out_k[at], out_r[at] = keys, rows
        keys, rows = out_k, out_r
    return rows, passes


SORT_CASES = {
    "level0_like": lambda: (level0_like(2, 2048, 30), 2049),
    "bench_level0_keys": lambda: (level0_like(4, 16384, 2, 5), 16385),
    "one_target": lambda: (np.full((1, 700, 30), 3, np.int32), 2049),
    "all_shadow": lambda: (np.full((2, 300, 30), 2048, np.int32), 2049),
    "out_of_range": lambda: (np.where(level0_like(2, 512, 9, 6) % 7 == 0, -1, level0_like(2, 512, 9, 6)), 513),
    "k1_one_pass": lambda: (level0_like(3, 100, 1, 7), 101),
}


@pytest.mark.parametrize("case", list(SORT_CASES))
def test_k3_plan_sort_mirror_is_a_stable_sort(case):
    """The plan's radix sort, mirrored, lists each target's rows in row
    order (a stable sort by target, rows out of range last), whatever the
    order of the kernel's atomics: the plan, and so K3's sums, are the same
    bits from run to run. Level 0 of the bench (B·Ns = 65,540 keys, 17 bits)
    takes two passes; a key range under 2⁹ one."""
    index, ns = SORT_CASES[case]()
    order, passes = plan_sort_mirror(index, ns)
    b = index.shape[0]
    t = index.reshape(b, -1).astype(np.int64)
    keys = np.where((t >= 0) & (t < ns), t + np.arange(b)[:, None] * ns, b * ns).reshape(-1)
    assert np.array_equal(order, np.argsort(keys, kind="stable"))
    assert passes == {"bench_level0_keys": 2, "k1_one_pass": 1}.get(case, passes)
    # the plan's plain version (the CPU kernel of mvkpconv::segsum_plan) lists that order
    m, n = b * ns, keys.size
    lay = K3.plan_layout(m, n)
    plan = K3.segsum_plan(torch.from_numpy(index), ns).numpy()
    counts = np.bincount(keys, minlength=m + 1)[:m]
    per = [-(-c // K3.LONG) for c in counts if c > K3.LONG]
    assert plan.size == lay["total"] and np.array_equal(plan[:m], counts)
    assert np.array_equal(plan[lay["start"]:lay["start"] + m + 1], np.r_[0, np.cumsum(counts)])
    assert plan[lay["n_pieces"]] == sum(per) and np.array_equal(plan[lay["order"]:lay["order"] + n], order)
    pieces = plan[lay["pieces"]:lay["pieces"] + 4 * sum(per)].reshape(-1, 4)
    assert np.array_equal(pieces[:, 1], np.concatenate([np.arange(p) for p in per] or [np.zeros(0, int)]))


def test_pyramid_plans_reach_k3_through_the_gather(monkeypatch):
    """Every index tensor of the pyramid carries its K3 plans
    (``attach_plans``), and a gather VJP on it hands them to ``segsum``
    (which builds the plan once for all the VJPs on that tensor on CUDA);
    an index without them hands none."""
    from mvkpconv_tpu_torch.models.blocks import closest_pool
    from mvkpconv_tpu_torch.ops.pyramid import build_pyramid

    cfg = KPConfig(num_points=(256, 64), conv_neighbors=(10, 10), pool_neighbors=(10,),
                   architecture=("simple", "resnetb_strided", "resnetb", "nearest_upsample", "unary"))
    rng = np.random.RandomState(0)
    pts = torch.from_numpy(rng.rand(2, 256, 3).astype(np.float32))
    pyr = build_pyramid(pts, torch.ones(2, 256, dtype=torch.bool), cfg.pyramid_spec())
    tensors = pyr.neighbors + pyr.pools + pyr.upsamples
    assert len(tensors) == 3 * cfg.num_layers - 2
    assert all(isinstance(t.segsum_plans, K3.IndexPlans) for t in tensors)
    assert len({id(t.segsum_plans) for t in tensors}) == len(tensors)
    handed = []

    def spy(rows, idx, ns, round_bf16=False, plans=None):
        handed.append(plans)
        return segsum(rows, idx, ns, round_bf16, plans)

    monkeypatch.setattr(G, "segsum", spy)
    x = torch.randn(2, 64, 8, requires_grad=True)
    with G.gather_transpose("banded_bf16"):
        y = closest_pool(x, pyr.upsamples[0]).sum() + G.group_points(
            G.pad_shadow_row(x), pyr.neighbors[1]).sum()
        z = G.group_points(x, torch.zeros(2, 5, 3, dtype=torch.int32)).sum()
    (y + z).backward()
    assert sorted(map(id, handed)) == sorted(
        [id(pyr.upsamples[0].segsum_plans), id(pyr.neighbors[1].segsum_plans), id(None)])
