"""PyTorch port: grid subsampling, kernel K1's plain version and the pyramid,
held against the JAX package on the same numpy inputs.

Tolerances (the port's contract):
  * pyramid points within 1e-6 absolute (segment sums are reassociated);
    masks and ``num_valid`` exactly equal;
  * neighbor lists on valid query rows: the first entry equal (or tied
    within 1e-5·r²), set recall
    ≥ 0.999 against JAX ``radius_neighbors(method='exact')``, and every
    set mismatch a radius-boundary or k-th-place tie case within 1e-5·r²
    (JAX uses the ‖q‖²−2q·s+‖s‖² expansion, the port the difference form).
"""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from mvkpconv_tpu.ops.neighbors import radius_neighbors as jax_radius_neighbors  # noqa: E402
from mvkpconv_tpu.ops.pallas.radius_topk import binmin_radius_topk  # noqa: E402
from mvkpconv_tpu.ops.pyramid import build_pyramid as jax_build_pyramid  # noqa: E402
from mvkpconv_tpu.ops.sampling import grid_subsample as jax_grid_subsample  # noqa: E402
from mvkpconv_tpu.training.config import KPConfig as JaxConfig  # noqa: E402
from mvkpconv_tpu_torch import tracing  # noqa: E402
from mvkpconv_tpu_torch.ops.kernels import radius_topk as k1  # noqa: E402
from mvkpconv_tpu_torch.ops.neighbors import radius_neighbors  # noqa: E402
from mvkpconv_tpu_torch.ops.pyramid import build_pyramid  # noqa: E402
from mvkpconv_tpu_torch.ops.sampling import grid_subsample  # noqa: E402
from mvkpconv_tpu_torch.training.config import KPConfig  # noqa: E402
from torch_threads import two_threads  # noqa: F401,E402  (autouse: two intra-op threads)

POINT_ATOL = 1e-6
RECALL_MIN = 0.999
TIE_REL = 1e-5

SMALL = dict(  # the dryrun_multichip configuration
    fusion="early", in_features_dim=66,
    architecture=("simple", "resnetb", "resnetb_strided", "resnetb",
                  "nearest_upsample", "unary"),
    num_points=(256, 64), conv_neighbors=(10, 10), pool_neighbors=(10,),
    first_features_dim=32, num_views=2, image_height=24, image_width=32,
)
DEEPER = dict(
    fusion="early", in_features_dim=66, num_points=(1024, 256, 64, 32, 16),
    conv_neighbors=(16,) * 5, pool_neighbors=(16,) * 4,
    first_features_dim=32, num_views=3, image_height=24, image_width=32,
)


def _points(cfg_kw, b=2, pad=40, seed=0):
    jcfg = JaxConfig(**cfg_kw)
    batch = graft._make_batch(jcfg, b, np.random.RandomState(seed))
    pts, mask = batch["points"], batch["mask"].copy()
    mask[-1, -pad:] = False  # padded rows at the end of the last cloud
    pts = np.where(mask[..., None], pts, np.float32(1e6)).astype(np.float32)
    return jcfg, pts, mask


def check_neighbors(port, ref, query, support, radius, q_valid):
    """Hold a port neighbor list against a JAX one on valid query rows."""
    port, ref = np.asarray(port), np.asarray(ref)
    ns = support.shape[1]
    assert port.shape == ref.shape and port.dtype == np.int32
    assert ((port >= 0) & (port <= ns)).all()
    r2 = float(np.float32(radius) ** 2)
    hit = tot = 0
    for b in range(port.shape[0]):
        d2 = ((query[b].astype(np.float64)[:, None] - support[b][None]) ** 2).sum(-1)
        for q in np.nonzero(q_valid[b])[0]:
            p_row, r_row = port[b, q], ref[b, q]
            if r_row[0] < ns and p_row[0] != r_row[0]:
                # the nearest may differ only where the two tie
                gap = abs(d2[q, p_row[0]] - d2[q, r_row[0]])
                assert gap <= TIE_REL * r2, (b, q, p_row[:3], r_row[:3], gap)
            P, R = set(p_row[p_row < ns]), set(r_row[r_row < ns])
            tot += len(R)
            hit += len(P & R)
            kth = max(d2[q, list(P | R)]) if P | R else r2
            for s in P ^ R:
                gap = min(abs(d2[q, s] - r2), abs(d2[q, s] - kth))
                assert gap <= TIE_REL * r2, (b, q, s, d2[q, s], r2, kth)
    assert tot == 0 or hit / tot >= RECALL_MIN, hit / tot


@pytest.mark.parametrize("cell,max_out", [(0.08, 4096), (0.08, 200), (0.3, 64)])
def test_grid_subsample_matches_jax(cell, max_out):
    _, pts, mask = _points(DEEPER)
    want = jax_grid_subsample(jnp.asarray(pts), cell, max_out, mask=jnp.asarray(mask))
    got = grid_subsample(torch.from_numpy(pts), cell, max_out, mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.num_valid.numpy(), np.asarray(want.num_valid))
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), rtol=0, atol=POINT_ATOL)
    one = grid_subsample(torch.from_numpy(pts[0]), cell, max_out)
    assert one.points.shape == (max_out, 3) and one.num_valid.dim() == 0


@pytest.mark.parametrize("n,radius,k", [(1024, 0.1, 16), (2048, 0.1, 30), (512, 0.25, 30)])
def test_k1_plain_matches_jax_exact(n, radius, k):
    rng = np.random.RandomState(n)
    pts = (rng.rand(2, n, 3) * 1.2 - 0.6).astype(np.float32)
    sub = pts[:, : n // 4] + np.float32(0.01)
    for q, s in ((pts, pts), (sub, pts), (pts, sub)):
        kk = 1 if s is sub else k
        got = k1.radius_topk(torch.from_numpy(q), torch.from_numpy(s), radius, kk)
        want = jax_radius_neighbors(jnp.asarray(q), jnp.asarray(s), radius, kk, method="exact")
        check_neighbors(got, want, q, s, radius, np.ones(q.shape[:2], bool))


def test_k1_recall_at_least_the_tpu_kernel():
    """Against float64 truth, the port's exact selection recalls at least as
    much as the TPU bin-min kernel (interpret mode) does."""
    rng = np.random.RandomState(7)
    n, radius, k = 1024, 0.2, 30
    pts = (rng.rand(1, n, 3) * 1.2 - 0.6).astype(np.float32)
    port = k1.radius_topk_plain(torch.from_numpy(pts), torch.from_numpy(pts), radius, k).numpy()
    tpu = np.asarray(binmin_radius_topk(jnp.asarray(pts), jnp.asarray(pts), radius, k, interpret=True))
    d2 = ((pts[0].astype(np.float64)[:, None] - pts[0][None]) ** 2).sum(-1)
    masked = np.where(d2 < np.float32(radius) ** 2, d2, np.inf)
    truth = np.argsort(masked, axis=-1, kind="stable")[:, :k]

    def recall(idx):
        hit = tot = 0
        for q in range(n):
            t = set(truth[q][np.isfinite(masked[q, truth[q]])])
            tot += len(t)
            hit += len(t & set(idx[0, q]))
        return hit / tot

    assert recall(port) >= recall(tpu)
    assert recall(port) >= RECALL_MIN


def test_k1_contract_details():
    rng = np.random.RandomState(1)
    q = torch.from_numpy((rng.rand(1, 50, 3)).astype(np.float32))
    s = torch.cat([q[:, :20], torch.full((1, 5, 3), 1e6)], dim=1).contiguous()
    idx = k1.radius_topk(q, s, 0.3, 40)
    ns = s.shape[1]
    assert idx.shape == (1, 50, 40) and idx.dtype == torch.int32
    d2 = ((q[0, :, None].double() - s[0][None].double()) ** 2).sum(-1)
    for row in range(50):
        sel = idx[0, row][idx[0, row] < ns].long()
        assert (idx[0, row, len(sel):] == ns).all()  # shadow padding at the end
        assert (d2[row, sel] < 0.09).all()  # inside the radius
        assert (d2[row, sel][1:] >= d2[row, sel][:-1]).all()  # ascending
    # exact ties break to the lower support index
    tie = torch.tensor([[[0.0, 0, 0]]])
    sup = torch.tensor([[[1.0, 0, 0], [0, 1.0, 0], [-1.0, 0, 0], [0, 0, 0.5]]])
    assert k1.radius_topk(tie, sup, 2.0, 4).tolist() == [[[3, 0, 1, 2]]]
    # (N, 3) inputs through radius_neighbors
    assert radius_neighbors(q[0], s[0], 0.3, 5).shape == (50, 5)


def test_k1_wrapper_raises_on_kernel_misuse():
    """Inputs the CUDA kernel does not take raise; non-CPU devices never
    reach the plain version."""
    q = torch.zeros(2, 8, 3)
    with pytest.raises(TypeError):
        k1.check_args(q.double(), q, 4)
    with pytest.raises(ValueError):
        k1.check_args(q.transpose(1, 2).contiguous().transpose(1, 2), q, 4)
    with pytest.raises(ValueError):
        k1.check_args(q, torch.zeros(1, 8, 3), 4)
    with pytest.raises(ValueError):
        k1.check_args(q, q, 129)
    with pytest.raises(ValueError):
        k1.check_args(q[:, :, :2].contiguous(), q, 4)
    k1.check_args(q, q, 30)
    with pytest.raises(ValueError, match="unsupported device"):
        k1.radius_topk(q.to("meta"), q.to("meta"), 0.1, 4)
    before = tracing.launch_counts()["radius_topk"]
    k1.radius_topk(q, q, 0.1, 4)
    assert tracing.launch_counts()["radius_topk"] == before  # the plain version is no launch


@pytest.mark.parametrize("cfg_kw", [SMALL, DEEPER], ids=["small", "deeper"])
def test_build_pyramid_matches_jax(cfg_kw):
    jcfg, pts, mask = _points(cfg_kw)
    want = jax.jit(functools.partial(jax_build_pyramid, spec=jcfg.pyramid_spec()))(
        jnp.asarray(pts), jnp.asarray(mask)
    )
    spec = KPConfig(**cfg_kw).pyramid_spec()
    got = build_pyramid(torch.from_numpy(pts), torch.from_numpy(mask), spec)
    levels = spec.num_levels
    assert len(got.points) == levels and len(got.pools) == levels - 1
    for l in range(levels):
        np.testing.assert_array_equal(got.masks[l].numpy(), np.asarray(want.masks[l]))
        np.testing.assert_allclose(
            got.points[l].numpy(), np.asarray(want.points[l]), rtol=0, atol=POINT_ATOL
        )
    P = [np.asarray(p) for p in want.points]
    M = [np.asarray(m) for m in want.masks]
    for l in range(levels):
        check_neighbors(got.neighbors[l], want.neighbors[l], P[l], P[l], spec.radius(l), M[l])
    for l in range(levels - 1):
        check_neighbors(got.pools[l], want.pools[l], P[l + 1], P[l], spec.pool_radius(l), M[l + 1])
        check_neighbors(
            got.upsamples[l], want.upsamples[l], P[l], P[l + 1], 2 * spec.pool_radius(l), M[l]
        )
    for t in got.neighbors + got.pools + got.upsamples:
        assert t.dtype == torch.int32
    with pytest.raises(ValueError, match="budget mismatch"):
        build_pyramid(torch.from_numpy(pts[:, :100]), torch.from_numpy(mask[:, :100]), spec)
