"""PyTorch port: the ``group_points`` VJP in its three modes against the JAX
package's ``_group_points`` VJP, and K3's plain version against a numpy
``np.add.at`` oracle.

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
from mvkpconv_tpu_torch.ops.kernels.segsum import segsum, segsum_plain  # noqa: E402
from mvkpconv_tpu_torch.training import config as port_config  # noqa: E402
from mvkpconv_tpu_torch.training.config import KPConfig  # noqa: E402

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
