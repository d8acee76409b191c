"""PyTorch port: the fused KPConv (K4) plain versions and autograd Function
against the JAX package's kernel and oracle.

The same numpy inputs go through ``mvkpconv_tpu.ops.pallas.kpconv``
(``kpconv_fused(..., interpret=True)``, the Pallas kernel in interpret mode,
and ``_reference_math``, whose VJP is its backward) and through
``mvkpconv_tpu_torch.ops.kernels.kpconv``, which on CPU tensors runs the
plain versions of its three CUDA kernels. Inputs carry shadow neighbors
(rel = 1e6, zero feature row) and all-padded queries (every neighbor on the
centre kernel point); N is no multiple of 128.

Tolerances, as ``tests/test_pallas_kpconv.py`` holds the TPU kernel to its
oracle: forward rtol 2e-4, atol 2e-5; gradients rtol 1e-3, atol 1e-4 (a bf16
cotangent of bf16 features: one bf16 rounding, rtol 8e-3). The port's d² is
the difference form of ``_reference_math``; the TPU kernel's expansion form
stays within the same tolerance here. The Function's explicit backward
against autograd of the plain version in float64: 1e-10.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from mvkpconv_tpu.models.kernel_points import kernel_point_positions  # noqa: E402
from mvkpconv_tpu.ops.pallas.kpconv import _reference_math, kpconv_fused as jax_kpconv_fused  # noqa: E402
from mvkpconv_tpu_torch.ops.kernels import kpconv as K4  # noqa: E402

EXTENT = 0.06
FWD_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)
BF16_GRAD_TOL = dict(rtol=8e-3, atol=1e-4)
# (Cin, N): N a multiple of the TPU kernel's query tile for that Cin, not of 128
SHAPES = {8: 200, 66: 186}


def inputs(cin, n=None, b=2, k=16, m=15, cout=16, seed=0):
    """numpy (rel, nx, kernel points, weights2d) with 3 shadow neighbors per
    query and the first two queries of each batch element all-padded."""
    rng = np.random.RandomState(seed)
    n = n or SHAPES[cin]
    rel = (rng.rand(b, n, k, 3).astype(np.float32) - 0.5) * 0.2
    nx = rng.randn(b, n, k, cin).astype(np.float32)
    rel[:, :, -3:] = 1e6
    nx[:, :, -3:] = 0.0
    rel[:, :2] = 0.0  # a padded query sits on its (padded) neighbors
    kp = kernel_point_positions(0.1, m)
    w = (rng.randn(m * cin, cout) * 0.05).astype(np.float32)
    return rel, nx, kp, w


def to_jax(arrays, dtype):
    rel, nx, kp, w = map(jnp.asarray, arrays)
    return rel, nx.astype(jnp.dtype(dtype)), kp, w


def to_torch(arrays, dtype):
    rel, nx, kp, w = map(torch.from_numpy, arrays)
    return rel, nx.to(getattr(torch, dtype)), kp, w


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cin", [8, 66])
def test_plain_forward_matches_the_tpu_kernel_and_its_oracle(cin, dtype):
    arrays = inputs(cin)
    jargs, targs = to_jax(arrays, dtype), to_torch(arrays, dtype)
    got = K4.kpconv_fused_plain(*targs, EXTENT)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    np.testing.assert_allclose(f32(got), f32(jax_kpconv_fused(*jargs, EXTENT, True)), **FWD_TOL)
    np.testing.assert_allclose(f32(got), f32(_reference_math(*jargs, EXTENT)), **FWD_TOL)
    # the wrapper takes the plain version for CPU tensors, and counts no launch
    before = K4.kpconv_fused_fwd.launches
    np.testing.assert_array_equal(f32(K4.kpconv_fused_fwd(*targs, EXTENT)), f32(got))
    assert K4.kpconv_fused_fwd.launches == before


@pytest.mark.parametrize("via", ["function", "plain"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cin", [8, 66])
def test_gradients_match_the_tpu_kernels_backward(cin, dtype, via):
    """d(Σ out²)/d(nx, weights2d): JAX's custom VJP (``jax.vjp`` of
    ``_reference_math``) against the port's Function (its explicit backward:
    the plain ``bwd_x`` and ``wf`` versions) and against autograd of the
    plain forward."""
    arrays = inputs(cin, n=SHAPES[cin] // 2 if cin == 66 else 128)
    rel, nx, kp, w = to_jax(arrays, dtype)
    want = jax.grad(
        lambda x, wt: jnp.sum(jax_kpconv_fused(rel, x, kp, wt, EXTENT, True) ** 2), argnums=(0, 1)
    )(nx, w)
    trel, tnx, tkp, tw = to_torch(arrays, dtype)
    tnx.requires_grad_(True)
    tw.requires_grad_(True)
    fn = K4.kpconv_fused if via == "function" else K4.kpconv_fused_plain
    (fn(trel, tnx, tkp, tw, EXTENT) ** 2).sum().backward()
    assert tnx.grad.dtype == tnx.dtype and tw.grad.dtype == torch.float32
    assert torch.isfinite(tnx.grad.float()).all() and torch.isfinite(tw.grad).all()
    np.testing.assert_allclose(
        f32(tnx.grad), f32(want[0]), **(GRAD_TOL if dtype == "float32" else BF16_GRAD_TOL)
    )
    np.testing.assert_allclose(f32(tw.grad), f32(want[1]), **GRAD_TOL)
    # shadow neighbors (influence exactly 0) get no cotangent
    assert (f32(tnx.grad)[:, 2:, -3:] == 0).all()


def test_function_backward_equals_autograd_of_the_plain_version_in_float64():
    rel, nx, kp, w = (torch.from_numpy(a).double() for a in inputs(8, n=24, k=6, cout=5))
    grads = []
    for fn in (K4.kpconv_fused, K4.kpconv_fused_plain):
        x, wt = nx.clone().requires_grad_(True), w.clone().requires_grad_(True)
        g = torch.from_numpy(np.random.RandomState(1).randn(2, 24, 5))
        grads.append(torch.autograd.grad(fn(rel, x, kp, wt, EXTENT), (x, wt), g))
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10, atol=1e-12)
    x, wt = nx[:, :4].clone().requires_grad_(True), w.clone().requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda a, b: K4.kpconv_fused(rel[:, :4], a, kp, b, EXTENT), (x, wt), eps=1e-6, atol=1e-7
    )


def test_weight_gradient_and_bwd_x_are_the_vjp_of_the_plain_forward():
    rel, nx, kp, w = to_torch(inputs(8, n=40), "float32")
    g = torch.from_numpy(np.random.RandomState(2).randn(2, 40, 16).astype(np.float32))
    x, wt = nx.clone().requires_grad_(True), w.clone().requires_grad_(True)
    dx, dw = torch.autograd.grad(K4.kpconv_fused_plain(rel, x, kp, wt, EXTENT), (x, wt), g)
    np.testing.assert_allclose(
        K4.kpconv_fused_bwd_x(rel, g, kp, w, EXTENT).numpy(), dx.numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(
        K4.weight_gradient(rel, nx, kp, g, EXTENT).numpy(), dw.numpy(), rtol=1e-4, atol=1e-5)
    wf = K4.kpconv_wf(rel, nx, kp, EXTENT)
    assert wf.shape == (2, 40, 15 * 8)
    np.testing.assert_allclose(
        torch.matmul(wf, w).numpy(), K4.kpconv_fused_plain(rel, nx, kp, w, EXTENT).numpy(),
        rtol=1e-6, atol=1e-7)


def test_shadow_neighbors_weigh_nothing_and_padded_queries_stay_finite():
    rel, nx, kp, w = to_torch(inputs(8, n=40), "float32")
    infl = K4._influence(rel, kp, EXTENT)
    assert (infl[:, 2:, -3:] == 0).all()  # exactly, not merely small
    assert (infl[:, :2, :, 0] == 1).all()  # on the centre kernel point: sqrt(0)
    noisy = nx.clone()
    noisy[:, 2:, -3:] = 1e30  # whatever a shadow row held, it is weighed by exactly 0
    np.testing.assert_array_equal(
        K4.kpconv_fused_plain(rel, noisy, kp, w, EXTENT)[:, 2:].numpy(),
        K4.kpconv_fused_plain(rel, nx, kp, w, EXTENT)[:, 2:].numpy())
    x = nx.clone().requires_grad_(True)
    K4.kpconv_fused(rel, x, kp, w, EXTENT).sum().backward()
    assert torch.isfinite(x.grad).all()


@pytest.mark.parametrize("which", ["neighb_rel", "kernel_pts"])
def test_function_raises_when_the_geometry_requires_a_gradient(which):
    rel, nx, kp, w = to_torch(inputs(8, n=8), "float32")
    args = {"neighb_rel": rel, "kernel_pts": kp}
    args[which].requires_grad_(True)
    with pytest.raises(ValueError, match="no gradient"):
        K4.kpconv_fused(args["neighb_rel"], nx, args["kernel_pts"], w, EXTENT)
    # the plain version gives all four, as jax.vjp(_reference_math) does (away
    # from padded queries: there both differentiate sqrt at 0)
    out = K4.kpconv_fused_plain(args["neighb_rel"][:, 2:], nx[:, 2:], args["kernel_pts"], w, EXTENT)
    (grad,) = torch.autograd.grad(out.sum(), args[which])
    assert grad.shape == args[which].shape and torch.isfinite(grad).all() and grad.abs().max() > 0


def test_check_args_rejects_what_the_kernels_do_not_take():
    rel, nx, kp, w = to_torch(inputs(8, n=8), "float32")
    K4.check_args(rel, nx, kp, w, torch.zeros(2, 8, 16))
    K4.check_args(rel, nx.to(torch.bfloat16), kp)
    bad = [
        (rel.double(), nx, kp, w),  # geometry must be f32
        (rel, nx.half(), kp, w),  # features f32 or bf16
        (rel, nx, kp, w.to(torch.bfloat16)),  # weights stay f32
        (rel[..., :2], nx, kp, w),
        (rel, nx[:, :, :5], kp, w),  # K mismatch
        (rel, nx, kp, w[:-1]),  # rows != M * Cin
        (rel.transpose(1, 2), nx, kp, w),  # not contiguous
        (rel.repeat(1, 1, 9, 1), nx.repeat(1, 1, 9, 1), kp, w),  # K = 144 > 128
        (rel, nx, torch.zeros(33, 3), torch.zeros(33 * 8, 16)),  # M > 32
    ]
    for args in bad:
        with pytest.raises((TypeError, ValueError)):
            K4.check_args(*args)
    with pytest.raises(ValueError):
        K4.check_args(rel, None, kp, w, torch.zeros(2, 8, 15))
    with pytest.raises(ValueError, match="devices"):
        K4.kpconv_fused_fwd(rel, nx.to("meta"), kp, w, EXTENT)


def test_rows_pass_a_column_slice_of_the_joint_gather_as_it_is():
    gathered = torch.randn(2, 5, 4, 3 + 8)
    nx = gathered[..., 3:]
    x, ld = K4._rows(nx)
    assert ld == 11 and x.data_ptr() == nx.data_ptr()  # no copy: rows at stride 11
    x, ld = K4._rows(nx.contiguous())
    assert ld == 8
    x, ld = K4._rows(gathered.transpose(1, 2)[..., 3:].transpose(1, 2)[:, ::2])
    assert ld == 8 and x.is_contiguous()  # rows at no uniform stride: copied
