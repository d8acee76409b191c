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
from mvkpconv_tpu_torch import tracing  # noqa: E402
from mvkpconv_tpu_torch.ops.kernels import kpconv as K4  # noqa: E402
from torch_threads import two_threads  # noqa: F401,E402  (autouse: two intra-op threads)

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
    before = tracing.launch_counts()["kpconv_fused_fwd"]
    np.testing.assert_array_equal(f32(K4.kpconv_fused_fwd(*targs, EXTENT)), f32(got))
    assert tracing.launch_counts()["kpconv_fused_fwd"] == before


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


# ---- the cotangent written in the primal's dtype ---------------------------


@pytest.mark.parametrize("via", ["plain", "wrapper"])
@pytest.mark.parametrize("cin", [8, 66])
def test_bwd_x_out_dtype_is_the_f32_sum_rounded_once(cin, via):
    """``out_dtype=torch.bfloat16`` gives bit for bit what casting the f32
    result gives (round to nearest even, once): the contract the CUDA kernel's
    bf16 store is held to on the card."""
    rel, nx, kp, w = to_torch(inputs(cin, n=40), "float32")
    g = torch.from_numpy(np.random.RandomState(3).randn(2, 40, 16).astype(np.float32))
    fn = K4.kpconv_fused_bwd_x_plain if via == "plain" else K4.kpconv_fused_bwd_x
    f32_result = fn(rel, g, kp, w, EXTENT)
    assert f32_result.dtype == torch.float32
    assert torch.equal(fn(rel, g, kp, w, EXTENT, out_dtype=torch.float32), f32_result)
    got = fn(rel, g, kp, w, EXTENT, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == nx.shape
    assert torch.equal(got, f32_result.to(torch.bfloat16))
    assert (got[:, 2:, -3:] == 0).all()  # shadow neighbors: exactly 0 in bf16 too
    # a float64 evaluation keeps its type unless told otherwise
    assert K4.kpconv_fused_bwd_x_plain(rel.double(), g.double(), kp.double(), w.double(), EXTENT).dtype == torch.float64


@pytest.mark.parametrize("cin", [8, 66])
def test_function_backward_returns_a_bf16_cotangent_for_bf16_features(cin):
    """``KPConvFused.backward`` hands ``nx.dtype`` to ``bwd_x`` and casts
    nothing afterwards: the result equals the f32 cotangent cast once, and
    still matches the JAX kernel's backward."""
    arrays = inputs(cin, n=SHAPES[cin] // 2 if cin == 66 else 128)
    trel, tnx, tkp, tw = to_torch(arrays, "bfloat16")
    g_np = np.random.RandomState(4).randn(*tnx.shape[:2], tw.shape[1]).astype(np.float32)
    g = torch.from_numpy(g_np)
    x = tnx.clone().requires_grad_(True)
    (dnx,) = torch.autograd.grad(K4.kpconv_fused(trel, x, tkp, tw, EXTENT), x, g)
    assert dnx.dtype == torch.bfloat16
    cast_after = K4.kpconv_fused_bwd_x(trel, g, tkp, tw, EXTENT).to(torch.bfloat16)
    assert torch.equal(dnx, cast_after)
    rel, nx, kp, w = to_jax(arrays, "bfloat16")
    _, vjp = jax.vjp(lambda a: jax_kpconv_fused(rel, a, kp, w, EXTENT, True), nx)
    (want,) = vjp(jnp.asarray(g_np))
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(f32(dnx), f32(want), **BF16_GRAD_TOL)


@pytest.mark.parametrize("out_dtype", [torch.float16, torch.float64, torch.int32])
def test_check_args_rejects_an_unsupported_out_dtype(out_dtype):
    rel, nx, kp, w = to_torch(inputs(8, n=8), "float32")
    g = torch.zeros(2, 8, 16)
    K4.check_args(rel, None, kp, w, g, torch.float32)
    K4.check_args(rel, None, kp, w, g, torch.bfloat16)
    K4.check_args(rel, None, kp, w, g, None)
    with pytest.raises(TypeError, match="out_dtype"):
        K4.check_args(rel, None, kp, w, g, out_dtype)


# ---- the split arithmetic of the tensor-core products ----------------------
# The CUDA kernels multiply on the tensor cores in TF32, which reads the upper
# 19 bits of an f32 register. Each f32 operand is split v = hi + lo (hi: v
# rounded to those bits by an integer add and a mask; lo: v - hi, exact in
# f32, rounded the same way when it is read), and hi*hi + hi*lo + lo*hi is
# accumulated in f32. This mirror of that arithmetic shows, where there is no
# card, that both of bwd_x's products stay within 2^-18 * sum|terms| of
# float64: the allowance the card-side check holds the kernels to.

KPCONV_REL = 2.0**-18


def split_tf32(v):
    """(hi, lo) as the tensor cores read them: ``csrc/kpconv.cu`` ``split_tf32``
    with the ignored low 13 bits of both cleared."""
    bits = v.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    lo = (((v - hi).contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    return hi, lo


def split_matmul(a, b):
    """``a @ b`` from TF32 operands: three products, cross terms summed apart."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return torch.matmul(a_hi, b_hi) + (torch.matmul(a_lo, b_hi) + torch.matmul(a_hi, b_lo))


def test_split_tf32_keeps_22_bits_and_is_exact_for_bf16():
    v = torch.from_numpy(np.random.RandomState(5).randn(4096).astype(np.float32)) * 37.0
    hi, lo = split_tf32(v)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all() and ((lo.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((v - (hi + lo)).abs() <= 2.0**-22 * v.abs()).all()
    assert ((v - hi).abs() <= 2.0**-11 * v.abs()).all()
    b = v.to(torch.bfloat16).float()  # a bf16 value is its own hi: one product suffices
    hi, lo = split_tf32(b)
    assert torch.equal(hi, b) and (lo == 0).all()
    zero_hi, zero_lo = split_tf32(torch.zeros(3))
    assert (zero_hi == 0).all() and (zero_lo == 0).all()  # an influence of 0 multiplies as 0


@pytest.mark.parametrize("one_product", [False, True])
@pytest.mark.parametrize("cin", [8, 66])
def test_split_products_of_bwd_x_stay_within_the_allowance_of_float64(cin, one_product):
    """``gw = g Wᵀ`` and ``dx = w gw`` done with split operands, on seeded
    inputs with shadow rows and padded queries: within 2⁻¹⁸·Σ|terms| of
    float64, shadow neighbors exactly 0; a single TF32 product (no split) is
    shown to break that allowance, so the test can fail."""
    rel, nx, kp, w = to_torch(inputs(cin, n=40), "float32")
    m = kp.shape[0]
    g = torch.from_numpy(np.random.RandomState(6).randn(2, 40, 16).astype(np.float32))
    infl = K4._influence(rel, kp, EXTENT)
    if one_product:
        mm = lambda a, b: torch.matmul(split_tf32(a)[0], split_tf32(b)[0])  # noqa: E731
    else:
        mm = split_matmul
    gw = mm(g, w.t())
    gw_ref = torch.matmul(g.double(), w.double().t())
    gw_allow = KPCONV_REL * torch.matmul(g.abs(), w.abs().t())
    dx = mm(infl, gw.reshape(2, 40, m, cin))
    dx_ref = torch.matmul(infl.double(), gw_ref.reshape(2, 40, m, cin))
    dx_allow = KPCONV_REL * torch.matmul(infl, torch.matmul(g.abs(), w.abs().t()).reshape(2, 40, m, cin))
    gw_over = float(((gw - gw_ref).abs() / (gw_allow + 1e-30)).max())
    dx_over = float(((dx - dx_ref).abs() / (dx_allow + 1e-30)).max())
    assert (dx[:, 2:, -3:] == 0).all()  # shadow neighbors
    assert torch.isfinite(dx[:, :2]).all() and (infl[:, :2, :, 0] == 1).all()  # padded queries
    if one_product:
        assert gw_over > 1.0 and dx_over > 1.0, (gw_over, dx_over)
    else:
        assert gw_over <= 1.0 and dx_over <= 1.0, (gw_over, dx_over)
        # and against the plain version, as the card-side check compares them
        want = K4.kpconv_fused_bwd_x_plain(rel, g, kp, w, EXTENT)
        assert float(((dx - want).abs() / (dx_allow + 1e-30)).max()) <= 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_product_of_wf_stays_within_the_allowance_of_float64(dtype):
    """``wf = wᵀ x`` as the kernel multiplies it: the influence split, a bf16
    row as it is (one operand exact), an f32 row split too."""
    rel, nx, kp, _ = to_torch(inputs(8, n=40), dtype)
    infl = K4._influence(rel, kp, EXTENT)
    wf = split_matmul(infl.transpose(2, 3), nx.float())
    ref = torch.matmul(infl.double().transpose(2, 3), nx.double())
    allow = KPCONV_REL * torch.matmul(infl.transpose(2, 3), nx.float().abs()) + 1e-30
    assert float(((wf - ref).abs() / allow).max()) <= 1.0
    want = K4.kpconv_wf_plain(rel, nx, kp, EXTENT).reshape(wf.shape)
    assert float(((wf - want).abs() / allow).max()) <= 1.0
