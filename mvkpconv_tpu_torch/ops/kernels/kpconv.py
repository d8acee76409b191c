"""K4: fused rigid KPConv after the gather — wrappers, plain versions,
launch counts and the autograd Function.

Counterpart of ``mvkpconv_tpu/ops/pallas/kpconv.py:kpconv_fused`` (linear
influence, sum aggregation). With ``neighb_rel`` (B, N, K, 3) f32 the
gathered neighbor positions minus the query, ``nx`` (B, N, K, Cin) the
gathered features in f32 or bf16, ``kernel_pts`` (M, 3) f32 and
``weights2d`` (M·Cin, Cout) f32:

    w[q,k,m]        = max(1 − sqrt(|rel[q,k] − kp[m]|²) / extent, 0)
    wf[q, m·Cin+c]  = Σ_k w[q,k,m] · nx[q,k,c]
    out[q, o]       = Σ_r wf[q,r] · W[r,o]                       (B, N, Cout) f32

``nx`` is widened to f32; the influence, ``W`` and every sum are f32. d² is
the difference form of ``_reference_math`` in the kernels and the plain
versions alike (the TPU kernel's ‖rel‖² − 2 rel·kp + ‖kp‖² cancels near a
kernel point). Shadow neighbors (rel ≈ 1e6, zero feature row) get influence
exactly 0. Nothing of size (B, N, K, M) is kept: the backward recomputes the
influence from the forward's inputs.

Three kernels (``csrc/kpconv.cu``), each with its plain version and its
launch count: :func:`kpconv_fused_fwd`, :func:`kpconv_fused_bwd_x` (the
cotangent of ``nx``: an f32 sum, written as f32 or, with
``out_dtype=torch.bfloat16``, rounded once to bf16 by the kernel itself, which
is what a bf16 ``nx`` takes) and :func:`kpconv_wf` (``wf`` on its own; the weight
gradient is then ``wfᵀ @ g``, one matrix product over all B·N queries, as the
JAX package leaves it to XLA). :class:`KPConvFused` ties them into autograd;
``neighb_rel`` and ``kernel_pts`` get no gradient from it (no rigid path asks
for one) and it raises if either requires one. :func:`kpconv_fused_plain`
gives all four through autograd.

CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise. The forward is the ``torch.library`` operator
``mvkpconv::kpconv_fused_fwd`` (CPU kernel: the plain version; CUDA kernel:
``csrc/kpconv.cu``; a fake kernel for ``torch.export``); ``bwd_x`` and
``wf`` run only in a backward, which no exported program holds, and stay
plain calls.
"""

from __future__ import annotations

import torch

from mvkpconv_tpu_torch.ops.common import check_tensor

MAX_K = 128  # csrc/kpconv.cu kMaxK
MAX_M = 32  # csrc/kpconv.cu kMaxM


def _influence(neighb_rel, kernel_pts, kp_extent: float) -> torch.Tensor:
    """(B, N, K, M) linear influence, in ``neighb_rel``'s float type."""
    diff = neighb_rel[..., None, :] - kernel_pts
    sq = (diff * diff).sum(dim=-1)
    return (1.0 - torch.sqrt(sq) / kp_extent).clamp(min=0.0)


def kpconv_wf_plain(neighb_rel, nx, kernel_pts, kp_extent: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`kpconv_wf`: (B, N, M·Cin)."""
    w = _influence(neighb_rel, kernel_pts, kp_extent)
    wf = torch.einsum("bqkm,bqkc->bqmc", w, nx.to(w.dtype))
    return wf.reshape(wf.shape[0], wf.shape[1], -1)


def kpconv_fused_plain(neighb_rel, nx, kernel_pts, weights2d, kp_extent: float) -> torch.Tensor:
    """Plain PyTorch version of the fused forward: (B, N, Cout), f32 for f32
    geometry and weights (float64 inputs give a float64 evaluation).
    Differentiable in all four tensors."""
    return torch.matmul(kpconv_wf_plain(neighb_rel, nx, kernel_pts, kp_extent), weights2d)


def kpconv_fused_bwd_x_plain(neighb_rel, g, kernel_pts, weights2d, kp_extent: float,
                             out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`kpconv_fused_bwd_x`: (B, N, K, Cin) in
    the inputs' float type, or that sum rounded once to ``out_dtype``."""
    m = kernel_pts.shape[0]
    w = _influence(neighb_rel, kernel_pts, kp_extent)
    gw = torch.matmul(g, weights2d.t()).reshape(g.shape[0], g.shape[1], m, -1)
    dx = torch.einsum("bqkm,bqmc->bqkc", w, gw)
    return dx if out_dtype is None else dx.to(out_dtype)


def _rows(nx: torch.Tensor):
    """``nx`` as the kernels read it — rows of Cin elements at a uniform
    stride — and that stride. A column slice of a contiguous tensor (the
    feature columns of the joint gather) passes as it is."""
    ld = nx.stride(2)
    _, n, k, cin = nx.shape
    if nx.stride(3) == 1 and ld >= cin and nx.stride(1) == k * ld and nx.stride(0) == n * k * ld:
        return nx, ld
    return nx.contiguous(), cin


def check_args(neighb_rel, nx, kernel_pts, weights2d=None, g=None, out_dtype=None) -> None:
    """Raise on anything the CUDA kernels do not take."""
    if out_dtype not in (None, torch.float32, torch.bfloat16):
        raise TypeError(f"kpconv_fused_bwd_x: out_dtype {out_dtype}; float32 or bfloat16")
    check_tensor("neighb_rel", neighb_rel, torch.float32, 4)
    dev = neighb_rel.device
    check_tensor("kernel_pts", kernel_pts, torch.float32, 2, device=dev)
    b, n, k, three = neighb_rel.shape
    m = kernel_pts.shape[0]
    if three != 3 or kernel_pts.shape[1] != 3 or not 1 <= k <= MAX_K or not 1 <= m <= MAX_M:
        raise ValueError(
            f"kpconv_fused: neighb_rel {tuple(neighb_rel.shape)}, kernel_pts "
            f"{tuple(kernel_pts.shape)}; K <= {MAX_K}, M <= {MAX_M}"
        )
    cin = None
    if nx is not None:
        if nx.dtype not in (torch.float32, torch.bfloat16) or nx.dim() != 4 or nx.device != dev:
            raise TypeError(f"nx: {nx.dtype} rank {nx.dim()} on {nx.device}")
        if tuple(nx.shape[:3]) != (b, n, k) or nx.shape[3] < 1:
            raise ValueError(f"nx {tuple(nx.shape)} for neighb_rel {tuple(neighb_rel.shape)}")
        cin = nx.shape[3]
    if weights2d is not None:
        check_tensor("weights2d", weights2d, torch.float32, 2, device=dev)
        r, cout = weights2d.shape
        if r % m or r < m or cout < 1 or (cin is not None and r != m * cin):
            raise ValueError(f"weights2d {tuple(weights2d.shape)} for M={m}, Cin={cin}")
        cin = r // m
        if g is not None:
            check_tensor("g", g, torch.float32, 3, device=dev)
            if tuple(g.shape) != (b, n, cout):
                raise ValueError(f"g {tuple(g.shape)}, expected {(b, n, cout)}")
    q = b * n
    if q * k * (cin + 3) >= 2**31 or q * m * cin >= 2**31:
        raise ValueError(f"kpconv_fused: too large (B·N={q}, K={k}, M={m}, Cin={cin})")


def _on_cpu(*tensors) -> bool:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds != {"cuda"}:
        raise ValueError(f"kpconv_fused: unsupported devices {sorted(kinds)}")
    return False


torch.library.define(
    "mvkpconv::kpconv_fused_fwd",
    "(Tensor neighb_rel, Tensor nx, Tensor kernel_pts, Tensor weights2d, float kp_extent) -> Tensor",
)
kpconv_fused_fwd_op = torch.ops.mvkpconv.kpconv_fused_fwd.default


@torch.library.impl("mvkpconv::kpconv_fused_fwd", "cuda")
def _kpconv_fused_fwd_cuda(neighb_rel, nx, kernel_pts, weights2d, kp_extent):
    """The CUDA kernel of ``mvkpconv::kpconv_fused_fwd``."""
    check_args(neighb_rel, nx, kernel_pts, weights2d)
    from mvkpconv_tpu_torch.ops import _build

    lib = _build.library()
    b, n, k, _ = neighb_rel.shape
    m, cout = kernel_pts.shape[0], weights2d.shape[1]
    x, ldx = _rows(nx)
    out = torch.empty((b, n, cout), dtype=torch.float32, device=nx.device)
    if b * n:
        with torch.cuda.device(nx.device):
            rc = lib.mvkp_kpconv_fwd(
                neighb_rel.data_ptr(), x.data_ptr(), int(x.dtype == torch.bfloat16), ldx,
                kernel_pts.data_ptr(), weights2d.data_ptr(), out.data_ptr(),
                b * n, k, m, x.shape[3], cout, float(kp_extent),
                torch.cuda.current_stream(nx.device).cuda_stream,
            )
        _build.check_launch("kpconv_fused_fwd", rc)
        kpconv_fused_fwd.launches += 1
    return out


torch.library.impl("mvkpconv::kpconv_fused_fwd", "cpu", kpconv_fused_plain)


@torch.library.register_fake("mvkpconv::kpconv_fused_fwd")
def _kpconv_fused_fwd_fake(neighb_rel, nx, kernel_pts, weights2d, kp_extent):
    dtype = torch.promote_types(neighb_rel.dtype, weights2d.dtype)
    return nx.new_empty((nx.shape[0], nx.shape[1], weights2d.shape[1]), dtype=dtype)


def kpconv_fused_fwd(neighb_rel, nx, kernel_pts, weights2d, kp_extent: float) -> torch.Tensor:
    """The fused forward, (B, N, Cout) f32: the operator
    ``mvkpconv::kpconv_fused_fwd``."""
    _on_cpu(neighb_rel, nx, kernel_pts, weights2d)  # raises on mixed or other devices
    return kpconv_fused_fwd_op(neighb_rel, nx, kernel_pts, weights2d, float(kp_extent))


def kpconv_fused_bwd_x(neighb_rel, g, kernel_pts, weights2d, kp_extent: float,
                       out_dtype=None) -> torch.Tensor:
    """The cotangent of ``nx`` for the output cotangent ``g`` (B, N, Cout):
    (B, N, K, Cin), f32 unless ``out_dtype`` says bf16 (the f32 sum rounded
    to nearest even once, bit for bit what ``.to(torch.bfloat16)`` gives)."""
    if _on_cpu(neighb_rel, g, kernel_pts, weights2d):
        return kpconv_fused_bwd_x_plain(neighb_rel, g, kernel_pts, weights2d, kp_extent, out_dtype)
    check_args(neighb_rel, None, kernel_pts, weights2d, g, out_dtype)
    out_dtype = out_dtype or torch.float32
    from mvkpconv_tpu_torch.ops import _build

    lib = _build.library()
    b, n, k, _ = neighb_rel.shape
    m, cout = kernel_pts.shape[0], weights2d.shape[1]
    cin = weights2d.shape[0] // m
    dx = torch.empty((b, n, k, cin), dtype=out_dtype, device=g.device)
    if b * n:
        with torch.cuda.device(g.device):
            rc = lib.mvkp_kpconv_bwd_x(
                neighb_rel.data_ptr(), g.data_ptr(), kernel_pts.data_ptr(),
                weights2d.data_ptr(), dx.data_ptr(), int(out_dtype == torch.bfloat16),
                b * n, k, m, cin, cout, float(kp_extent),
                torch.cuda.current_stream(g.device).cuda_stream,
            )
        _build.check_launch("kpconv_fused_bwd_x", rc)
        kpconv_fused_bwd_x.launches += 1
    return dx


def kpconv_wf(neighb_rel, nx, kernel_pts, kp_extent: float) -> torch.Tensor:
    """The per-kernel-point weighted neighbor sums, (B, N, M·Cin) f32."""
    if _on_cpu(neighb_rel, nx, kernel_pts):
        return kpconv_wf_plain(neighb_rel, nx, kernel_pts, kp_extent)
    check_args(neighb_rel, nx, kernel_pts)
    from mvkpconv_tpu_torch.ops import _build

    lib = _build.library()
    b, n, k, _ = neighb_rel.shape
    m = kernel_pts.shape[0]
    x, ldx = _rows(nx)
    cin = x.shape[3]
    wf = torch.empty((b, n, m * cin), dtype=torch.float32, device=nx.device)
    if b * n:
        with torch.cuda.device(nx.device):
            rc = lib.mvkp_kpconv_wf(
                neighb_rel.data_ptr(), x.data_ptr(), int(x.dtype == torch.bfloat16), ldx,
                kernel_pts.data_ptr(), wf.data_ptr(), b * n, k, m, cin, float(kp_extent),
                torch.cuda.current_stream(nx.device).cuda_stream,
            )
        _build.check_launch("kpconv_wf", rc)
        kpconv_wf.launches += 1
    return wf


kpconv_fused_fwd.launches = 0
kpconv_fused_bwd_x.launches = 0
kpconv_wf.launches = 0


def weight_gradient(neighb_rel, nx, kernel_pts, g, kp_extent: float) -> torch.Tensor:
    """``dW = wfᵀ @ g`` (M·Cin, Cout) f32 over all B·N queries; ``wf`` (about
    260 MB at the bench configuration's first block) is freed on return."""
    wf = kpconv_wf(neighb_rel, nx, kernel_pts, kp_extent)
    return torch.matmul(wf.reshape(-1, wf.shape[-1]).t(), g.reshape(-1, g.shape[-1]))


class KPConvFused(torch.autograd.Function):
    """``kpconv_fused`` with its backward: the forward saves only its
    inputs; the backward launches ``bwd_x`` and ``wf`` for the inputs whose
    gradient is needed. ``bwd_x`` writes the cotangent of ``nx`` in ``nx``'s
    dtype itself (a bf16 primal takes a bf16 cotangent, as in JAX)."""

    @staticmethod
    def forward(ctx, neighb_rel, nx, kernel_pts, weights2d, kp_extent):
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[2]:
            raise ValueError(
                "kpconv_fused gives no gradient to neighb_rel or kernel_pts: "
                "detach them, or use kpconv_fused_plain"
            )
        ctx.kp_extent = float(kp_extent)
        ctx.save_for_backward(neighb_rel, nx, kernel_pts, weights2d)
        return kpconv_fused_fwd(neighb_rel, nx, kernel_pts, weights2d, ctx.kp_extent)

    @staticmethod
    def backward(ctx, g):
        neighb_rel, nx, kernel_pts, weights2d = ctx.saved_tensors
        g = g.contiguous()
        dnx = dw = None
        if ctx.needs_input_grad[1]:
            dnx = kpconv_fused_bwd_x(neighb_rel, g, kernel_pts, weights2d, ctx.kp_extent, nx.dtype)
        if ctx.needs_input_grad[3]:
            dw = weight_gradient(neighb_rel, nx, kernel_pts, g, ctx.kp_extent)
        return None, dnx, None, dw, None


def kpconv_fused(neighb_rel, nx, kernel_pts, weights2d, kp_extent: float) -> torch.Tensor:
    """Fused rigid KPConv (linear influence, sum aggregation) → (B, N, Cout)
    f32, differentiable in ``nx`` and ``weights2d``. Where no gradient is
    recorded it is the forward operator alone, which is what
    ``torch.export`` of an inference program keeps."""
    tensors = (neighb_rel, nx, kernel_pts, weights2d)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors)):
        return kpconv_fused_fwd(neighb_rel, nx, kernel_pts, weights2d, kp_extent)
    return KPConvFused.apply(neighb_rel, nx, kernel_pts, weights2d, kp_extent)
