"""K5: one convolution site of the frozen UNet, fused — wrapper, plain
version, operator.

No TPU kernel is replaced (the JAX UNet is flax ``nn.Conv`` on XLA); the
port's float32 UNet ran on cuDNN's FFT GEMM in 2,666 launches a call, and
this kernel (``csrc/unet_conv.cu``) runs each site in one. With activations
NHWC float32, ``x`` (B, H, W, C1) and the decoder's skip ``skip`` (B, H, W,
C2) read as one input of C1 + C2 channels (``torch.cat`` of the two, never
written):

    conv:       y = conv2d(pad(x), weight (Cout, C1+C2, k, k), bias, stride, padding)[:, :out_h, :out_w]
    transposed: y = conv_transpose2d(x, weight (C1, Cout, 2, 2), bias, stride 2)
    out = relu?(bn(y) + residual)           (B, out_h, out_w, Cout) NHWC f32

``bn`` is the eval batch norm of ``models/norm.py``, ``(y − mean) ·
(rsqrt(var + eps) · weight) + bias``; ``pad`` zero-pads the bottom and right
where ``out_h``/``out_w`` need more input than there is (the image padded
to a multiple of 16: the stem); a smaller ``out_h``/``out_w`` crops (the
last decoder conv, at the image's own size).

:func:`unet_conv` calls the ``torch.library`` operator ``mvkpconv::unet_conv``:
its CPU kernel is :func:`unet_conv_plain`, which runs the module path's own
calls in the module path's order and layouts, so that on the CPU the two
paths give the same bits; its CUDA kernel launches ``csrc/unet_conv.cu``
(3×TF32 on the tensor cores, float32-exact); a fake kernel gives the shape
for ``torch.export``.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from mvkpconv_tpu_torch.ops import _build
from mvkpconv_tpu_torch.ops.common import check_devices, check_tensor

CHUNK = 16  # csrc/unet_conv.cu kBK: the channels of a K chunk
COLUMNS = 64  # csrc/unet_conv.cu kBN: the output columns of a block


def plan(m: int, n: int, chunks: int, sms: int) -> Tuple[int, int]:
    """(rows, splits) of a site of ``m`` x ``n`` outputs (``n`` = 4·Cout for
    the transposed conv) on a card of ``sms`` SMs: a block's output rows
    (``csrc/unet_conv.cu``; the halo mode takes 128 whatever this says) and
    the K splits, each split a block along z whose sums
    ``unet_conv_finish`` adds in order. ``chunks`` is the K chunks where
    the K may split, else 0 (the stem's gather, the transposed conv). Where
    128-row tiles would leave SMs without a block (the deepest sites), enough
    splits of at least 8 chunks each to give two blocks an SM, counted as
    the kernel cuts them; 128-row tiles where they give at least 1.5 blocks
    an SM, else 64."""
    tiles = -(-m // 128) * -(-n // COLUMNS)
    splits = 1
    if chunks and tiles < sms:
        splits = max(1, min(-(-2 * sms // tiles), chunks // 8))
        splits = -(-chunks // -(-chunks // splits))  # ceil(chunks / the chunks of a split)
    return (128 if 2 * tiles * splits >= 3 * sms else 64), splits


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def unet_conv_plain(x, skip, weight, bias, bn_weight, bn_bias, bn_mean, bn_var, residual,
                    stride: int, padding: int, out_h: int, out_w: int, transposed: bool, relu: bool,
                    eps: float) -> torch.Tensor:
    """Plain PyTorch version: the module path's calls, on NCHW views of the
    NHWC tensors: channels-last in memory, as the module path's activations
    are from the padded image on."""
    xs = x.permute(0, 3, 1, 2)
    if skip is not None:
        xs = torch.cat([xs, skip.permute(0, 3, 1, 2)], dim=1)
    if transposed:
        y = F.conv_transpose2d(xs, weight, bias, stride=2)
    else:
        k = weight.shape[2]
        eh = max(0, (out_h - 1) * stride + k - 2 * padding - xs.shape[2])
        ew = max(0, (out_w - 1) * stride + k - 2 * padding - xs.shape[3])
        if eh or ew:
            xs = F.pad(xs, (0, ew, 0, eh))
        y = F.conv2d(xs, weight, bias, stride, padding)[:, :, :out_h, :out_w]
    if bn_weight is not None:
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(bn_var + eps) * bn_weight
        y = (y - bn_mean.view(shape)) * mul.view(shape)
        y = y + bn_bias.view(shape)
    if residual is not None:
        y = y + residual.permute(0, 3, 1, 2)
    if relu:
        y = F.relu(y)
    return y.permute(0, 2, 3, 1).contiguous()


def _out_channels(weight, transposed: bool) -> int:
    return weight.shape[1] if transposed else weight.shape[0]


def check_args(x, skip, weight, bias, bn, residual, stride, padding, out_h, out_w, transposed) -> None:
    """Raise on anything the CUDA kernel does not take."""
    check_tensor("x", x, torch.float32, 4)
    dev = x.device
    b, h, w, c1 = x.shape
    c2 = 0
    if skip is not None:
        check_tensor("skip", skip, torch.float32, 4, device=dev)
        if tuple(skip.shape[:3]) != (b, h, w):
            raise ValueError(f"unet_conv: skip {tuple(skip.shape)} beside x {tuple(x.shape)}")
        c2 = skip.shape[3]
    check_tensor("weight", weight, torch.float32, 4, device=dev)
    cout = _out_channels(weight, transposed)
    for name, t in (("bias", bias), *zip(("bn_weight", "bn_bias", "bn_mean", "bn_var"), bn)):
        if t is not None:
            check_tensor(name, t, torch.float32, 1, device=dev)
            if t.shape[0] != cout:
                raise ValueError(f"unet_conv: {name} {tuple(t.shape)} for {cout} output channels")
    if len({t is None for t in bn}) > 1:
        raise ValueError("unet_conv: the batch norm takes all four vectors or none")
    if transposed:
        if tuple(weight.shape) != (c1, cout, 2, 2) or stride != 2 or padding != 0 or skip is not None \
                or residual is not None or (out_h, out_w) != (2 * h, 2 * w) or c1 % CHUNK or cout % CHUNK:
            raise ValueError(f"unet_conv: transposed conv of weight {tuple(weight.shape)} on x {tuple(x.shape)}; "
                             f"2x2 stride 2, C1 and Cout multiples of {CHUNK}, no skip or residual")
    else:
        if weight.shape[1] != c1 + c2 or weight.shape[2] != weight.shape[3] or stride < 1 or padding < 0:
            raise ValueError(f"unet_conv: weight {tuple(weight.shape)} for {c1} + {c2} input channels")
        if (c1 % CHUNK or c2 % CHUNK) and skip is not None:
            raise ValueError(f"unet_conv: two inputs need multiples of {CHUNK} channels, got {c1} + {c2}")
    if residual is not None:
        check_tensor("residual", residual, torch.float32, 4, device=dev)
        if tuple(residual.shape) != (b, out_h, out_w, cout):
            raise ValueError(f"unet_conv: residual {tuple(residual.shape)}, expected {(b, out_h, out_w, cout)}")
    if b * max(h * w * (c1 + c2), out_h * out_w * cout * (4 if transposed else 1)) >= 2**31:
        raise ValueError(f"unet_conv: too large (x {tuple(x.shape)}, {cout} output channels)")


torch.library.define(
    "mvkpconv::unet_conv",
    "(Tensor x, Tensor? skip, Tensor weight, Tensor? bias, Tensor? bn_weight, Tensor? bn_bias, "
    "Tensor? bn_mean, Tensor? bn_var, Tensor? residual, int stride, int padding, int out_h, int out_w, "
    "bool transposed, bool relu, float eps) -> Tensor",
)
unet_conv_op = torch.ops.mvkpconv.unet_conv.default


@torch.library.impl("mvkpconv::unet_conv", "cuda")
def _unet_conv_cuda(x, skip, weight, bias, bn_weight, bn_bias, bn_mean, bn_var, residual,
                    stride, padding, out_h, out_w, transposed, relu, eps):
    """The CUDA kernel of ``mvkpconv::unet_conv``."""
    bn = (bn_weight, bn_bias, bn_mean, bn_var)
    check_args(x, skip, weight, bias, bn, residual, stride, padding, out_h, out_w, transposed)
    b, h, w, c1 = x.shape
    cout = _out_channels(weight, transposed)
    out = torch.empty((b, out_h, out_w, cout), dtype=torch.float32, device=x.device)

    c2 = 0 if skip is None else skip.shape[3]
    splittable = not transposed and c1 % CHUNK == 0 and c2 % CHUNK == 0 and cout % 4 == 0
    m, n = (b * h * w, 4 * cout) if transposed else (b * out_h * out_w, cout)
    rows, splits = plan(m, n, (c1 + c2) // CHUNK if splittable else 0, _sms(x.device.index))
    partial = None
    if splits > 1:
        partial = torch.empty((splits, m, n), dtype=torch.float32, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    if out.numel():
        _build.launch(
            "mvkp_unet_conv", x.device,
            x.data_ptr(), ptr(skip), weight.data_ptr(), ptr(bias), *map(ptr, bn), ptr(residual),
            out.data_ptr(), b, h, w, c1, c2, h if transposed else out_h, w if transposed else out_w, cout,
            weight.shape[2], weight.shape[3], stride, padding, int(transposed), int(relu), float(eps),
            ptr(partial), splits, rows,
            count=1 + (splits > 1),  # a split conv's sums are added by a second launch
        )
    return out


torch.library.impl("mvkpconv::unet_conv", "cpu", unet_conv_plain)


@torch.library.register_fake("mvkpconv::unet_conv")
def _unet_conv_fake(x, skip, weight, bias, bn_weight, bn_bias, bn_mean, bn_var, residual,
                    stride, padding, out_h, out_w, transposed, relu, eps):
    return x.new_empty((x.shape[0], out_h, out_w, _out_channels(weight, transposed)))


def natural_size(x, weight, stride: int, padding: int, transposed: bool):
    """The conv's own output size for NHWC ``x``: twice the input's for the
    2x2 stride-2 transposed conv."""
    h, w, k = x.shape[1], x.shape[2], weight.shape[2]
    if transposed:
        return 2 * h, 2 * w
    return (h + 2 * padding - k) // stride + 1, (w + 2 * padding - k) // stride + 1


def unet_conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None, bn=None, *,
              skip: Optional[torch.Tensor] = None, residual: Optional[torch.Tensor] = None, stride: int = 1,
              padding: int = 0, out_size=None, transposed: bool = False, relu: bool = False) -> torch.Tensor:
    """One UNet site, (B, out_h, out_w, Cout) NHWC f32: the operator
    ``mvkpconv::unet_conv``. ``bn`` is a ``models.norm.BatchNorm`` (its
    running statistics) or None; ``out_size`` defaults to the conv's own
    output size (twice the input's for the transposed conv)."""
    check_devices("unet_conv", x, weight, skip, residual)
    if out_size is None:
        out_size = natural_size(x, weight, stride, padding, transposed)
    vectors = (None,) * 4 if bn is None else (bn.weight, bn.bias, bn.running_mean, bn.running_var)
    eps = 1e-5 if bn is None else bn.epsilon
    return unet_conv_op(x, skip, weight, bias, *vectors, residual, int(stride), int(padding),
                        int(out_size[0]), int(out_size[1]), bool(transposed), bool(relu), float(eps))
