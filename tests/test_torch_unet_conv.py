"""PyTorch port: K5, the frozen UNet's fused convolution sites
(``mvkpconv_tpu_torch/ops/kernels/unet_conv.py``, ``csrc/unet_conv.cu``) and
the UNet's choice between its two paths (``models/unet2d.py``).

  * The operator's CPU kernel (the plain version) equals the module path bit
    for bit at each kind of site: the 7x7 stem on the image padded to a
    multiple of 16, a residual block with the identity and one with the 1x1
    stride-2 projection, the 2x2 transposed conv, the decoder conv on two
    inputs (the concat) cropped to the image, and the logit conv.
  * The whole UNet at the published widths: ``feature`` and ``seg_logit``
    of the K5 path equal the module path's bit for bit, ``feature``
    contiguous at the image's size.
  * Dispatch: eval mode, float32 with cuDNN's TF32 off and no gradient to
    record take K5 (``fused_calls``); training mode, a gradient through
    trainable parameters or the image, bf16, and TF32 allowed take the
    modules (``module_calls``), where gradients still flow. The state dict
    is untouched.

Every test runs with ``torch.backends.cudnn.allow_tf32`` False (the
benchmark's precision, under which the UNet takes K5), restored after.
  * The fake kernel gives the real shapes, and ``torch.export`` of a frozen
    UNet keeps one ``mvkpconv::unet_conv`` a site.
  * The tile plan (rows, K splits) follows the site's shape and the card's
    SMs. The wrapper refuses what the kernel does not take; on a card
    (skipped without one) the kernel meets the plain version at small shapes.
"""

import copy
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from mvkpconv_tpu_torch.models.unet2d import BasicBlock, UNetResNet34, _ConvBlock, _DeconvBlock, _site
from mvkpconv_tpu_torch.ops.kernels import unet_conv as k5
from torch_threads import two_threads  # noqa: F401,E402  (autouse: two intra-op threads)

SITES = 45  # convolution sites of a UNet-ResNet34 forward: one launch each on the card


@pytest.fixture(autouse=True)
def tf32_off(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)


def randomize_bn(module, seed=0):
    """Running statistics and affine parameters away from the identity."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if hasattr(m, "running_var"):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)
                m.weight.copy_(1 + torch.randn(m.weight.shape, generator=g) * 0.1)
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)
    return module.eval()


def nhwc(shape, seed=1):
    """A (B, H, W, C) input, and the module path's view of it: NCHW in
    channels-last memory, as the UNet's activations lie from the stem on."""
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(seed))
    return x, x.permute(0, 3, 1, 2)


def to_nhwc(y):
    return y.permute(0, 2, 3, 1)


@pytest.mark.parametrize("kind", ["stem", "identity", "projection", "transposed", "two_sources", "logit"])
def test_plain_version_equals_the_module_path_at_each_site(kind):
    torch.manual_seed(0)
    with torch.no_grad():
        if kind == "stem":
            net = randomize_bn(UNetResNet34())
            image = torch.rand(2, 20, 30, 3, generator=torch.Generator().manual_seed(2))
            want = F.relu(net.bn0(net.encoder0(F.pad(image.permute(0, 3, 1, 2), (0, 2, 0, 12)))))
            got = _site(net.encoder0, net.bn0, image, out_size=(32, 32))
        elif kind in ("identity", "projection"):
            blk = randomize_bn(BasicBlock(64, 64) if kind == "identity" else BasicBlock(64, 128, stride=2))
            x, xs = nhwc((2, 10, 12, 64))
            y = F.relu(blk.bn1(blk.conv1(xs)))
            want = F.relu(blk.bn2(blk.conv2(y)) + (xs if blk.proj is None else blk.proj_bn(blk.proj(xs))))
            y = _site(blk.conv1, blk.bn1, x)
            residual = x if blk.proj is None else _site(blk.proj, blk.proj_bn, x, relu=False)
            got = _site(blk.conv2, blk.bn2, y, residual=residual)
        elif kind == "transposed":
            blk = randomize_bn(_DeconvBlock(128, 64, torch.float32))
            x, xs = nhwc((2, 5, 6, 128))
            want = F.relu(blk.bn(blk.deconv(xs)))
            got = _site(blk.deconv, blk.bn, x)
        elif kind == "two_sources":
            blk = randomize_bn(_ConvBlock(64 + 64, 64, torch.float32))
            x, xs = nhwc((2, 16, 16, 64))
            skip, skips = nhwc((2, 16, 16, 64), seed=3)
            want = F.relu(blk.bn(blk.conv(torch.cat([xs, skips], dim=1))))[:, :, :13, :]  # the last, cropped
            got = _site(blk.conv, blk.bn, x, skip=skip, out_size=(13, 16))
        else:
            net = UNetResNet34(num_classes=20).eval()
            x, xs = nhwc((2, 13, 16, 64))
            want = net.logit(xs)
            got = _site(net.logit, None, x, relu=False)
    assert got.is_contiguous() and got.shape == to_nhwc(want).shape
    assert torch.equal(got, to_nhwc(want))


@pytest.mark.parametrize("hw", [(20, 30), (32, 48)])
def test_whole_unet_paths_are_equal_bit_for_bit(hw):
    net = randomize_bn(UNetResNet34(num_classes=20))
    image = torch.rand(2, *hw, 3, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want = net._forward_modules(image)
        got = net(image)
    for k in ("feature", "seg_logit"):
        assert got[k].shape == want[k].shape == (2, *hw, 64 if k == "feature" else 20)
        assert torch.equal(got[k], want[k]), k
    assert got["feature"].is_contiguous()


def counted(net, image):
    before = UNetResNet34.fused_calls, UNetResNet34.module_calls
    out = net(image)
    return out, (UNetResNet34.fused_calls - before[0], UNetResNet34.module_calls - before[1])


def test_dispatch_by_what_the_call_can_observe(monkeypatch):
    net = randomize_bn(UNetResNet34(num_classes=5))
    image = torch.rand(1, 16, 16, 3)
    with torch.no_grad():
        assert counted(net, image)[1] == (1, 0)  # eval, no grad, f32, TF32 off: K5
        # TF32 allowed (PyTorch's default): cuDNN's single-pass TF32 as asked, on the modules
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
        assert counted(net, image)[1] == (0, 1)
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    # a gradient to record through trainable parameters: the modules, and it flows
    out, calls = counted(net, image)
    assert calls == (0, 1)
    out["seg_logit"].sum().backward()
    assert net.encoder0.weight.grad is not None and net.logit.bias.grad is not None
    # frozen parameters and an image that needs no gradient: nothing to record
    for p in net.parameters():
        p.requires_grad_(False)
    assert counted(net, image)[1] == (1, 0)
    # ... unless the image needs one
    out, calls = counted(net, image.clone().requires_grad_(True))
    assert calls == (0, 1) and out["feature"].requires_grad
    # training mode (batch statistics) and bf16 take the modules
    with torch.no_grad():
        assert counted(net.train(), image)[1] == (0, 1)
        bf16 = UNetResNet34(num_classes=5, dtype=torch.bfloat16).eval()
        assert counted(bf16, image)[1] == (0, 1)


def test_the_state_dict_is_the_modules_own():
    net = randomize_bn(UNetResNet34(num_classes=20))
    before = {k: v.clone() for k, v in net.state_dict().items()}
    with torch.no_grad():
        net(torch.rand(1, 16, 16, 3))
    after = net.state_dict()
    # 44 batch norms of 4 entries; 45 conv weights; the 4 transposed convs' and the logit's biases
    assert list(after) == list(before) and len(after) == 44 * 4 + 45 + 5
    assert all(torch.equal(after[k], before[k]) for k in before)
    assert not any("unet_conv" in k or "fused" in k for k in after)


def site_args():
    """(x, weight, keyword arguments) of one site of each kind."""
    g = torch.Generator().manual_seed(5)
    w = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    bn = randomize_bn(UNetResNet34(num_classes=3)).bn0
    return [
        (w(2, 20, 30, 3), w(64, 3, 7, 7), dict(bn=bn, padding=3, out_size=(32, 32), relu=True)),
        (w(2, 8, 8, 64), w(64, 64, 3, 3), dict(bn=bn, padding=1, residual=w(2, 8, 8, 64), relu=True)),
        (w(2, 8, 8, 64), w(64, 64, 3, 3), dict(bn=bn, stride=2, padding=1)),
        (w(2, 4, 5, 64), w(64, 64, 2, 2), dict(bias=w(64), bn=bn, stride=2, transposed=True, relu=True)),
        (w(2, 8, 8, 32), w(64, 64, 3, 3), dict(bn=bn, padding=1, skip=w(2, 8, 8, 32), out_size=(6, 8))),
        (w(2, 6, 8, 64), w(3, 64, 1, 1), dict(bias=w(3))),
    ]


def test_fake_kernel_gives_the_real_shapes():
    for x, weight, kw in site_args():
        real = k5.unet_conv(x, weight, **kw)
        with FakeTensorMode(allow_non_fake_inputs=False) as mode:
            fake_kw = {k: mode.from_tensor(v) if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
            if kw.get("bn") is not None:
                bn = kw["bn"]
                fake_kw["bn"] = SimpleNamespace(epsilon=bn.epsilon, **{
                    k: mode.from_tensor(getattr(bn, k)) for k in ("weight", "bias", "running_mean", "running_var")})
            fake = k5.unet_conv(mode.from_tensor(x), mode.from_tensor(weight), **fake_kw)
        assert (tuple(fake.shape), fake.dtype) == (tuple(real.shape), real.dtype)


class Frozen(torch.nn.Module):
    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, image):
        out = self.net(image)
        return out["seg_logit"], out["feature"]


def test_export_of_a_frozen_unet_keeps_one_operator_a_site():
    net = randomize_bn(UNetResNet34(num_classes=4))
    image = torch.rand(1, 16, 16, 3)
    with torch.no_grad():
        program = torch.export.export(Frozen(net), (image,), strict=False)
        got, want = program.module()(image), Frozen(net)(image)
    calls = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert calls.count("mvkpconv.unet_conv.default") == SITES
    assert not any("convolution" in c for c in calls)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_tile_plan_follows_the_site_and_the_card():
    # the deepest conv of the cells' UNet (25 images, layer4: 2,000 rows x 512,
    # K = 512 x 9 in 32 chunks): 128 tiles leave an H100's 132 SMs short, so
    # the K splits in 3 of 11 chunks; a card of 66 SMs is full without a split
    assert k5.plan(2000, 512, 32, 132) == (128, 3)
    assert k5.plan(2000, 512, 32, 66) == (128, 1)
    assert k5.plan(512000, 64, 0, 132) == (128, 1)  # the stem: large, no split in its gather
    assert k5.plan(64, 64, 4, 132) == (64, 1)  # too few chunks to split: 64-row tiles
    for m, n, chunks, sms in [(2000, 512, 32, 132), (500, 256, 16, 132), (120, 512, 64, 78), (96, 64, 8, 132)]:
        rows, splits = k5.plan(m, n, chunks, sms)
        per = -(-chunks // splits)
        assert rows in (64, 128) and -(-chunks // per) == splits  # the kernel cuts the K the same way
        assert splits == 1 or per >= 8


def test_check_args_rejects_what_the_kernel_does_not_take():
    x, w = torch.zeros(1, 4, 4, 32), torch.zeros(16, 48, 3, 3)
    none = (None,) * 4
    k5.check_args(x, torch.zeros(1, 4, 4, 16), w, None, none, None, 1, 1, 4, 4, False)
    with pytest.raises(ValueError, match="multiples of 16"):  # two inputs need whole channel chunks
        k5.check_args(torch.zeros(1, 4, 4, 40), torch.zeros(1, 4, 4, 8), w, None, none, None, 1, 1, 4, 4, False)
    with pytest.raises(ValueError, match="transposed"):
        k5.check_args(x, None, torch.zeros(32, 16, 2, 2), None, none, torch.zeros(1, 8, 8, 16), 2, 0, 8, 8, True)
    with pytest.raises(ValueError, match="residual"):
        k5.check_args(x, None, torch.zeros(16, 32, 3, 3), None, none, torch.zeros(1, 3, 4, 16), 1, 1, 4, 4, False)
    with pytest.raises(ValueError, match="all four"):
        k5.check_args(x, None, torch.zeros(16, 32, 1, 1), None, (torch.zeros(16), None, None, None), None, 1, 0,
                      4, 4, False)
    with pytest.raises(ValueError, match="contiguous"):
        k5.check_args(x.permute(0, 2, 1, 3), None, torch.zeros(16, 32, 1, 1), None, none, None, 1, 0, 4, 4, False)


def test_kernel_meets_the_plain_version_on_a_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only there")
    dev = torch.device("cuda")

    def moved(kw, **to):
        return {k: copy.deepcopy(v).to(**to) if isinstance(v, (torch.Tensor, torch.nn.Module)) else v
                for k, v in kw.items()}

    for x, weight, kw in site_args():
        got = k5.unet_conv(x.to(dev), weight.to(dev), **moved(kw, device=dev))
        want = k5.unet_conv(x.double(), weight.double(), **moved(kw, dtype=torch.float64))
        assert float((got.cpu().double() - want).norm() / want.norm()) <= 1e-6
