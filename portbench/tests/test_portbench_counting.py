"""The counting functions behind ``mfu.*`` against counts made by hand (and
the UNet's against PyTorch's own FLOP counter), and the peak each class of
operations is held to under the TF32 switches."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import counting
from portbench.counting import LevelStats
from portbench.reference import unet
from portbench.weights import draw

SMALL = dict(architecture=["simple", "resnetb_strided", "nearest_upsample", "unary"],
             first_subsampling_dl=0.1, conv_radius=2.5, first_features_dim=16, num_kernel_points=15,
             num_classes=4, fusion="none", in_features_dim=5, feature_2d_dim=64, pixel_knn=3,
             num_points=[8, 4], conv_neighbors=[3, 3], pool_neighbors=[3], reference="portbench.reference")


def test_unet_flops_match_the_flop_counter():
    w = {k[7:]: v for k, v in draw(dict(SMALL, fusion="early", in_features_dim=66, num_views=1, image_height=20,
                                           image_width=30, num_points=[8, 4], batch_num=1, num_classes=4),
                                      0, "cpu").items() if k.startswith("net_2d.")}
    ones = lambda n, x: x  # noqa: E731
    with FlopCounterMode(display=False) as fc:
        x = unet.features(torch.zeros(1, 20, 30, 3), w, ones)
        torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w["logit.weight"])  # the logit conv, which features() skips
    assert counting.unet_flops(20, 30, 4) == fc.get_total_flops()


def test_kpconv_flops_by_hand():
    # level 0: 8 points, 20 real conv pairs; level 1: 4 points, 9 real pool
    # pairs into level 0; 8 upsample pairs
    stats = [LevelStats(8, 20, 9, 8), LevelStats(4, 10, 0, 0)]
    m = 15
    # simple 5 -> 16 (out 8): 2·20·15·5 + 2·8·15·5·8
    simple = 2 * 20 * m * 5 + 2 * 8 * m * 5 * 8
    flops = counting.forward_flops(SMALL, stats)
    enc = counting.trunk(SMALL)[0]["encoder"]
    assert [e[:3] for e in enc] == [("simple", 5, 16), ("resnetb_strided", 8, 16)]
    # resnetb_strided 8 -> 16 at the pool site (mid 4): unary1 8->4 on the 8
    # level-0 rows, the conv over 9 pairs for 4 queries, unary2 4->16 and the
    # shortcut 8->16 on the 4 level-1 rows
    strided = 2 * 8 * 8 * 4 + 2 * 9 * m * 4 + 2 * 4 * m * 4 * 4 + 2 * 4 * 4 * 16 + 2 * 4 * 8 * 16
    dec = counting.trunk(SMALL)[1]
    assert [e[:3] for e in dec] == [("nearest_upsample", 16, 32), ("unary", 16 + 8, 16)]
    unary = 2 * 8 * 24 * 16
    head = 2 * 8 * (16 * 16 + 16 * 4)
    assert flops == {"unet": 0.0, "trained": simple + strided + unary + head}
    off = {"matmul": False, "cudnn": False}
    assert counting.step_seconds_at_peak(SMALL, stats, True, off) == 3 * flops["trained"] / counting.PEAK_F32


@pytest.mark.parametrize("cudnn", [False, True])
@pytest.mark.parametrize("matmul", [False, True])
def test_each_class_is_held_to_the_peak_of_its_precision(matmul, cudnn):
    """The UNet's convolutions at TF32's peak only where cuDNN may use TF32,
    the trained layers only where matrix products may: float32's else."""
    model = dict(SMALL, fusion="early", in_features_dim=66, num_views=5, image_height=120, image_width=160,
                 batch_num=5, num_classes=20)
    stats = [LevelStats(8, 20, 9, 8), LevelStats(4, 10, 0, 0)]
    f = counting.forward_flops(model, stats)
    assert f["unet"] > 0 and f["trained"] > 0
    want = (f["unet"] / (counting.PEAK_TF32 if cudnn else counting.PEAK_F32)
            + f["trained"] / (counting.PEAK_TF32 if matmul else counting.PEAK_F32))
    got = counting.step_seconds_at_peak(model, stats, False, {"matmul": matmul, "cudnn": cudnn})
    assert got == pytest.approx(want, rel=1e-12)


def test_pyramid_stats_by_hand():
    # one sphere: 4 points on a line 0.1 apart at dl 0.1 (radius 0.25): each
    # point's neighbors within 0.25 are itself and those 0.1 and 0.2 away
    pts = torch.tensor([[[0.0, 0, 0], [0.1, 0, 0], [0.2, 0, 0], [0.3, 0, 0], [1e6, 1e6, 1e6]]])
    model = dict(SMALL, num_points=[5, 4], conv_neighbors=[8, 8], pool_neighbors=[8])
    s = counting.pyramid_stats({"points": pts, "mask": torch.tensor([[True] * 4 + [False]])}, model)
    assert s[0].points == 4 and s[0].conv_pairs == 3 + 4 + 4 + 3
    assert s[1].points == 2  # cells of 0.2: [0, 0.2) and [0.2, 0.4)
    assert s[0].up_pairs == 4
