"""PyTorch port: MVPNet3D against the benchmark's plain reference
(``portbench.reference_mvpnet``), on the CPU at a small size.

The port is built as ``infer.make_model(kind="mvpnet")`` builds it, with
PN2SSG's centroids cut through ``MVPNet3D``'s ``**pn2``; the weights are
drawn by ``portbench.weights.draw`` from the reference's ``tensors`` and
calibrated by the reference on the batch; the batch is two sliding chunks
of 512 points with two views of 24×32 from the benchmark's own generator
(``room_chunks``), fed as ``tools/test_mvpnet.py`` feeds it. The port's
probabilities are held to the reference's logits by ``logits_err``, the
benchmark's number (``portbench/check.py``), at 1e-5: both compute in
float32 in the same order wherever the published model fixes it, and read
0.0 apart here. One planted fault a part must fail it: a ball query's
radius changed, the max over the neighbours replaced by their mean, the
3-NN weights left unnormalised.
"""

import pytest
import torch

from mvkpconv_tpu_torch.infer import batch_to_device
from mvkpconv_tpu_torch.models import pn2
from mvkpconv_tpu_torch.models.mvpnet3d import MVPNet3D
from mvkpconv_tpu_torch.tools.train_mvpnet import chunk_batch
from mvkpconv_tpu_torch.training.config import KPConfig
from mvkpconv_tpu_torch.training.init import init_parameters
from mvkpconv_tpu_torch.training.steps import make_eval_step
from portbench import check, harness
from portbench.traffic.generator import make_pool
from portbench.weights import calibrate, draw
from torch_threads import two_threads  # noqa: F401,E402  (autouse: two intra-op threads)

LIMIT = 1e-5
CENTROIDS = (256, 64, 16, 4)
SMALL = dict(chunk_points=512, num_centroids=list(CENTROIDS), batch_num=2, num_views=2, image_height=24,
             image_width=32)
MIX = dict(rooms=1, points_per_room=20000, room_size_m=[3.0, 3.0, 2.5], boxes_per_room=2, frames_per_room=4,
           pool_batches=1)


def small_model():
    """The configuration ``mvpnet``'s model dict at the small size."""
    cell = harness.Cell.from_benchmark("mvpnet.infer")
    cell.conf["model"].update(SMALL)
    cell.mix.update(MIX)
    return cell.model, cell.mix


@pytest.fixture(scope="module")
def setup():
    torch.manual_seed(0)
    model, mix = small_model()
    host = make_pool(model, mix, 2**31 + 5).batches[0]
    weights = draw(model, 7, "cpu")
    calibrate(model, weights, harness.to_device(host, "cpu"))
    return model, host, weights


def port(model, weights):
    net = MVPNet3D(model["num_classes"], freeze_2d=True, seed=0, num_centroids=CENTROIDS).to("cpu")
    init_parameters(net, 0)
    net.load_state_dict(weights, strict=True)
    return net.eval()


def logits_err(model, host, weights, net):
    cfg = KPConfig(batch_num=model["batch_num"], num_views=model["num_views"])
    fed = chunk_batch({k: v for k, v in host.items() if k != "mask"}, False)
    probs = make_eval_step(net, cfg)(batch_to_device(fed, "cpu"))
    if not torch.isfinite(probs).all():  # a failed operation, as the benchmark's loop counts it
        return float("inf")
    return check.compare_infer(model, weights, [harness.to_device(host, "cpu")], [probs])["logits_err"]


def test_the_port_matches_the_reference(setup):
    model, host, weights = setup
    assert host["points"].shape == (2, 512, 3) and host["images"].shape == (2, 2, 24, 32, 3)
    assert logits_err(model, host, weights, port(model, weights)) <= LIMIT


def radius_changed(net, monkeypatch):
    monkeypatch.setattr(net.net_3d.sa0, "radius", 1.2 * net.net_3d.sa0.radius)


def mean_for_max(net, monkeypatch):
    """Each neighbour's MLP output replaced by the neighbours' mean, so the
    max over them is the mean."""
    mlp = net.net_3d.sa1.mlp
    forward = mlp.forward
    monkeypatch.setattr(mlp, "forward", lambda x: forward(x).mean(dim=2, keepdim=True).expand(
        *x.shape[:3], -1))


def unnormalised_weights(net, monkeypatch):
    def interpolate(features, index, sqdist):
        inv = 1.0 / sqdist.clamp(min=1e-10)
        return (features[torch.arange(len(features))[:, None, None], index.long()] * inv[..., None]).sum(-2)

    monkeypatch.setattr(pn2, "inverse_distance_interpolate", interpolate)


@pytest.mark.parametrize("fault", [radius_changed, mean_for_max, unnormalised_weights],
                         ids=["ball_query_radius", "max_over_neighbours", "three_nn_weights"])
def test_a_planted_fault_fails(setup, fault, monkeypatch):
    model, host, weights = setup
    net = port(model, weights)
    fault(net, monkeypatch)
    err = logits_err(model, host, weights, net)
    assert err > 100 * LIMIT, err
