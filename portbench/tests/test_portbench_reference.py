"""The reference held to the port on the CPU at a tiny size (the port's
plain kernel versions, float32), with the benchmark's own weights and
batches: early and middle fusion in inference through the cells' loop, and
the reference's radius search, pixel association and kernel points against
the port's plain versions."""

import numpy as np
import pytest
import torch

from portbench import check, harness
from portbench.reference import geometry
from portbench.reference.dispositions import optimize, unit_dispositions
from portbench.tests.tiny import tiny_cell
from portbench.traffic.generator import make_pool
from portbench.weights import calibrate, draw


def setup(name, **model):
    cell = tiny_cell(name)
    cell.conf["model"].update(model)
    pool = make_pool(cell.model, cell.mix, 7)
    weights = draw(cell.model, 3, "cpu")
    calibrate(cell.model, weights, harness.to_device(pool.batches[0], "cpu"))
    return cell, pool, weights


@pytest.mark.parametrize("name", ["early.infer", "middle.infer"])
def test_inference_matches_the_port(name):
    cell, pool, weights = setup(name)
    prog = cell.loop.build(cell.model, cell.conf, weights, "cpu")
    batches = [harness.to_device(b, "cpu") for b in pool.batches[:2]]
    outputs = [prog.call(b)[0] for b in pool.batches[:2]]
    assert check.compare_infer(cell.model, weights, batches, outputs)["logits_err"] < 1e-5


def test_radius_search_equals_the_ports_plain_selection():
    from mvkpconv_tpu_torch.ops.kernels.radius_topk import radius_topk_plain

    rng = np.random.RandomState(0)
    pts = torch.from_numpy(rng.rand(300, 3).astype(np.float32))
    got = geometry.radius_search(pts, pts, 0.15, 16, pairs=5000)
    want = radius_topk_plain(pts[None], pts[None], 0.15, 16)[0].long()
    assert torch.equal(got, want)


def test_pixel_neighbors_equal_the_ports_plain_selection():
    from mvkpconv_tpu_torch.ops.unproject import points_to_pixel_knn_projective, unproject_depth

    cell, pool, _ = setup("early.infer")
    b = harness.to_device(pool.batches[0], "cpu")
    n = int(b["mask"][0].sum())
    xyz = geometry.unproject(b["depth"], b["intrinsics"], b["poses"])
    port_xyz, _ = unproject_depth(b["depth"], b["intrinsics"], b["poses"])
    assert torch.equal(xyz, port_xyz)
    got = geometry.pixel_neighbors(b["points"][0, :n], xyz[0], b["intrinsics"][0], b["poses"][0], 3, 7)
    want = points_to_pixel_knn_projective(b["points"][:1, :n], port_xyz[:1], b["intrinsics"][:1], b["poses"][:1],
                                          3, window=7)[0]
    assert torch.equal(got, want.long())


def test_kernel_point_table_is_the_frozen_optimisation():
    np.testing.assert_array_equal(unit_dispositions(15), optimize(15))
