"""The traffic generator ``room_spheres``, with the test sampler (the cells'
mix) and the training sampler (augmentation, jittered centres): the same
seed gives equal arrays; another seed the same spheres in another order and
grouping; fill and real points are reported."""

import numpy as np
import pytest

from portbench.tests.tiny import tiny_cell
from portbench.traffic.generator import make_pool, seeds


@pytest.fixture(scope="module", params=[False, True], ids=["test", "training"])
def cell(request):
    cell = tiny_cell("early.infer")
    cell.mix["training"] = request.param
    return cell


def test_same_seed_same_arrays(cell):
    a, b = make_pool(cell.model, cell.mix, 2**31 + 11), make_pool(cell.model, cell.mix, 2**31 + 11)
    assert a.real_points == b.real_points
    for x, y in zip(a.batches, b.batches):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


def test_another_seed_cuts_the_same_spheres_in_another_order(cell):
    a, b = make_pool(cell.model, cell.mix, 3), make_pool(cell.model, cell.mix, 4)
    assert sum(a.real_points) == sum(b.real_points) and a.fill == b.fill
    sizes = lambda p: sorted(int(n) for x in p.batches for n in x["mask"].sum(1))  # noqa: E731
    assert sizes(a) == sizes(b)
    assert any(not np.array_equal(x["points"], y["points"]) for x, y in zip(a.batches, b.batches))


def test_fill_and_real_points_reported(cell):
    pool = make_pool(cell.model, cell.mix, 5)
    m = cell.model
    assert len(pool.batches) == cell.mix["pool_batches"] == len(pool.real_points)
    for x, n in zip(pool.batches, pool.real_points):
        assert x["points"].shape == (m["batch_num"], m["num_points"][0], 3)
        assert int(x["mask"].sum()) == n > 0
        # real points first, padding at 1e6 with label −1
        for row, mask, lab in zip(x["points"], x["mask"], x["labels"]):
            k = int(mask.sum())
            assert mask[:k].all() and not mask[k:].any()
            assert (row[k:] == 1e6).all() and (lab[k:] == -1).all() and (np.abs(row[:k]) < m["in_radius"] * 1.2).all()
    assert 0 < pool.fill <= 1 and pool.fill == pytest.approx(np.mean(pool.real_points) / (m["batch_num"] * m["num_points"][0]))
    fusion = m["fusion"] != "none"
    assert ("images" in pool.batches[0]) == fusion


def test_seeds_take_any_whole_number():
    assert seeds(2**33 + 1, 2) != seeds(1, 2) and seeds(-1, 1) != seeds(1, 1)
    assert all(0 <= s < 2**32 for s in seeds(2**40, 4))
