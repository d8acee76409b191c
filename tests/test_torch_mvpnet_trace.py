"""PyTorch port: the tracer's spans and counters on MVPNet's path
(``models/mvpnet3d.py``, ``models/pn2.py``), on the CPU at a small size.

  * on, one ``batch_to_device`` → ``make_eval_step`` call records ``model``
    > ``lift`` (its five parts, named as MV-KPConv's) and ``pn2`` > four
    ``pn2.sa`` and four ``pn2.fp`` with their level, then ``head``; a set
    abstraction's ``pn2.fps``, ``pn2.group``, ``pn2.ball_query``,
    ``pn2.group``, ``pn2.sa.mlp``; a propagation's ``pn2.three_nn`` and
    ``pn2.fp.mlp``;
  * ``pn2.ball_query``'s ``rows`` and ``real_rows`` equal a numpy count on
    the same points: centroids × 32 slots, and the slots a support inside
    the radius fills (at most 32 a centroid);
  * P1's launches (counted on the card; a stand-in counts here) land in
    ``pn2.fps``, one a level;
  * off, nothing is recorded and the probabilities are bit-equal.
"""

import numpy as np
import pytest
import torch

from mvkpconv_tpu_torch import tracing
from mvkpconv_tpu_torch.infer import batch_to_device
from mvkpconv_tpu_torch.models.mvpnet3d import MVPNet3D
from mvkpconv_tpu_torch.models.pn2 import MAX_NEIGHBORS, RADII
from mvkpconv_tpu_torch.ops import _build, sampling
from mvkpconv_tpu_torch.training.config import KPConfig
from mvkpconv_tpu_torch.training.init import init_parameters
from mvkpconv_tpu_torch.training.steps import make_eval_step
from torch_threads import two_threads  # noqa: F401,E402  (autouse: two intra-op threads)

CENTROIDS = (128, 32, 8, 4)
B, N, V, H, W = 2, 256, 2, 24, 32


def chunk_batch(seed=0):
    """Two chunks of a 1.5 m square (points in a room's coordinates, so the
    balls see real hits and empty slots), with views looking down on it."""
    rng = np.random.RandomState(seed)
    pts = np.concatenate([rng.rand(B, N, 2) * 1.5 + 2.0, rng.rand(B, N, 1) * 0.3], -1).astype(np.float32)
    k = np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (B, V, 1, 1))
    poses[..., :3, :3] = np.diag([1.0, -1.0, -1.0])  # looking down −z
    poses[..., 0, 3], poses[..., 1, 3], poses[..., 2, 3] = 2.75, 2.75, 3.0
    return {"points": pts, "images": rng.rand(B, V, H, W, 3).astype(np.float32),
            "depth": np.full((B, V, H, W), 3.0, np.float32) - rng.rand(B, V, H, W).astype(np.float32) * 0.1,
            "intrinsics": np.tile(k, (B, V, 1, 1)), "poses": poses}


@pytest.fixture(scope="module")
def setup():
    cfg = KPConfig(batch_num=B, num_views=V, image_height=H, image_width=W)
    net = MVPNet3D(20, freeze_2d=True, seed=0, num_centroids=CENTROIDS)
    init_parameters(net, 0)
    return cfg, net.eval(), chunk_batch()


@pytest.fixture(autouse=True)
def tracer_off():
    tracing.disable()
    tracing.export()
    yield
    tracing.disable()
    tracing.export()


def traced_call(cfg, net, raw):
    step = make_eval_step(net, cfg)
    tracing.enable()
    out = step(batch_to_device(raw, "cpu"))
    tracing.disable()
    return out, tracing.export()


def children(records, i):
    return [r["name"] for r in records if r["parent"] == i]


def test_span_tree_and_levels(setup):
    cfg, net, raw = setup
    _, records = traced_call(cfg, net, raw)
    roots = [i for i, r in enumerate(records) if r["parent"] is None]
    assert [records[i]["name"] for i in roots] == ["handoff", "step"]
    at = {}
    for i, r in enumerate(records):
        at.setdefault(r["name"], []).append(i)
        if r["parent"] is not None:
            p = records[r["parent"]]
            assert p["t0_ns"] <= r["t0_ns"] <= r["t1_ns"] <= p["t1_ns"], (p["name"], r["name"])
    assert children(records, roots[1]) == ["model", "softmax"]
    assert children(records, at["model"][0]) == ["lift", "pn2"]
    assert children(records, at["lift"][0]) == ["lift.unproject", "lift.pixel_select", "lift.unet", "lift.gather",
                                                "lift.aggregate"]
    assert children(records, at["pn2"][0]) == ["pn2.sa"] * 4 + ["pn2.fp"] * 4 + ["head"]
    assert [records[i]["level"] for i in at["pn2.sa"]] == [0, 1, 2, 3]
    assert [records[i]["level"] for i in at["pn2.fp"]] == [0, 1, 2, 3]
    for i in at["pn2.sa"]:
        assert children(records, i) == ["pn2.fps", "pn2.group", "pn2.ball_query", "pn2.group", "pn2.sa.mlp"]
    for i in at["pn2.fp"]:
        assert children(records, i) == ["pn2.three_nn", "pn2.fp.mlp"]
    assert all(r["device_ms"] is None for r in records)  # no CUDA device here


def numpy_fps(xyz, m):
    """The iterative FPS: (N, 3) → m indices, difference-form d², ties to
    the lower index."""
    least = np.full(len(xyz), np.inf, np.float32)
    out = [0]
    for _ in range(1, m):
        d = xyz - xyz[out[-1]]
        least = np.minimum(least, (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2])
        out.append(int(np.argmax(least)))
    return np.asarray(out)


def test_ball_query_rows_equal_a_numpy_count(setup):
    cfg, net, raw = setup
    _, records = traced_call(cfg, net, raw)
    want = []
    levels = [list(raw["points"])]
    for lv, m in enumerate(CENTROIDS):
        r2 = np.float32(RADII[lv]) * np.float32(RADII[lv])
        real, nxt = 0, []
        for xyz in levels[-1]:
            cent = xyz[numpy_fps(xyz, m)]
            d = cent[:, None, :] - xyz[None, :, :]
            hits = ((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2] < r2).sum(1)
            real += int(np.minimum(hits, MAX_NEIGHBORS).sum())
            nxt.append(cent)
        levels.append(nxt)
        want.append((B * m * MAX_NEIGHBORS, real))
    got = [(r["rows"], r["real_rows"]) for r in records if r["name"] == "pn2.ball_query"]
    assert got == want
    assert all(0 < real < rows for rows, real in want)  # real hits and empty slots both


def test_p1_launches_land_in_pn2_fps(setup, monkeypatch):
    """P1's wrapper counts launches only on the card: here a stand-in counts
    each call as the card's wrapper does."""
    cfg, net, raw = setup
    fps = sampling.farthest_point_sample

    def counted(*args):
        _build.LAUNCHES["farthest_point_sample"] += 1
        return fps(*args)

    from mvkpconv_tpu_torch.models import pn2

    monkeypatch.setattr(pn2, "farthest_point_sample", counted)
    monkeypatch.setitem(_build.LAUNCHES, "farthest_point_sample", _build.LAUNCHES["farthest_point_sample"])
    _, records = traced_call(cfg, net, raw)
    assert [r["launches"] for r in records if r["name"] == "pn2.fps"] == [{"farthest_point_sample": 1}] * 4
    for name in ("pn2.sa", "pn2", "model", "step"):
        assert sum(r["launches"].get("farthest_point_sample", 0) for r in records if r["name"] == name) == 4
    assert all(not r["launches"] for r in records if r["name"].startswith("pn2.") and r["name"] not in (
        "pn2.fps", "pn2.sa"))


def test_off_records_nothing_and_on_changes_no_bit(setup):
    cfg, net, raw = setup
    off = make_eval_step(net, cfg)(batch_to_device(raw, "cpu"))
    assert tracing.export() == []
    on, records = traced_call(cfg, net, raw)
    assert records and torch.equal(off, on)
