"""The cell ``mvpnet.infer`` on the CPU: its traffic (``room_chunks``), a
whole run through ``harness.run_cell`` at small sizes, its faults, its
reference's imports and its entries in ``BENCHMARK.json``."""

import ast
import json
import time
from pathlib import Path

import numpy as np
import pytest

from portbench import harness
from portbench.tests import test_portbench_spec as spec
from portbench.traffic.generator import make_pool

ROOT = Path(__file__).resolve().parents[2]
CELL = "mvpnet.infer"
SMALL = dict(chunk_points=1024, batch_num=2, num_views=2, image_height=24, image_width=32)
MIX = dict(rooms=2, points_per_room=20000, room_size_m=[3.0, 3.0, 2.5], boxes_per_room=2, frames_per_room=4,
           pool_batches=3)


def small_cell():
    cell = harness.Cell.from_benchmark(CELL)
    cell.conf["model"].update(SMALL)
    cell.mix.update(MIX)
    return cell


def run(traced=False, hook=None):
    cell = small_cell()
    rec = harness.run_cell(cell, 2**33 + 17, 0.5, traced, "cpu", time.perf_counter(), program_hook=hook)
    return rec, harness.result(cell, rec, traced)


def test_the_pool_is_the_seeds_and_holds_whole_chunks():
    cell = small_cell()
    a, b = (make_pool(cell.model, cell.mix, 2**33 + 5) for _ in range(2))
    c = make_pool(cell.model, cell.mix, 2**33 + 6)
    assert all(np.array_equal(x[k], y[k]) for x, y in zip(a.batches, b.batches) for k in x)
    assert not all(np.array_equal(x["points"], y["points"]) for x, y in zip(a.batches, c.batches))
    full = harness.Cell.from_benchmark(CELL)
    assert full.model["chunk_points"] == 8192 and full.model["num_views"] == 5 and full.model["batch_num"] == 5
    for batch in a.batches:
        assert batch["points"].shape == (2, 1024, 3) and batch["images"].shape == (2, 2, 24, 32, 3)
        assert batch["depth"].shape == (2, 2, 24, 32) and batch["poses"].shape == (2, 2, 4, 4)
        assert batch["mask"].all()
    assert a.real_points == [2 * 1024] * 3 and a.fill == 1.0


def test_a_run_is_correct_with_its_metrics():
    rec, out = run()
    assert out["correct"] and out["failed"] == 0 and out["attempted"] == rec["steps"] > 0
    assert out["checks"]["logits_err"]["value"] <= 1e-5  # the CPU computes as the reference does
    assert set(out["metrics"]) == {"infer_points_per_s", "infer_batch_ms.p95", "setup_s"}


def test_a_traced_run_records_pointnets_spans():
    """On the CPU the spans have no device time, so the three metrics read
    nothing; the program's pass records them and the ball query's rows."""
    rec, out = run(traced=True)
    assert out["correct"] and out["metrics"] == {}
    prog = rec["program"]
    for name in ("pn2", "pn2.fps", "pn2.ball_query", "pn2.three_nn", "lift.unet"):
        assert len(prog["host_ms"][name]) == 3, name
    rows = prog["counters"]["pn2.ball_query"]
    full = 2 * sum(harness.Cell.from_benchmark(CELL).model["num_centroids"]) * 32
    assert rows["rows"] == [full] * 3 and all(0 < r < full for r in rows["real_rows"])


@pytest.mark.parametrize("fault", ["half_batch", "altered"])
def test_a_planted_fault_comes_out_not_correct(fault):
    _, out = run(hook=small_cell().loop.FAULTS[fault])
    assert not out["correct"], out["checks"]


def test_the_reference_imports_nothing_forbidden():
    for path in (ROOT / "portbench" / "reference_mvpnet").glob("*.py"):
        names = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names.add(node.module.split(".")[0])
        assert not names & {*harness.FORBIDDEN, "mvkpconv_tpu_torch"}, path


def test_the_new_entries_parse_by_the_spec_rules():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = next(c for c in bench["configs"] if c["name"] == "mvpnet")
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert config["reduced"] == [] and cell["chips"] == 1 and cell["traffic"] == "room_chunks.infer"
    e2e = {m["name"] for m in bench["end_to_end"] if CELL in m.get("workloads", [CELL])}
    assert e2e == {"infer_points_per_s", "infer_batch_ms.p95", "peak_mem_gib", "setup_s"}
    layer = {m["name"] for m in bench["per_layer"] if CELL in m.get("workloads", [CELL])}
    assert layer == {"pn2_ms.mvpnet", "pn2_index_ms.mvpnet", "fps_roofline.mvpnet"}
    spec.test_top_level_keys_and_sizes()
    spec.test_names_units_and_texts()
    spec.test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric()
    spec.test_configs_are_used_and_keep_their_files_under_paths()
    spec.test_cell_resolves_by_name(CELL)


def test_the_roofline_reads_the_configurations_count():
    from portbench.reference_mvpnet import fps_seconds

    reader = harness.load_metric("fps_roofline.mvpnet")
    model = harness.load_config("mvpnet")["model"]
    ops = 5 * 9 * (8192 * 2048 + 2048 * 512 + 512 * 128 + 128 * 32)
    assert fps_seconds(model) == pytest.approx(ops / 67e12)
    run = {"kind": "infer", "program": {"span_ms": {"pn2.fps": [2.0, 2.0]}}}
    assert reader.read(run) == pytest.approx(100 * ops / 67e12 * 1e3 / 2.0)
    assert reader.read({"kind": "infer", "program": {"span_ms": {}}}) is None
