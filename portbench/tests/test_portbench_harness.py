"""The harness driven on the CPU at a tiny size, with its look for a card
skipped: every cell's run comes out correct, traced and untraced, with its
metrics; each fault a cell can have, planted under the timed path, and the
configuration's lower-precision control come out not correct; and the
command refuses to run without a card."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench import harness
from portbench.tests.tiny import tiny_cell

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


def run(name, traced=False, hook=None, overrides=None, device="cpu"):
    cell = tiny_cell(name)
    rec = harness.run_cell(cell, 2**31 + 3, 0.5, traced, device, time.perf_counter(), program_hook=hook,
                           overrides=overrides)
    return cell, rec, harness.result(cell, rec, traced)


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("name", CELLS)
def test_a_cell_runs_correct_with_its_metrics(name, traced):
    cell, rec, out = run(name, traced)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] == rec["steps"] > 0
    assert list(out)[-1] == "checks" and set(out["checks"]) == set(cell.limits)
    want = {m["name"] for m in (cell.per_layer if traced else cell.end_to_end)}
    # on the CPU there is no device memory, no profiled device time and no
    # CUDA event of the program's own spans
    cpu_only = {"peak_mem_gib", "device_idle.infer", "unet_ms.infer"}
    assert want - cpu_only <= set(out["metrics"]) <= want
    assert all(v["value"] > 0 for v in out["metrics"].values())


@pytest.mark.parametrize("name,fault", [(n, f) for n in CELLS for f in tiny_cell(n).loop.FAULTS])
def test_a_planted_fault_comes_out_not_correct(name, fault):
    """Each fault of the cell's loop (for ``closed_infer``: half of the
    batch's answers left out, an answer altered where it is produced)."""
    _, _, out = run(name, hook=tiny_cell(name).loop.FAULTS[fault])
    assert not out["correct"], out["checks"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_comes_out_not_correct(name, card):
    """The configuration's control (TF32 on, where the configuration states
    float32 with TF32 off) exists only on the card."""
    cell = tiny_cell(name)
    _, _, out = run(name, overrides=cell.conf["control"], device=card)
    assert not out["correct"], out["checks"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_a_cell_runs_correct_on_the_card(name, card):
    _, _, out = run(name, device=card)
    assert out["correct"], out["checks"]


def test_the_command_needs_a_card():
    if harness.torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0], "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True)
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.card
def test_a_short_run_on_the_card(card):
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0], "--seed", "5",
                           "--seconds", "3", "--trace", "1"], cwd=ROOT, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["busy_s"] > 0
    # every per-layer metric, the one read from the program's own spans too
    assert set(out["metrics"]) == {m["name"] for m in harness.Cell.from_benchmark(CELLS[0]).per_layer}
    assert out["metrics"]["unet_ms.infer"]["value"] > 0
