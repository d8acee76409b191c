"""BENCHMARK.json against the contract's form, and every cell resolving its
configuration, mix, limits and metrics by name."""

import json
import re
from pathlib import Path

import pytest

from portbench import harness
from portbench.traffic.generator import load_module

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and 1 <= len(BENCH["command"]) <= 32
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    assert all(TEXT.match(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # a full check of 24 cells fits its time
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_texts():
    names = [c["name"] for c in BENCH["configs"]] + CELLS
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in BENCH[group]}) == len(BENCH[group])
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and TEXT.match(w["why"])
        assert w["chips"] in (1, 4)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(CELLS) if "workloads" in m else True
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"]) and m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for cell in CELLS:
        e2e = [m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = [m for m in BENCH["per_layer"] if cell in m.get("workloads", [cell])]
        assert layer and all(m["moves"] in e2e for m in layer)


def test_configs_are_used_and_keep_their_files_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert {"source", "model", "assumed", "precision", "control"} <= set(conf)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    c = harness.Cell.from_benchmark(cell)
    loop = c.loop
    for name in ("build", "warm", "drive", "check_run"):
        assert callable(getattr(loop, name)), name
    assert isinstance(loop.KIND, str) and isinstance(loop.TRAINS, bool) and loop.FAULTS
    gen = load_module(ROOT / "portbench" / "traffic" / f"{c.mix['generator']}.py", "generator")
    assert callable(gen.make_pool)
    assert c.limits and all(v > 0 for v in c.limits.values())
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.load_metric(m["name"]).read)
    limits = json.loads((ROOT / "portbench" / "limits" / f"{cell}.json").read_text())
    for number, entry in limits.items():
        assert entry["lower"] < entry["limit"] < entry["upper"], number
