"""The readings a cell's limits are set from, in one process on the card:

    python3 -m portbench.calibrate --workload <cell> --seeds 101-112 \\
        [--control 201-203] [--fault half_batch:301-303] [--seconds 2]
        [--config <name> --traffic <mix>]

For each seed, one run of the cell (``harness.run_cell``) at its own sizes
with a short window: the program as the configuration states it (the
lower readings), the configuration's ``control`` (its next precision
down: the upper readings), or a fault of the cell's loop (its ``FAULTS``)
planted under the timed path. One JSON line a run, then the largest
reading of each number over the program's runs and the least over the
control's and each fault's. ``--config`` and ``--traffic`` name a pair that
``BENCHMARK.json`` does not hold as a cell (a cell left out, or one to
come). Benchmark runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List

import torch

from portbench import harness
from portbench.traffic.generator import load_mix


def seed_list(spec: str) -> List[int]:
    out = []
    for part in spec.split(","):
        if "-" in part:
            a, b = part.split("-")
            out += list(range(int(a), int(b) + 1))
        elif part:
            out.append(int(part))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json, or a name for "
                    "--config and --traffic")
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--fault", action="append", default=[], help="name:seeds")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--config", default=None)
    ap.add_argument("--traffic", default=None)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=JSON",
                    help="a model key changed for every run (a witness at another size)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    if args.config:
        cell = harness.Cell(args.workload, harness.load_config(args.config), load_mix(args.traffic))
    else:
        cell = harness.Cell.from_benchmark(args.workload)
    for kv in args.set:
        key, value = kv.split("=", 1)
        cell.conf["model"][key] = json.loads(value)
    runs = [("program", s, None, None) for s in seed_list(args.seeds)]
    runs += [("control", s, None, cell.conf["control"]) for s in seed_list(args.control)]
    for spec in args.fault:
        name, seeds = spec.split(":")
        runs += [(name, s, cell.loop.FAULTS[name], None) for s in seed_list(seeds)]
    readings = {}
    for label, seed, fault, overrides in runs:
        t0 = time.perf_counter()
        rec = harness.run_cell(cell, seed, args.seconds, False, dev, t0, program_hook=fault, overrides=overrides)
        line = {"run": label, "seed": seed, "checks": rec["checks"], "failed": rec["failed"],
                "steps": rec["steps"], "seconds": time.perf_counter() - t0, "setup": rec["setup_parts"]}
        print(json.dumps(line), flush=True)
        for k, v in rec["checks"].items():
            readings.setdefault(label, {}).setdefault(k, []).append(v)
    summary = {label: {k: (max(v) if label == "program" else min(v)) for k, v in nums.items()}
               for label, nums in readings.items()}
    print(json.dumps({"summary": summary, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
