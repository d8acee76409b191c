"""What every traffic mix shares: a mix is a JSON file of parameters beside
this module (``<mix>.json``), read by :func:`load_mix`. Its ``generator``
names the module beside it that makes the pool of host batches
(``<generator>.py``, a ``make_pool(model, mix, seed) -> Pool``) and its
``loop`` the module under ``portbench/loops/`` that drives the window
(``harness.py``). A new mix of an existing generator is a new JSON file; a
new kind of traffic is a new generator module.
"""

from __future__ import annotations

import json
from importlib import util
from pathlib import Path
from typing import Dict, List, NamedTuple

import numpy as np

HERE = Path(__file__).resolve().parent


def load_module(path: Path, name: str):
    """A module of the benchmark found by its file's name (metric names hold
    dots, so these are loaded by path, not imported by name)."""
    spec = util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no module {name!r} ({path})")
    mod = util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_mix(name: str) -> Dict:
    path = HERE / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} ({path})")
    return json.loads(path.read_text())


def seeds(seed: int, n: int) -> List[int]:
    """``n`` 32-bit seeds drawn from any whole ``seed`` (negative or past
    2**32 too)."""
    entropy = [abs(int(seed)) & 0xFFFFFFFF, abs(int(seed)) >> 32, int(seed < 0)]
    return [int(s) for s in np.random.SeedSequence(entropy).generate_state(n)]


class Pool(NamedTuple):
    batches: List[Dict[str, np.ndarray]]
    real_points: List[int]  # unmasked level-0 points of each batch

    @property
    def fill(self) -> float:
        """Mean share of the level-0 slots that hold a real point."""
        b = self.batches[0]["mask"]
        return float(np.mean(self.real_points) / b.size)


def make_pool(model: Dict, mix: Dict, seed: int) -> Pool:
    """The pool of host batches of a mix, by its generator."""
    gen = load_module(HERE / f"{mix['generator']}.py", f"portbench.traffic.{mix['generator']}")
    return gen.make_pool(model, mix, seed)
