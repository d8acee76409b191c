"""What runs on the card imports neither ``jax`` nor the JAX package, and the
reference imports nothing of the program either; module names compared
whole by their top-level part (``mvkpconv_tpu_torch`` begins with
``mvkpconv_tpu``)."""

import ast
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "portbench"
JAX = {"jax", "jaxlib", "flax", "mvkpconv_tpu"}
CHIP = sorted(p for p in PKG.rglob("*.py") if "tests" not in p.parts)
REFERENCE = sorted((PKG / "reference").glob("*.py"))
CONFIGS = [json.loads((ROOT / c["file"]).read_text())
           for c in json.loads((ROOT / "BENCHMARK.json").read_text())["configs"]]


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", CHIP, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_in_what_runs_on_the_card(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & (JAX | {"mvkpconv_tpu_torch"})


def test_whole_names_are_compared():
    from portbench.harness import FORBIDDEN

    assert "mvkpconv_tpu_torch" not in FORBIDDEN and "mvkpconv_tpu" in FORBIDDEN


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    loaded = _loaded("import portbench.run, portbench.harness, portbench.calibrate, portbench.loops.closed_infer\n"
                     "import mvkpconv_tpu_torch.train, mvkpconv_tpu_torch.infer")
    assert not loaded & JAX


def test_the_reference_loads_no_program():
    loaded = _loaded("import portbench.reference.model, portbench.weights, portbench.traffic.generator, "
                     "portbench.traffic.room_spheres, portbench.counting, portbench.check")
    assert not loaded & (JAX | {"mvkpconv_tpu_torch"})


@pytest.mark.parametrize("name", sorted({c["reference"] for c in CONFIGS}))
def test_a_configurations_reference_loads_no_program(name):
    """Every module a configuration names as its ``reference``: its own files
    (a package's, all of them) and what importing it loads."""
    from portbench.harness import FORBIDDEN

    program = set(FORBIDDEN) | {"mvkpconv_tpu_torch"}
    spec = importlib.util.find_spec(name)
    files = sorted(Path(spec.origin).parent.glob("*.py")) if spec.submodule_search_locations else [Path(spec.origin)]
    assert files and not any(top_level_imports(f) & program for f in files)
    assert not _loaded(f"import {name}") & program
