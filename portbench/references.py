"""A configuration's reference, found by the name its file gives under the
key ``reference`` (a module under ``portbench.``; the contract it keeps is in
``harness.py``'s docstring). The model dict that the harness hands to
everything (``harness.Cell.model``) carries that name, so that the weights,
the calibration, the check and the counts all reach the same module."""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Dict

PREFIX = "portbench."
FUNCTIONS = ("tensors", "calibrate", "logits", "peak_seconds")


def load(name) -> ModuleType:
    """The reference module ``name``; refuses one outside ``portbench.`` and
    one that lacks a function of the contract."""
    if not isinstance(name, str) or not name.startswith(PREFIX):
        raise ValueError(f"the configuration's key 'reference' must name a module under {PREFIX!r}; "
                         f"it gives {name!r}")
    mod = importlib.import_module(name)
    missing = [f for f in FUNCTIONS if not callable(getattr(mod, f, None))]
    if missing:
        raise AttributeError(f"the configuration's key 'reference' names {name!r}, which lacks {missing}")
    return mod


def of(model: Dict) -> ModuleType:
    """The reference module that a model dict names."""
    return load(model.get("reference"))
