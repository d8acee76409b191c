"""ScanNet IO of the port: ``load_split`` of ``mvkpconv_tpu/data/scannet_io.py``.

A preprocessed split is a pickle of scene dicts (the schema in
``data/spheres.py``) that the JAX package's preprocessing writes. The rest
of that module (``.sens`` decoding, PLY loading, the label mapping) is not
ported yet (ROADMAP queue 1, item 8).
"""

from __future__ import annotations

import pickle
from typing import Dict, List

import numpy as np


def load_split(pkl_path) -> List[Dict[str, np.ndarray]]:
    with open(pkl_path, "rb") as f:
        return pickle.load(f)
