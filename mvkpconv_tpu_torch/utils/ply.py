"""Binary PLY output: ``write_ply`` of ``mvkpconv_tpu/utils/ply.py`` (the
same bytes for the same fields; ``read_ply`` is not ported)."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

_INV_DTYPES = {"i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort",
               "i4": "int", "u4": "uint", "f4": "float", "f8": "double"}


def write_ply(
    path,
    fields: Sequence[np.ndarray],
    field_names: Sequence[str],
) -> None:
    """Write named per-vertex fields as binary little-endian PLY.

    ``fields`` may mix 1-D arrays and 2-D arrays (whose columns consume the
    next field_names), matching the reference's calling convention
    (write_ply(path, [points, colors], ['x','y','z','red','green','blue']))."""
    cols: List[np.ndarray] = []
    for f in fields:
        f = np.asarray(f)
        if f.ndim == 1:
            cols.append(f)
        elif f.ndim == 2:
            cols.extend(f[:, i] for i in range(f.shape[1]))
        else:
            raise ValueError("fields must be 1-D or 2-D arrays")
    if len(cols) != len(field_names):
        raise ValueError(f"{len(cols)} columns but {len(field_names)} names")
    n = len(cols[0])
    dtype = np.dtype(
        [(name, "<" + col.dtype.str[1:]) for name, col in zip(field_names, cols)]
    )
    rec = np.empty(n, dtype=dtype)
    for name, col in zip(field_names, cols):
        rec[name] = col
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    for name, col in zip(field_names, cols):
        header.append(f"property {_INV_DTYPES[col.dtype.str[1:]]} {name}")
    header.append("end_header\n")
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(rec.tobytes())
