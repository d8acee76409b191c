"""Binary/ascii PLY point cloud IO: a copy of ``mvkpconv_tpu/utils/ply.py``
(``tests/test_torch_io.py`` pins it to the original).

Replaces KPConv-PyTorch/utils/ply.py:116-354 (read_ply/write_ply used for
cached subsampled clouds, prediction dumps and kernel dispositions). Reads
binary_little_endian and ascii PLYs with vertex elements; writes binary
little-endian. Returns a dict of named numpy 1-D arrays like the reference.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}
_INV_DTYPES = {"i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort",
               "i4": "int", "u4": "uint", "f4": "float", "f8": "double"}


def read_ply(path) -> Dict[str, np.ndarray]:
    """Read a PLY file's vertex element into {property_name: array}."""
    data = Path(path).read_bytes()
    end = data.find(b"end_header\n")
    if end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    header = data[:end].decode("ascii", errors="replace").splitlines()
    body = data[end + len(b"end_header\n"):]

    fmt = None
    elements: List[Tuple[str, int, List[Tuple[str, str]]]] = []
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property" and elements:
            if parts[1] == "list":
                raise ValueError("list properties are not supported")
            elements[-1][2].append((parts[-1], _PLY_DTYPES[parts[1]]))

    out: Dict[str, np.ndarray] = {}
    if fmt == "ascii":
        rows = body.decode("ascii").split()
        cursor = 0
        for name, count, props in elements:
            width = len(props)
            block = np.asarray(rows[cursor : cursor + count * width])
            cursor += count * width
            block = block.reshape(count, width)
            if name == "vertex":
                for j, (pname, dt) in enumerate(props):
                    out[pname] = block[:, j].astype(np.dtype(dt))
        return out

    endian = "<" if "little" in (fmt or "") else ">"
    offset = 0
    for name, count, props in elements:
        dtype = np.dtype([(p, endian + dt) for p, dt in props])
        block = np.frombuffer(body, dtype=dtype, count=count, offset=offset)
        offset += dtype.itemsize * count
        if name == "vertex":
            for pname, _ in props:
                out[pname] = np.ascontiguousarray(block[pname])
    return out


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
