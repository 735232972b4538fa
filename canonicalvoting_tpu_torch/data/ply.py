"""Minimal PLY reader (binary little-endian and ascii) for ScanNet
``*_vh_clean_2.ply`` meshes, in place of upstream's ``plyfile``
(utils/dataloader.py:130-135). Only the vertex element is parsed; the
elements before it are skipped, list properties row by row.

The port's copy of ``canonicalvoting_tpu/data/ply.py``.
"""

from __future__ import annotations

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply_vertices(path: str) -> dict:
    """Return {property_name: np.ndarray} for the vertex element."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # [(name, count, [(prop_name, dtype) or ('list', ...)])]
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in PLY header")
            tokens = line.decode("ascii", "replace").strip().split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                elements.append((tokens[1], int(tokens[2]), []))
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    elements[-1][2].append(("__list__", tokens[2], tokens[3], tokens[4]))
                else:
                    elements[-1][2].append((tokens[2], _PLY_DTYPES[tokens[1]]))
            elif tokens[0] == "end_header":
                break

        if fmt not in ("binary_little_endian", "ascii"):
            raise ValueError(f"unsupported PLY format {fmt}")

        result = {}
        for name, count, props in elements:
            if name == "vertex":
                if any(p[0] == "__list__" for p in props):
                    raise ValueError("list properties in vertex element unsupported")
                dtype = np.dtype([(p[0], "<" + p[1]) for p in props])
                if fmt == "ascii":
                    rows = []
                    for _ in range(count):
                        rows.append(tuple(f.readline().split()))
                    arr = np.array(rows, dtype=dtype)
                else:
                    arr = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype)
                for p, _ in [(p[0], p[1]) for p in props]:
                    result[p] = np.asarray(arr[p])
                return result
            else:
                # Skip this element's data.
                if fmt == "ascii":
                    for _ in range(count):
                        f.readline()
                else:
                    if any(p[0] == "__list__" for p in props):
                        # Variable length: must walk row by row.
                        for _ in range(count):
                            for p in props:
                                if p[0] == "__list__":
                                    cdt = np.dtype("<" + _PLY_DTYPES[p[1]])
                                    n = int(np.frombuffer(f.read(cdt.itemsize), cdt)[0])
                                    idt = np.dtype("<" + _PLY_DTYPES[p[2]])
                                    f.read(n * idt.itemsize)
                                else:
                                    f.read(np.dtype("<" + p[1]).itemsize)
                    else:
                        row = sum(np.dtype("<" + p[1]).itemsize for p in props)
                        f.read(count * row)
        raise ValueError("no vertex element found")
