"""Minimal PLY vertex reader, binary little-endian and ascii
(clm_gs_tpu/utils/plyio.py; the port's own copy of its reader). Gaussian
model PLYs use the schema code in models/gaussians.py."""

from __future__ import annotations

import numpy as np

_TYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "ushort": "<u2", "int": "<i4", "uint": "<u4",
    "int32": "<i4", "uint32": "<u4",
}


def read_ply_vertices(path):
    """Returns {property_name: (N,) array} for the `vertex` element."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii", errors="replace").splitlines()
    fmt = None
    n = None
    props = []
    in_vertex = False
    for line in header:
        t = line.split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            in_vertex = t[1] == "vertex"
            if in_vertex:
                n = int(t[2])
        elif t[0] == "property" and in_vertex:
            if t[1] == "list":
                raise ValueError(f"{path}: list properties in the vertex element")
            props.append((t[2], _TYPES[t[1]]))
    if fmt is None or n is None:
        raise ValueError(f"{path}: no format or vertex element in the header")
    dtype = np.dtype(props)
    if fmt == "binary_little_endian":
        arr = np.frombuffer(data[end : end + n * dtype.itemsize], dtype=dtype)
    elif fmt == "ascii":
        rows = data[end:].decode("ascii").split("\n")[:n]
        arr = np.array(
            [tuple(float(v) for v in r.split()) for r in rows], dtype=dtype
        )
    else:
        raise ValueError(f"unsupported PLY format {fmt}")
    return {name: np.ascontiguousarray(arr[name]) for name, _ in props}

