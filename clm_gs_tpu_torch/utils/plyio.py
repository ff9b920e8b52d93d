"""Minimal PLY vertex reader, binary little-endian and ascii
and a point-cloud writer (clm_gs_tpu/utils/plyio.py; the port's own copy).
Gaussian model PLYs use the schema code in models/gaussians.py."""

from __future__ import annotations

import numpy as np

_TYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "ushort": "<u2", "int": "<i4", "uint": "<u4",
    "int32": "<i4", "uint32": "<u4",
}
CHUNK_ROWS = 1 << 20


def read_ply_vertices(path):
    """Returns {property_name: (N,) array} for the `vertex` element. A binary
    file is read CHUNK_ROWS rows at a time into the output arrays, so the
    host holds them and one chunk."""
    with open(path, "rb") as f:
        lines = []
        while not lines or lines[-1] != b"end_header\n":
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: no end_header")
            lines.append(line)
        header = b"".join(lines).decode("ascii", errors="replace").splitlines()
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
            out = {name: np.empty(n, dt) for name, dt in props}
            buf = np.empty(min(CHUNK_ROWS, max(n, 1)), dtype=dtype)
            for i in range(0, n, CHUNK_ROWS):
                rows = buf[: min(CHUNK_ROWS, n - i)]
                if f.readinto(memoryview(rows).cast("B")) != rows.nbytes:
                    raise ValueError(f"{path}: fewer than the {n} rows its header states")
                for name, _ in props:
                    out[name][i:i + len(rows)] = rows[name]
            return out
        if fmt == "ascii":
            rows = f.read().decode("ascii").split("\n")[:n]
            arr = np.array(
                [tuple(float(v) for v in r.split()) for r in rows], dtype=dtype
            )
            return {name: np.ascontiguousarray(arr[name]) for name, _ in props}
    raise ValueError(f"unsupported PLY format {fmt}")


def write_ply_points(path, points, colors=None):
    """Write an xyz (+ rgb in [0, 1], stored as uchar) point cloud."""
    n = len(points)
    props = ["property float x", "property float y", "property float z"]
    dtype = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if colors is not None:
        props += ["property uchar red", "property uchar green", "property uchar blue"]
        dtype += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {n}\n" + "\n".join(props) + "\nend_header\n")
    arr = np.empty(n, dtype=dtype)
    arr["x"], arr["y"], arr["z"] = points[:, 0], points[:, 1], points[:, 2]
    if colors is not None:
        rgb = np.clip(colors * 255.0, 0, 255).astype(np.uint8)
        arr["red"], arr["green"], arr["blue"] = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(arr.tobytes())
