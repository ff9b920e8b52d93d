"""COLMAP sparse-reconstruction parsers and writers, binary and text
(clm_gs_tpu/data/colmap.py; the port's own copy).

Reads `cameras.bin/txt`, `images.bin/txt` and `points3D.bin/txt` into numpy
structures in COLMAP's documented layout. points3D.bin is parsed from one
buffer and written in one block, so clouds of millions of points load in
seconds.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict

import numpy as np

# model_id -> (name, num_params)  (colmap_loader.py:21-45)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str


def qvec2rotmat(qvec):
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
            [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
            [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def rotmat2qvec(R):
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    Kmat = (
        np.array(
            [
                [Rxx - Ryy - Rzz, 0, 0, 0],
                [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
            ]
        )
        / 3.0
    )
    eigvals, eigvecs = np.linalg.eigh(Kmat)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cid, model_id, w, h = _read(f, "<iiQQ")
            name, nparams = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{nparams}d"))
            cams[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return cams


def read_images_binary(path) -> Dict[int, ColmapImage]:
    imgs = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            iid = _read(f, "<i")[0]
            q = np.array(_read(f, "<4d"))
            t = np.array(_read(f, "<3d"))
            cid = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (npts,) = _read(f, "<Q")
            f.seek(24 * npts, os.SEEK_CUR)  # skip 2D points (x, y f64 + id i64)
            imgs[iid] = ColmapImage(iid, q, t, cid, name.decode("utf-8"))
    return imgs


def read_points3d_binary(path):
    """Returns (xyz (N,3) f64, rgb (N,3) u8, errors (N,))."""
    with open(path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack_from("<Q", data, 0)
    rec = struct.Struct("<Q3d3BdQ")  # id, xyz, rgb, error, track length
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty(n, np.float64)
    off = 8
    for i in range(n):
        r = rec.unpack_from(data, off)
        xyz[i] = r[1:4]
        rgb[i] = r[4:7]
        err[i] = r[7]
        off += rec.size + 8 * r[8]  # skip the track (image id, point2D idx)
    return xyz, rgb, err


def read_cameras_text(path) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cid = int(parts[0])
            cams[cid] = ColmapCamera(
                cid, parts[1], int(parts[2]), int(parts[3]),
                np.array([float(p) for p in parts[4:]]),
            )
    return cams


def read_images_text(path) -> Dict[int, ColmapImage]:
    imgs = {}
    with open(path) as f:
        lines = [l.strip() for l in f if l.strip() and not l.startswith("#")]
    for meta in lines[0::2]:
        parts = meta.split()
        iid = int(parts[0])
        imgs[iid] = ColmapImage(
            iid,
            np.array([float(p) for p in parts[1:5]]),
            np.array([float(p) for p in parts[5:8]]),
            int(parts[8]),
            parts[9],
        )
    return imgs


def read_points3d_text(path):
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            xyz.append([float(p) for p in parts[1:4]])
            rgb.append([int(p) for p in parts[4:7]])
            err.append(float(parts[7]))
    return np.array(xyz), np.array(rgb, np.uint8), np.array(err)


def write_points3d_binary(path, xyz, rgb):
    """points3D.bin with empty tracks (for synthetic datasets)."""
    n = len(xyz)
    rec = np.zeros(n, dtype=[("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3),
                             ("err", "<f8"), ("track", "<u8")])
    rec["id"] = np.arange(n)
    rec["xyz"] = xyz
    rec["rgb"] = rgb
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", n))
        f.write(rec.tobytes())


def write_cameras_binary(path, cams):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        name_to_id = {v[0]: k for k, v in CAMERA_MODELS.items()}
        for c in cams.values():
            f.write(
                struct.pack("<iiQQ", c.id, name_to_id[c.model], c.width, c.height)
            )
            f.write(struct.pack(f"<{len(c.params)}d", *c.params.tolist()))


def write_images_binary(path, imgs):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(imgs)))
        for im in imgs.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<4d", *im.qvec.tolist()))
            f.write(struct.pack("<3d", *im.tvec.tolist()))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", 0))
