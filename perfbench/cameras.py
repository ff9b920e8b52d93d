"""Camera poses of the benchmark's scenes, as world-to-view matrices in the
column-vector convention (p_cam = viewmat @ [p; 1]), x right and z along the
view, with pinhole intrinsics from a horizontal field of view.

`orbit` circles the origin (a 360-degree capture such as Mip-NeRF 360's);
`serpentine` walks a street grid looking ahead and down (a city capture).
`llff_split` keeps every `hold`-th camera for test, as the trainer's
`--eval --llffhold` does. Poses are fixed by the configuration, not by the
seed, so every seed trains the same views.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def lookat(pos, target):
    """(viewmat (4, 4), camtoworld (4, 4)) of a camera at `pos` looking at
    `target`, world y up."""
    pos = np.asarray(pos, np.float64)
    fwd = np.asarray(target, np.float64) - pos
    fwd /= np.linalg.norm(fwd)
    right = np.cross([0.0, 1.0, 0.0], fwd)
    if np.linalg.norm(right) < 1e-6:
        right = np.array([1.0, 0.0, 0.0])
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([right, up, fwd], axis=1)
    c2w[:3, 3] = pos
    return np.linalg.inv(c2w), c2w


def intrinsics(fovx: float, width: int, height: int) -> np.ndarray:
    """K of a camera whose vertical field of view is fovx * height / width."""
    fovy = fovx * height / width
    fx = width / (2 * math.tan(fovx / 2))
    fy = height / (2 * math.tan(fovy / 2))
    return np.array([[fx, 0, width / 2.0], [0, fy, height / 2.0], [0, 0, 1]])


def orbit(n: int, radius: float, elevation: float):
    """n camera centres evenly on a circle of `radius` at `elevation`, each
    looking at the origin."""
    out = []
    for i in range(n):
        a = 2 * math.pi * i / n
        out.append(lookat([radius * math.sin(a), elevation, -radius * math.cos(a)],
                          [0.0, 0.0, 0.0]))
    return out


def serpentine(n: int, extent: float, elevation: float):
    """n cameras on a serpentine over a side x side grid of the square
    [-0.8 extent, 0.8 extent]^2 at `elevation`, each looking ahead and down at
    its neighbourhood."""
    side = math.ceil(math.sqrt(n))
    step = 2 * extent * 0.8 / side
    out = []
    for r in range(side):
        for c in (range(side) if r % 2 == 0 else range(side - 1, -1, -1)):
            if len(out) == n:
                return out
            x = -extent * 0.8 + (c + 0.5) * step
            z = -extent * 0.8 + (r + 0.5) * step
            out.append(lookat([x, elevation, z], [x + step * 0.8, 0.0, z + step * 0.4]))
    return out


POSES = {"orbit": orbit, "serpentine": serpentine}


def make_cameras(spec: dict, device):
    """The configuration's camera pool: {"viewmats" (N, 4, 4), "Ks" (N, 3, 3),
    "camtoworlds" (N, 4, 4), "width", "height", "train" (T,) int64 ids of
    the training cameras, "extent" (the trainer's scene radius: 1.1 times
    the largest distance of a camera centre from their mean)}."""
    kind = spec["poses"]
    args = {k: v for k, v in spec.items() if k not in ("poses", "count", "fovx",
                                                         "width", "height", "llffhold")}
    poses = POSES[kind](spec["count"], **args)
    W, H = spec["width"], spec["height"]
    K = intrinsics(spec["fovx"], W, H)
    views = np.stack([v for v, _ in poses]).astype(np.float32)
    c2ws = np.stack([c for _, c in poses]).astype(np.float32)
    centres = c2ws[:, :3, 3].astype(np.float64)
    extent = 1.1 * float(np.linalg.norm(centres - centres.mean(0), axis=1).max())
    hold = spec["llffhold"]
    train = [i for i in range(len(poses)) if i % hold != 0]
    return {
        "viewmats": torch.from_numpy(views).to(device),
        "Ks": torch.from_numpy(np.repeat(K[None].astype(np.float32), len(poses), 0)).to(device),
        "camtoworlds": torch.from_numpy(c2ws).to(device),
        "width": W, "height": H,
        "train": torch.tensor(train, dtype=torch.int64),
        "extent": extent,
    }
