"""Gaussian model state (clm_gs_tpu/models/gaussians.py).

Fixed-capacity rows plus an ``alive`` mask, as in the reference, so the two
packages' tensors line up row for row. Per Gaussian: xyz(3), opacity(1,
pre-sigmoid), log_scale(3), quat(4, unnormalized [w, x, y, z]) and sh(48) =
[dc(3); rest(45)], reshaped to (16, 3) for evaluation.

Initialisation from a point cloud: opacity = inverse_sigmoid(0.1), scale =
sqrt(mean squared distance to the 3 nearest neighbours), quat = (1, 0, 0, 0),
sh dc = RGB2SH(colour), sh rest = 0. The PLY and tensor files have the
reference's layouts, so either package reads the other's files.

With ``host_sh=True`` (clm_offload) the loaders return ``(state, sh_host)``:
the (C, 48) SH block goes to a host buffer (pinned when the state is on the
card) and never to the card, whose state carries a (1, 48) zero placeholder.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from clm_gs_tpu_torch.ops.knn import knn_mean_sq_dist
from clm_gs_tpu_torch.ops.sh import rgb_to_sh
from clm_gs_tpu_torch.utils.general import check_device, next_capacity

PARAM_FIELDS = ("xyz", "opacity", "log_scale", "quat", "sh")


@dataclass(frozen=True)
class GaussianParams:
    xyz: torch.Tensor  # (C, 3)
    opacity: torch.Tensor  # (C,) pre-sigmoid
    log_scale: torch.Tensor  # (C, 3)
    quat: torch.Tensor  # (C, 4)
    sh: torch.Tensor  # (C, 48)

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    def astuple(self):
        return (self.xyz, self.opacity, self.log_scale, self.quat, self.sh)


@dataclass(frozen=True)
class GaussianState:
    """Parameters + liveness + densification statistics."""

    params: GaussianParams
    alive: torch.Tensor  # (C,) bool
    n_alive: int
    xyz_grad_accum: torch.Tensor  # (C,)
    denom: torch.Tensor  # (C,)
    max_radii2d: torch.Tensor  # (C,)

    @property
    def capacity(self) -> int:
        return self.params.capacity


def activated(params: GaussianParams):
    """(opacity, scales) activations."""
    return torch.sigmoid(params.opacity), torch.exp(params.log_scale)


def sh_coeffs(params: GaussianParams):
    return params.sh.reshape(params.capacity, 16, 3)


def empty_state(capacity: int, device="cuda") -> GaussianState:
    device = check_device(device)

    def z(*s):
        return torch.zeros(s, dtype=torch.float32, device=device)

    params = GaussianParams(
        xyz=z(capacity, 3), opacity=z(capacity), log_scale=z(capacity, 3),
        quat=z(capacity, 4), sh=z(capacity, 48),
    )
    return GaussianState(
        params=params,
        alive=torch.zeros(capacity, dtype=torch.bool, device=device),
        n_alive=0,
        xyz_grad_accum=z(capacity),
        denom=z(capacity),
        max_radii2d=z(capacity),
    )


def host_zeros(rows: int, cols: int, device) -> torch.Tensor:
    """(rows, cols) float32 zeros on the host, pinned when `device` is a
    card (the buffers a strategy keeps off the card and copies from)."""
    return torch.zeros((rows, cols), dtype=torch.float32,
                       pin_memory=check_device(device).type == "cuda")


def _from_rows(rows: dict, n: int, capacity: Optional[int], device,
               host_sh: bool = False):
    """A state whose first n rows are the numpy `rows` (xyz, opacity,
    log_scale, quat, sh), padded with zeros to `capacity` (next_capacity(n)
    when None); the statistics start at zero. With `host_sh`, returns
    (state with the SH placeholder, (capacity, 48) host SH rows)."""
    device = check_device(device)
    if capacity is None:
        capacity = next_capacity(n)
    if capacity < n:
        raise ValueError(f"capacity {capacity} is below the {n} Gaussians to load")

    def pad(x):
        out = torch.zeros((capacity,) + x.shape[1:], dtype=torch.float32)
        out[:n] = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        return out.to(device)

    def z():
        return torch.zeros(capacity, dtype=torch.float32, device=device)

    params = {f: pad(rows[f]) for f in PARAM_FIELDS if f != "sh" or not host_sh}
    if host_sh:
        sh_host = host_zeros(capacity, 48, device)
        sh_host[:n] = torch.from_numpy(np.ascontiguousarray(rows["sh"], np.float32))
        params["sh"] = torch.zeros((1, 48), dtype=torch.float32, device=device)
    state = GaussianState(
        params=GaussianParams(**params),
        alive=torch.arange(capacity, device=device) < n,
        n_alive=n, xyz_grad_accum=z(), denom=z(), max_radii2d=z(),
    )
    return (state, sh_host) if host_sh else state


def create_from_pcd(points: np.ndarray, colors: np.ndarray,
                    capacity: Optional[int] = None,
                    downsample_ratio: float = 1.0, seed: int = 0,
                    device="cuda", host_sh: bool = False):
    """Initialise from a point cloud (positions, RGB in [0, 1]), with the
    optional random downsample (--initial_point_cloud_downsampled_ratio).
    With `host_sh`, returns (state, sh_host) (module docstring)."""
    device = check_device(device)
    points = np.asarray(points, np.float32)
    colors = np.asarray(colors, np.float32)
    if downsample_ratio < 1.0:
        keep = np.random.RandomState(seed).rand(len(points)) < downsample_ratio
        points, colors = points[keep], colors[keep]
    n = len(points)
    dist2 = knn_mean_sq_dist(torch.from_numpy(points).to(device)).cpu().numpy()
    log_scale = np.log(np.sqrt(dist2))[:, None].repeat(3, axis=1)
    sh = np.zeros((n, 48), np.float32)
    sh[:, 0:3] = rgb_to_sh(colors)
    quat = np.zeros((n, 4), np.float32)
    quat[:, 0] = 1.0
    opacity = np.full((n,), np.log(np.float32(0.1 / 0.9)), np.float32)  # logit(0.1)
    rows = {"xyz": points, "opacity": opacity, "log_scale": log_scale,
            "quat": quat, "sh": sh}
    return _from_rows(rows, n, capacity, device, host_sh)


def grow_capacity(state: GaussianState, new_capacity: int) -> GaussianState:
    """Re-pad every array to a larger capacity. Each array is a new buffer,
    but for a host-kept group's (1, cols) placeholder (rows != capacity),
    which stays as it is."""
    C = state.capacity
    extra = new_capacity - C
    if extra < 0:
        raise ValueError(f"cannot shrink capacity {C} to {new_capacity}")

    def pad(x):
        if x.shape[0] != C:
            return x
        return torch.cat([x, x.new_zeros((extra,) + x.shape[1:])])

    return GaussianState(
        params=GaussianParams(*(pad(x) for x in state.params.astuple())),
        alive=pad(state.alive), n_alive=state.n_alive,
        xyz_grad_accum=pad(state.xyz_grad_accum), denom=pad(state.denom),
        max_radii2d=pad(state.max_radii2d),
    )


# PLY and tensor files: the reference's 59-property schema and its 5-tensor
# layout (xyz / opacity / scaling / rotation / parameters).

PLY_PROPS = (
    ["x", "y", "z", "nx", "ny", "nz"]
    + [f"f_dc_{i}" for i in range(3)]
    + [f"f_rest_{i}" for i in range(45)]
    + ["opacity"]
    + [f"scale_{i}" for i in range(3)]
    + [f"rot_{i}" for i in range(4)]
)


def _compact(state: GaussianState) -> dict:
    """Live rows gathered to the front, as host numpy arrays. A field may
    lie on the host while the others are on the card (clm_offload's
    `materialize_host`)."""
    idx = torch.nonzero(state.alive).flatten()
    out = {}
    for f in PARAM_FIELDS:
        t = getattr(state.params, f)
        out[f] = t[idx.to(t.device)].cpu().numpy()
    return out


def save_ply(state: GaussianState, path: str, chunk_rows: Optional[int] = None):
    """Binary little-endian PLY of the live rows. With `chunk_rows`, writes
    `<stem>_rk{i}_ws{n}.ply` files of at most that many rows each."""
    d = _compact(state)
    n = len(d["xyz"])
    # f_rest is channel-major: f_rest_{c*15+j} = sh (16, 3) row j+1, channel c
    rest = d["sh"][:, 3:].reshape(n, 15, 3).transpose(0, 2, 1).reshape(n, 45)
    cols = np.concatenate(
        [d["xyz"], np.zeros((n, 3), np.float32), d["sh"][:, 0:3], rest,
         d["opacity"][:, None], d["log_scale"], d["quat"]],
        axis=1,
    ).astype("<f4")

    def write_one(path, rows):
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(rows)}\n"
            + "".join(f"property float {p}\n" for p in PLY_PROPS)
            + "end_header\n"
        )
        with open(path, "wb") as f:
            f.write(header.encode("ascii"))
            f.write(rows.tobytes())

    if chunk_rows is None or n <= chunk_rows:
        write_one(path, cols)
        return
    ws = math.ceil(n / chunk_rows)
    stem = path[:-4] if path.endswith(".ply") else path
    for i in range(ws):
        write_one(f"{stem}_rk{i}_ws{ws}.ply",
                  cols[i * chunk_rows:(i + 1) * chunk_rows])


def load_ply(path: str, capacity: Optional[int] = None, device="cuda",
             host_sh: bool = False):
    """A model PLY of the 59-property schema; raises when `capacity` is
    below its row count. With `host_sh`, returns (state, sh_host)."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    n, props = None, []
    for line in data[:end].decode("ascii").splitlines():
        if line.startswith("element vertex"):
            n = int(line.split()[-1])
        elif line.startswith("property float"):
            props.append(line.split()[-1])
    if n is None or props != PLY_PROPS:
        raise ValueError(f"{path}: not a Gaussian model PLY of the expected schema")
    cols = np.frombuffer(data[end:], dtype="<f4", count=n * len(props))
    cols = cols.reshape(n, len(props))
    rest = cols[:, 9:54].reshape(n, 3, 15).transpose(0, 2, 1).reshape(n, 45)
    rows = {"xyz": cols[:, 0:3], "opacity": cols[:, 54],
            "log_scale": cols[:, 55:58], "quat": cols[:, 58:62],
            "sh": np.concatenate([cols[:, 6:9], rest], axis=1)}
    return _from_rows(rows, n, capacity, device, host_sh)


def resize_rows(state: GaussianState, coeff: float) -> GaussianState:
    """--drop_duplicate_gaussians_coeff: keep the first int(n * coeff) live
    rows modulo n (truncates when coeff < 1, repeats rows when > 1), at
    next_capacity of the new count. The statistics restart at zero; the
    caller restarts the optimizer."""
    d = _compact(state)
    n = len(d["xyz"])
    keep = np.arange(int(n * coeff), dtype=np.int64) % max(n, 1)
    rows = {f: v[keep] for f, v in d.items()}
    return _from_rows(rows, len(keep), None, state.params.xyz.device)


def save_tensors(state: GaussianState, path: str):
    """.npz of the live rows in the 5-tensor layout."""
    d = _compact(state)
    np.savez(path, xyz=d["xyz"], opacity=d["opacity"], scaling=d["log_scale"],
             rotation=d["quat"], parameters=d["sh"])


def load_tensors(path: str, capacity: Optional[int] = None, device="cuda",
                 host_sh: bool = False):
    """A 5-tensor .npz; raises when `capacity` is below its row count. With
    `host_sh`, returns (state, sh_host)."""
    with np.load(path) as z:
        n = len(z["xyz"])
        rows = {"xyz": z["xyz"], "opacity": z["opacity"].reshape(n),
                "log_scale": z["scaling"], "quat": z["rotation"],
                "sh": z["parameters"]}
    return _from_rows(rows, n, capacity, device, host_sh)
