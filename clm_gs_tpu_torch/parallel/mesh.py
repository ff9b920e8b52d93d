"""The (data x gauss) mesh and the sharding of the Gaussian state
(clm_gs_tpu/parallel/mesh.py).

Ranks form a 2-D mesh, one rank per card:

  - `gauss` axis: every (C, ...) buffer of the Gaussians (parameters, Adam
    moments, statistics) is split along capacity, so a card holds C/n_gauss
    rows of each;
  - `data` axis: the bsz cameras of a batch are split among the data ranks.

`make_mesh` builds it with torch.distributed's DeviceMesh (rank = data index
x n_gauss + gauss index, so a gauss group is consecutive ranks). Capacities
come from `next_capacity`, a multiple of the capacity granule, which any
realistic gauss axis divides; `shard_capacity_tree` raises where it does not.
Densification, saves, checkpoints and eval work on the whole state:
`gather_capacity_tree` all-gathers it over the gauss axis. Host buffers
(clm_offload's SH rows and moments) follow the same split:
`shard_host_rows` cuts a rank's rows, `gather_host_rows` brings back the
whole buffer, through the card when the group runs NCCL.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

from clm_gs_tpu_torch.models.gaussians import GaussianState
from clm_gs_tpu_torch.utils.hostmem import pinned_zeros


@dataclass(frozen=True)
class Mesh:
    n_data: int
    n_gauss: int
    data_index: int  # this rank's position on each axis
    gauss_index: int
    data_group: Optional[Any] = None  # torch.distributed process groups
    gauss_group: Optional[Any] = None

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "gauss": self.n_gauss}


def mesh_dims(shape: str, world: int):
    """(n_data, n_gauss) of a --mesh_shape: "" puts every rank on the data
    axis, "4" is 4-way data, "2x4" is 2-way data x 4-way gauss. Raises unless
    the mesh holds exactly `world` ranks."""
    try:
        if not shape:
            dims = (world, 1)
        elif "x" in shape:
            a, b = shape.split("x")
            dims = (int(a), int(b))
        else:
            dims = (int(shape), 1)
    except ValueError:
        raise ValueError(f"--mesh_shape {shape!r}: expected '', 'A' or 'AxB'") from None
    if min(dims) < 1 or dims[0] * dims[1] != world:
        raise ValueError(f"--mesh_shape {shape!r} is a {dims[0]}x{dims[1]} mesh; "
                         f"the process group has {world} ranks")
    return dims


def make_mesh(shape: str = "", device="cuda") -> Mesh:
    """The mesh of the started process group; every rank calls it."""
    from torch.distributed.device_mesh import init_device_mesh

    n_data, n_gauss = mesh_dims(shape, dist.get_world_size())
    dm = init_device_mesh(torch.device(device).type, (n_data, n_gauss),
                          mesh_dim_names=("data", "gauss"))
    return Mesh(n_data, n_gauss, dm.get_local_rank("data"), dm.get_local_rank("gauss"),
                dm.get_group("data"), dm.get_group("gauss"))


def map_tree(fn, tree):
    """`fn` applied to every tensor of a tree of dataclasses, tuples, lists
    and dicts; other leaves (ints, None) are kept."""
    if torch.is_tensor(tree):
        return fn(tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: map_tree(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return tree


def shard_capacity_tree(tree, mesh: Mesh, capacity: int):
    """This rank's C/n_gauss rows of every (capacity, ...) tensor of `tree`
    (copies: the whole buffers can be freed); other leaves stay whole."""
    if capacity % mesh.n_gauss:
        raise ValueError(f"capacity {capacity} is not a multiple of the gauss "
                         f"axis {mesh.n_gauss}")
    n = capacity // mesh.n_gauss
    rows = slice(mesh.gauss_index * n, (mesh.gauss_index + 1) * n)

    def cut(x):
        return x[rows].clone() if x.ndim >= 1 and x.shape[0] == capacity else x

    return map_tree(cut, tree)


def shard_state(state: GaussianState, mesh: Mesh) -> GaussianState:
    return shard_capacity_tree(state, mesh, state.capacity)


def gather_rows(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """The (size * n, ...) concatenation of every group rank's (n, ...) x,
    in rank order (bool travels as uint8)."""
    src = x.to(torch.uint8) if x.dtype == torch.bool else x
    out = src.new_empty((size * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src.contiguous(), group=group)
    return out.bool() if x.dtype == torch.bool else out


def gather_capacity_tree(tree, mesh: Mesh, local_capacity: int):
    """Inverse of `shard_capacity_tree`: every (local_capacity, ...) tensor
    all-gathered over the gauss axis into the whole buffer on every rank."""

    def whole(x):
        if x.ndim >= 1 and x.shape[0] == local_capacity:
            return gather_rows(x, mesh.gauss_group, mesh.n_gauss)
        return x

    return map_tree(whole, tree)


def host_copy(x: torch.Tensor, pin: bool) -> torch.Tensor:
    """A contiguous copy of `x` on the host, page-locked when `pin`
    (exactly its size, `hostmem.pinned_zeros`)."""
    out = pinned_zeros(x.shape, x.dtype) if pin else torch.empty(x.shape, dtype=x.dtype)
    out.copy_(x)
    return out


def shard_host_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's C/n_gauss rows of a (C, ...) host tensor, as a copy
    (page-locked where `x` is)."""
    C = x.shape[0]
    if C % mesh.n_gauss:
        raise ValueError(f"capacity {C} is not a multiple of the gauss axis {mesh.n_gauss}")
    n = C // mesh.n_gauss
    return host_copy(x[mesh.gauss_index * n:(mesh.gauss_index + 1) * n], x.is_pinned())


def gather_host_rows(x: torch.Tensor, mesh: Mesh, device) -> torch.Tensor:
    """Inverse of `shard_host_rows` on every rank: the gauss group's (n, ...)
    host tensors concatenated in rank order, on the host (page-locked where
    `x` is). NCCL carries only card tensors, so there the rows go through
    the card `device`; gloo gathers them on the host."""
    if dist.get_backend(mesh.gauss_group) == "nccl":
        whole = gather_rows(x.to(device, non_blocking=True), mesh.gauss_group, mesh.n_gauss)
        return host_copy(whole, x.is_pinned())
    return gather_rows(x, mesh.gauss_group, mesh.n_gauss)


def data_slice(batch, mesh: Mesh):
    """This rank's bsz/n_data cameras of a batch: every tensor of `batch`
    (a CameraBatch, the ground truth, a tuple of them), whose first axis is
    the batch, cut along it."""
    sizes = set()
    map_tree(lambda x: sizes.add(x.shape[0]), batch)
    if len(sizes) != 1:
        raise ValueError(f"a batch's tensors disagree on its size: {sorted(sizes)}")
    (bsz,) = sizes
    if bsz % mesh.n_data:
        raise ValueError(f"mesh data axis {mesh.n_data} does not divide bsz {bsz}")
    b = bsz // mesh.n_data
    rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
    return map_tree(lambda x: x[rows], batch)
