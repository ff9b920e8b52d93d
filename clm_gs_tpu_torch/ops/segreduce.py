"""Segment reduction for the rasterizer backward: kernel 3.

Per-Gaussian sums of per-instance gradient rows, given the rows sorted by
Gaussian id (clm_gs_tpu/ops/segreduce.py segment_reduce_sorted). Ids < 0 or
>= n are dropped. The stable sort that groups the rows is glue outside the
kernel, as ``jax.lax.sort`` is in the reference.
"""

from __future__ import annotations

import ctypes

import torch

from clm_gs_tpu_torch import _build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
COLS = 9  # the rasterizer's table width, the only row width the kernel takes


def segment_reduce_plain(ids_sorted, rows, n: int):
    """(m,) int32 sorted ids, (m, cols) f32 rows -> (n, cols) f32 sums."""
    keep = (ids_sorted >= 0) & (ids_sorted < n)
    out = torch.zeros((n, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    return out.index_add_(0, ids_sorted[keep].long(), rows[keep])


def segment_reduce_cuda(ids_sorted, rows, n: int):
    """The same through csrc/segreduce.cu.

    Replaces ops/segreduce.py:45 _kernel of the reference (a one-hot MXU
    matmul). Bound by bytes: one launch, each block finds its Gaussians' rows
    by a search of the sorted ids, streams them through shared memory and
    sums each run with a segmented warp scan, without atomics or scratch, in
    an order fixed by the data. Takes rows of COLS columns."""
    m = ids_sorted.shape[0]
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError("segment_reduce_cuda takes CUDA tensors")
    _build.require(ids_sorted, "ids_sorted", torch.int32, (m,), dev)
    _build.require(rows, "rows", torch.float32, (m, rows.shape[1]), dev)
    cols = rows.shape[1]
    if cols != COLS:
        raise ValueError(f"segment_reduce_cuda takes rows of {COLS} columns, "
                         f"not {cols}")
    if m >= 2**31 or n >= 2**31:
        raise ValueError("segment_reduce_cuda: sizes exceed its indexing")
    out = torch.empty((n, cols), dtype=torch.float32, device=dev)
    _build.launch("segreduce", "clmgs_segment_reduce", _ARGTYPES, dev,
                  _build.ptr(ids_sorted), _build.ptr(rows), m, n, cols,
                  _build.ptr(out))
    return out


def segment_reduce_sorted(ids_sorted, rows, n: int):
    """Per-Gaussian sums; CUDA tensors launch the kernel, CPU tensors take
    the plain version."""
    if rows.device.type == "cuda":
        return segment_reduce_cuda(ids_sorted, rows, n)
    return segment_reduce_plain(ids_sorted, rows, n)
