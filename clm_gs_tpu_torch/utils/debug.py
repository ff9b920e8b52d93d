"""Debug dump helpers (clm_gs_tpu/utils/debug.py; the port's own copy):
write images, tiles and masks as text or npz files, to diff one
implementation's intermediate values against another's. Arguments may be
numpy arrays or torch tensors on any device."""

from __future__ import annotations

import os

import numpy as np


def _np(x):
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def dump_image_txt(path: str, image, fmt: str = "%.6f"):
    """(3, H, W) or (H, W) array -> one text file per channel."""
    arr = _np(image)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if arr.ndim == 2:
        np.savetxt(path, arr, fmt=fmt)
    else:
        stem, ext = os.path.splitext(path)
        for c in range(arr.shape[0]):
            np.savetxt(f"{stem}_c{c}{ext or '.txt'}", arr[c], fmt=fmt)


def dump_tile(path: str, image, tile_y: int, tile_x: int, tile_size: int = 16):
    arr = _np(image)
    t = arr[
        ..., tile_y * tile_size : (tile_y + 1) * tile_size,
        tile_x * tile_size : (tile_x + 1) * tile_size,
    ]
    dump_image_txt(path, t)


def dump_mask(path: str, mask):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savetxt(path, _np(mask).astype(np.int32), fmt="%d")


def dump_arrays(path: str, **arrays):
    """npz bundle of named arrays (for allclose diffing across runs)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{k: _np(v) for k, v in arrays.items()})


def compare_dumps(path_a: str, path_b: str, rtol=1e-5, atol=1e-6):
    """Compare two npz dumps; returns {name: max_abs_diff} for mismatches."""
    a, b = np.load(path_a), np.load(path_b)
    out = {}
    for k in a.files:
        if k not in b.files:
            out[k] = float("inf")
            continue
        if not np.allclose(a[k], b[k], rtol=rtol, atol=atol):
            out[k] = float(np.max(np.abs(a[k] - b[k])))
    return out
