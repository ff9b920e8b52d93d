"""The host libraries: the SIMD host Adam, the row gathers and scatters, the
finish-set primitives and the camera-order TSP (clm_gs_tpu/utils/native.py).

`HostAdam` keeps Adam's moments for one parameter group as (N, cols)
float32 CPU tensors and updates rows of a caller-owned parameter buffer
through `csrc/host/cpu_adam.cpp`. The same library gathers and scatter-adds
SH rows between the host buffers and the transfer staging
(`gather_rows`, `scatter_add_rows`), stamps each row's last use in a batch
(`stamp_rows`, int16), lists the stamped rows (`nonzero_stamp`), splits them
by stamp (`counting_sort_perm`) and classifies two sorted id lists for the
working-set retention (`classify_sorted`). `find_tour` orders the cameras
through `csrc/host/fast_tsp.cpp`. Both libraries are built by
`_build.host_library` and called with ctypes on `data_ptr()`; a failed build
raises, and there is no Python fallback.

Every buffer handed to a library is checked first: a CPU tensor of the
expected dtype (int16 for the stamps, int32 for ids, float32 for rows),
C-contiguous, of the expected shape, and every id in range. The libraries
index raw row-major memory, so a transposed or sliced view would be read as
garbage rather than fail. Each entry has a plain torch twin (`*_plain`,
`host_adam_step_plain`) with the same results, for the tests.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from clm_gs_tpu_torch import _build

# csrc/host/cpu_adam.cpp's native_abi_version(): a library of another
# version has same-named entry points with other arguments
ADAM_ABI = 3
# the reference's time budget of the TSP's 2-opt (engine.py:179)
TSP_BUDGET_S = 1e-3

_p = ctypes.c_void_p
_i64 = ctypes.c_int64
_int = ctypes.c_int


def host_threads() -> int:
    """Worker threads of the host Adam: at most 4, one core left for the
    Python thread (CLMGS_HOST_THREADS overrides)."""
    env = os.environ.get("CLMGS_HOST_THREADS")
    if env:
        return max(1, int(env))
    return max(1, min(4, (os.cpu_count() or 2) - 1))


@functools.cache
def _adam_lib() -> ctypes.CDLL:
    """The host Adam library with every entry point's argument types set;
    raises when it does not build or carries another ABI."""
    lib = _build.host_library("cpu_adam")
    lib.native_abi_version.restype = ctypes.c_int64
    lib.native_abi_version.argtypes = []
    abi = lib.native_abi_version()
    if abi != ADAM_ABI:
        raise RuntimeError(f"libcpu_adam.so has ABI {abi}, expected {ADAM_ABI}")
    sigs = {
        "adam_sparse_step_mt": [_p, _p, _p, _p, _p, _i64, _int, _p, ctypes.c_float,
                                ctypes.c_float, ctypes.c_float, ctypes.c_float,
                                _i64, _int],
        "gather_rows_mt": [_p, _p, _p, _i64, _int, _int],
        "scatter_add_rows_mt": [_p, _p, _p, _i64, _int, _int, _int],
        "stamp_rows_i16": [_p, _p, _i64, ctypes.c_int16, _int],
        "nonzero_stamp_i16": [_p, _p, _i64, _int, _p, _int],
        "counting_sort_perm_counts_i16": [_p, _i64, _int, _p, _p, _int],
        "classify_sorted": [_p, _i64, _p, _i64, _p, _p, _p, _p, _p],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = None
    lib.nonzero_stamp_i16.restype = ctypes.c_int64
    return lib


@functools.cache
def _tsp_lib() -> ctypes.CDLL:
    lib = _build.host_library("fast_tsp")
    lib.find_tour.argtypes = [_p, _int, ctypes.c_double, _p]
    lib.find_tour.restype = None
    return lib


def _require(t, name: str, shape, dtype=torch.float32) -> None:
    if not torch.is_tensor(t) or t.device.type != "cpu":
        raise ValueError(f"{name} must be a CPU tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be C-contiguous")


def _indices(indices, n: int) -> torch.Tensor:
    """`indices` as a contiguous int32 CPU tensor, every id in [0, n)."""
    idx = torch.as_tensor(indices, dtype=torch.int32, device="cpu").contiguous()
    if idx.ndim != 1:
        raise ValueError("indices must be one-dimensional")
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= n):
        raise ValueError(f"indices out of range [0, {n})")
    return idx


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _rows_buffer(buf, name: str):
    if not torch.is_tensor(buf) or buf.ndim != 2:
        raise ValueError(f"{name} must be a two-dimensional tensor")
    _require(buf, name, buf.shape)


class HostAdam:
    """Adam moments of one (N, cols) group on the host; the parameter and
    gradient buffers belong to the caller. `lr_cols` holds one learning rate
    per column and `step_count` the group's own step count (the bias
    correction's exponent)."""

    def __init__(self, n: int, cols: int, lr_cols, betas=(0.9, 0.999),
                 eps: float = 1e-15):
        self.cols = cols
        self.exp_avg = torch.zeros((n, cols), dtype=torch.float32)
        self.exp_avg_sq = torch.zeros((n, cols), dtype=torch.float32)
        self.lr_cols = torch.as_tensor(lr_cols, dtype=torch.float32).contiguous()
        self.betas = tuple(betas)
        self.eps = eps
        self.step_count = 0

    def grow(self, new_n: int):
        """Pad both moments with zero rows to `new_n`."""
        for name in ("exp_avg", "exp_avg_sq"):
            old = getattr(self, name)
            new = torch.zeros((new_n, self.cols), dtype=torch.float32)
            new[: old.shape[0]] = old
            setattr(self, name, new)

    def sparse_step(self, params, grads, indices, grad_scale=1.0, step=None):
        """Update rows `indices` (unique) of `params` from `grads` scaled by
        `grad_scale`, and zero those grad rows in place."""
        step = self.step_count if step is None else step
        n = self.exp_avg.shape[0]
        for t, name in ((params, "params"), (grads, "grads"),
                        (self.exp_avg, "exp_avg"), (self.exp_avg_sq, "exp_avg_sq")):
            _require(t, name, (n, self.cols))
        _require(self.lr_cols, "lr_cols", (self.cols,))
        idx = _indices(indices, n)
        _adam_lib().adam_sparse_step_mt(
            params.data_ptr(), grads.data_ptr(), self.exp_avg.data_ptr(),
            self.exp_avg_sq.data_ptr(), idx.data_ptr(), idx.numel(), self.cols,
            self.lr_cols.data_ptr(), self.betas[0], self.betas[1], self.eps,
            grad_scale, int(step), host_threads(),
        )

    def dense_step(self, params, grads, n, grad_scale=1.0, step=None):
        """`sparse_step` over rows [0, n)."""
        self.sparse_step(params, grads, torch.arange(n, dtype=torch.int32),
                         grad_scale, step)


@torch.no_grad()
def host_adam_step_plain(params, grads, exp_avg, exp_avg_sq, indices, lr_cols,
                         betas, eps, grad_scale, step):
    """`HostAdam.sparse_step` in torch, in place on the given tensors: the
    bias corrections 1 - beta^step in float32, as the library computes them."""
    idx = torch.as_tensor(indices, dtype=torch.int64)
    b1, b2 = (torch.tensor(b, dtype=torch.float32) for b in betas)
    inv_bc1 = 1.0 / (1.0 - b1 ** step)
    inv_bc2 = 1.0 / (1.0 - b2 ** step)
    g = grads[idx] * grad_scale
    m = b1 * exp_avg[idx] + (1.0 - b1) * g
    v = b2 * exp_avg_sq[idx] + (1.0 - b2) * g * g
    exp_avg[idx] = m
    exp_avg_sq[idx] = v
    params[idx] -= lr_cols * (m * inv_bc1) / (torch.sqrt(v * inv_bc2) + eps)
    grads[idx] = 0.0


def find_tour(dist, time_budget_s: float = TSP_BUDGET_S) -> torch.Tensor:
    """(n,) int32 permutation of the cameras minimising the open path's
    total distance over the (n, n) int32 matrix `dist`: greedy nearest
    neighbour from every start, then 2-opt within the time budget."""
    n = dist.shape[0] if torch.is_tensor(dist) else 0
    _require(dist, "dist", (n, n), torch.int32)
    out = torch.empty(n, dtype=torch.int32)
    _tsp_lib().find_tour(_ptr(dist), n, time_budget_s, _ptr(out))
    return out


def find_tour_plain(dist) -> torch.Tensor:
    """`find_tour` in Python, with 2-opt run to convergence."""
    d = dist.tolist()
    n = len(d)
    best, best_cost = None, None
    for s in range(n):
        tour, used = [s], {s}
        for _ in range(n - 1):
            prev = tour[-1]
            nxt = min((j for j in range(n) if j not in used), key=lambda j: (d[prev][j], j))
            tour.append(nxt)
            used.add(nxt)
        cost = sum(d[tour[i]][tour[i + 1]] for i in range(n - 1))
        if best_cost is None or cost < best_cost:
            best, best_cost = tour, cost
    improved = True
    while improved:
        improved = False
        for i in range(n - 1):
            for j in range(i + 1, n):
                delta = 0
                if i > 0:
                    delta += d[best[i - 1]][best[j]] - d[best[i - 1]][best[i]]
                if j < n - 1:
                    delta += d[best[i]][best[j + 1]] - d[best[j]][best[j + 1]]
                if delta < 0:
                    best[i:j + 1] = best[i:j + 1][::-1]
                    improved = True
    return torch.tensor(best, dtype=torch.int32)


def gather_rows(buf, indices, out=None) -> torch.Tensor:
    """out[k] = buf[indices[k]] for the (N, cols) float32 `buf`; `out` is a
    (len(indices), cols) float32 buffer to fill, or None for a new one."""
    _rows_buffer(buf, "buf")
    idx = _indices(indices, buf.shape[0])
    cols = buf.shape[1]
    if out is None:
        out = torch.empty((idx.numel(), cols), dtype=torch.float32)
    _require(out, "out", (idx.numel(), cols))
    _adam_lib().gather_rows_mt(_ptr(buf), _ptr(out), _ptr(idx), idx.numel(), cols,
                               host_threads())
    return out


def gather_rows_plain(buf, indices, out=None) -> torch.Tensor:
    rows = buf[torch.as_tensor(indices).long()]
    return rows if out is None else out.copy_(rows)


def scatter_add_rows(buf, rows, indices, accumulate: bool = True) -> None:
    """buf[indices[k]] += rows[k] (or = with accumulate false), in place;
    the ids are unique, as the library's threads split them."""
    _rows_buffer(buf, "buf")
    idx = _indices(indices, buf.shape[0])
    cols = buf.shape[1]
    _require(rows, "rows", (idx.numel(), cols))
    _adam_lib().scatter_add_rows_mt(_ptr(buf), _ptr(rows), _ptr(idx), idx.numel(),
                                    cols, int(accumulate), host_threads())


def scatter_add_rows_plain(buf, rows, indices, accumulate: bool = True) -> None:
    idx = torch.as_tensor(indices).long()
    if accumulate:
        buf.index_add_(0, idx, rows)
    else:
        buf[idx] = rows


def stamp_rows(last_use, indices, pos: int) -> None:
    """last_use[indices] = pos on the (C,) int16 stamps; ids unique."""
    n = last_use.shape[0] if torch.is_tensor(last_use) else 0
    _require(last_use, "last_use", (n,), torch.int16)
    if not -2**15 <= pos < 2**15:
        raise ValueError(f"stamp {pos} outside int16")
    idx = _indices(indices, n)
    _adam_lib().stamp_rows_i16(_ptr(last_use), _ptr(idx), idx.numel(), pos,
                               host_threads())


def stamp_rows_plain(last_use, indices, pos: int) -> None:
    last_use[torch.as_tensor(indices).long()] = pos


def nonzero_stamp(last_use, alive=None, mode: int = 0) -> torch.Tensor:
    """Ascending int32 rows of the (C,) int16 stamps where, for mode 0,
    last_use >= 0 (the batch's visible union), or, for mode 1,
    last_use == -1 and `alive` (the live rows no camera sees)."""
    n = last_use.shape[0] if torch.is_tensor(last_use) else 0
    _require(last_use, "last_use", (n,), torch.int16)
    if mode not in (0, 1):
        raise ValueError(f"mode {mode} is not 0 or 1")
    ap = ctypes.c_void_p()
    if mode == 1:
        _require(alive, "alive", (n,), torch.bool)
        ap = _ptr(alive)  # bool is one byte, 0 or 1
    out = torch.empty(n, dtype=torch.int32)
    cnt = _adam_lib().nonzero_stamp_i16(_ptr(last_use), ap, n, mode, _ptr(out),
                                        host_threads())
    return out[:cnt].clone()


def nonzero_stamp_plain(last_use, alive=None, mode: int = 0) -> torch.Tensor:
    mask = last_use >= 0 if mode == 0 else (last_use == -1) & alive
    return torch.nonzero(mask).flatten().to(torch.int32)


def counting_sort_perm(keys, n_buckets: int):
    """Stable argsort of the int16 `keys`, each in [0, n_buckets): (int32
    permutation, int64 count of each key)."""
    n = keys.shape[0] if torch.is_tensor(keys) else 0
    _require(keys, "keys", (n,), torch.int16)
    if n and (int(keys.min()) < 0 or int(keys.max()) >= n_buckets):
        raise ValueError(f"keys out of range [0, {n_buckets})")
    perm = torch.empty(n, dtype=torch.int32)
    counts = torch.zeros(n_buckets, dtype=torch.int64)
    _adam_lib().counting_sort_perm_counts_i16(_ptr(keys), n, n_buckets, _ptr(perm),
                                              _ptr(counts), host_threads())
    return perm, counts


def counting_sort_perm_plain(keys, n_buckets: int):
    perm = torch.sort(keys.long(), stable=True).indices.to(torch.int32)
    return perm, torch.bincount(keys.long(), minlength=n_buckets)


def classify_sorted(a, b):
    """Merge two ascending unique int32 id lists: (pd, pn) the positions in
    `a` and in `b` of the ids both hold, gp the positions in `a` of ids only
    it holds, hn the positions in `b` of ids only it holds; int32 each."""
    na = a.shape[0] if torch.is_tensor(a) else 0
    nb = b.shape[0] if torch.is_tensor(b) else 0
    _require(a, "a", (na,), torch.int32)
    _require(b, "b", (nb,), torch.int32)
    pd = torch.empty(min(na, nb), dtype=torch.int32)
    pn = torch.empty(min(na, nb), dtype=torch.int32)
    gp = torch.empty(na, dtype=torch.int32)
    hn = torch.empty(nb, dtype=torch.int32)
    counts = torch.zeros(4, dtype=torch.int64)
    _adam_lib().classify_sorted(_ptr(a), na, _ptr(b), nb, _ptr(pd), _ptr(pn),
                                _ptr(gp), _ptr(hn), _ptr(counts))
    nd, ng, nh = (int(counts[k]) for k in (0, 2, 3))
    return pd[:nd], pn[:nd], gp[:ng], hn[:nh]


def classify_sorted_plain(a, b):
    a64, b64 = a.long(), b.long()
    if len(b64):
        loc = torch.searchsorted(b64, a64)
        common = b64[torch.clamp_max(loc, len(b64) - 1)] == a64
    else:
        loc = torch.zeros_like(a64)
        common = torch.zeros(len(a64), dtype=torch.bool)
    pd = torch.nonzero(common).flatten()
    pn = loc[pd]
    gp = torch.nonzero(~common).flatten()
    in_a = torch.zeros(len(b64), dtype=torch.bool)
    in_a[pn] = True
    hn = torch.nonzero(~in_a).flatten()
    return tuple(x.to(torch.int32) for x in (pd, pn, gp, hn))
