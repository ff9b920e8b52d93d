"""The SIMD host Adam (clm_gs_tpu/utils/native.py:57-160, :210-273).

`HostAdam` keeps Adam's moments for one parameter group as (N, cols)
float32 CPU tensors and updates rows of a caller-owned parameter buffer
through `csrc/host/cpu_adam.cpp` (built by `_build.host_library`, called
with ctypes on `data_ptr()`). The library's other entry points (row gather,
scatter-add, stamps, counting sort, id-list merge) and `fast_tsp.cpp` are
bound by the clm_offload slice.

Every buffer handed to the library is checked first: a CPU tensor, float32,
C-contiguous, of the expected shape. The kernel indexes raw row-major
memory, so a transposed or sliced view would be read as garbage rather than
fail. `host_adam_step_plain` is the same update in torch, for the tests.
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

_f32p = ctypes.c_void_p
_i32p = ctypes.c_void_p


def host_threads() -> int:
    """Worker threads of the host Adam: at most 4, one core left for the
    Python thread (CLMGS_HOST_THREADS overrides)."""
    env = os.environ.get("CLMGS_HOST_THREADS")
    if env:
        return max(1, int(env))
    return max(1, min(4, (os.cpu_count() or 2) - 1))


@functools.cache
def _adam_lib() -> ctypes.CDLL:
    """The host Adam library with its entry point's argument types set;
    raises when it does not build or carries another ABI."""
    lib = _build.host_library("cpu_adam")
    lib.native_abi_version.restype = ctypes.c_int64
    lib.native_abi_version.argtypes = []
    abi = lib.native_abi_version()
    if abi != ADAM_ABI:
        raise RuntimeError(f"libcpu_adam.so has ABI {abi}, expected {ADAM_ABI}")
    lib.adam_sparse_step_mt.restype = None
    lib.adam_sparse_step_mt.argtypes = [
        _f32p, _f32p, _f32p, _f32p, _i32p, ctypes.c_int64, ctypes.c_int,
        _f32p, ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int64, ctypes.c_int,
    ]
    return lib


def _require(t, name: str, shape) -> None:
    if not torch.is_tensor(t) or t.device.type != "cpu":
        raise ValueError(f"{name} must be a CPU tensor")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} has dtype {t.dtype}, expected torch.float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be C-contiguous")


def _indices(indices, n: int) -> torch.Tensor:
    idx = torch.as_tensor(indices, dtype=torch.int32, device="cpu").contiguous()
    if idx.ndim != 1:
        raise ValueError("indices must be one-dimensional")
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= n):
        raise ValueError(f"indices out of range [0, {n})")
    return idx


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
