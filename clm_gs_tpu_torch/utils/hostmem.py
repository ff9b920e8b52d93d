"""The card-side SH row gather out of pinned host memory: clm_offload's
`--pinned_host` transport (clm_gs_tpu/utils/hostmem.py).

The reference CLM-GS's send_shs2gpu_stream gathers the visible SH rows
straight out of a pinned host buffer by an index list on the card. The JAX
package compiles that gather as an XLA program over a mirror of the table in
the `pinned_host` memory space (`PinnedShTable`, hostmem.py:86-132), keeps
the mirror in step with its canonical numpy buffer (`refresh`,
`update_rows`), and probes the backend first (`probe()`), falling back to
the host gather where it refuses. Here the canonical buffer
(`ClmContext.sh_host`) is itself pinned, so the card reads it in place
through its mapped address: there is no mirror, nothing to refresh and no
probe. `gather_rows_pinned` launches csrc/pinned_gather.cu for ids on the
card; a table the card cannot map raises, and nothing falls back to the host
gather. The D2H direction (`PinnedGradBuffer`, hostmem.py:135) is not
ported: the JAX package does not use it either.
"""

from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch

from clm_gs_tpu_torch import _build

COLS = 48  # the SH row width, the only one the kernel takes
_PTR_ARGTYPES = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
# csrc/pinned_gather.cu's status codes besides cudaError values
_NOT_PINNED_HOST = -1
_NO_DEVICE_POINTER = -2


# cudaHostRegister's flags: portable (every context) and mapped (the card
# reads the rows in place, csrc/pinned_gather.cu)
_REGISTER_FLAGS = 1 | 2
# from this size up a host buffer is page-locked at its exact size; below
# it the caching host allocator serves it, whose freed blocks later buffers
# of their size class reuse (a mesh densification page-locks its host state
# anew every round)
EXACT_PIN_BYTES = 1 << 30


def pinned_zeros(shape, dtype=torch.float32) -> torch.Tensor:
    """Zeros in page-locked host memory. The caching host allocator behind
    `pin_memory=True` rounds each block up to a power of two, all of it
    page-locked and resident: 1.79x the bytes of BigCity-25M's (25,034,752,
    48) SH rows, and for the 102M scene's two (C, 48) buffers more than its
    host holds. So a buffer of EXACT_PIN_BYTES or more is a numpy allocation
    registered with the CUDA runtime (cudaHostRegister) at its exact size,
    and unregistered when the array, which every view of the tensor keeps
    alive, goes."""
    arr = np.zeros(0, dtype=torch.empty(0, dtype=dtype).numpy().dtype)
    if int(np.prod(shape)) * arr.itemsize < EXACT_PIN_BYTES:
        return torch.zeros(shape, dtype=dtype, pin_memory=True)
    arr = np.zeros(shape, dtype=arr.dtype)
    cudart = torch.cuda.cudart()
    torch.cuda.check_error(cudart.cudaHostRegister(arr.ctypes.data, arr.nbytes,
                                                   _REGISTER_FLAGS))
    weakref.finalize(arr, _unregister, arr.ctypes.data)
    return torch.from_numpy(arr)


def _unregister(ptr: int):
    torch.cuda.cudart().cudaHostUnregister(ptr)


def _check_table(sh_host: torch.Tensor):
    if not torch.is_tensor(sh_host) or sh_host.device.type != "cpu":
        raise ValueError("sh_host must be a CPU tensor")
    if sh_host.dtype != torch.float32 or sh_host.ndim != 2 or sh_host.shape[1] != COLS:
        raise ValueError(f"sh_host must be (C, {COLS}) float32, not "
                         f"{tuple(sh_host.shape)} {sh_host.dtype}")
    if not sh_host.is_contiguous():
        raise ValueError("sh_host must be C-contiguous")


def gather_rows_pinned_plain(sh_host: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(C, 48) host rows, (n,) integer ids -> (n, 48) rows on the ids'
    device, the plain version: the rows gathered on the host and copied."""
    _check_table(sh_host)
    return sh_host[ids.cpu().long()].to(ids.device)


def _device_address(sh_host: torch.Tensor, device) -> int:
    """The card's address of the pinned `sh_host`'s first element, looked up
    with cudaPointerGetAttributes at the start of its storage (the caching
    host allocator's block) plus the tensor's offset. Raises unless the
    storage is pinned host memory that `device` can address."""
    base = sh_host.untyped_storage().data_ptr()
    dev = ctypes.c_void_p()
    lookup = _build.entry("pinned_gather", "clmgs_pinned_device_ptr", _PTR_ARGTYPES)
    with torch.cuda.device(device):
        err = lookup(ctypes.c_void_p(base), ctypes.byref(dev))
    if err == _NOT_PINNED_HOST:
        raise ValueError("sh_host is not in pinned host memory")
    if err == _NO_DEVICE_POINTER:
        raise RuntimeError(f"{device} cannot address the pinned sh_host")
    if err != 0:
        raise RuntimeError(f"cudaPointerGetAttributes failed: cudaError {err}")
    return dev.value + (sh_host.data_ptr() - base)


def gather_rows_pinned_cuda(sh_host: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The same through csrc/pinned_gather.cu: `sh_host` pinned, `ids`
    int32 or int64 on the card, the rows read by the card over the bus into
    a new (n, 48) tensor on the ids' device, on its current stream.

    Replaces hostmem.py:117 PinnedShTable.fetch of the reference. Bound by
    the bytes that cross the bus: twelve lanes carry a row as twelve 16-byte
    loads in a grid-stride loop. The address is looked up on every call, as
    the caller's table is replaced when it grows. An id outside [0, C) makes
    the kernel trap, and the next synchronisation raises."""
    dev = ids.device
    if dev.type != "cuda":
        raise ValueError("gather_rows_pinned_cuda takes ids on the card")
    _check_table(sh_host)
    if ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"ids have dtype {ids.dtype}, expected int32 or int64")
    n = ids.shape[0]
    _build.require(ids, "ids", ids.dtype, (n,), dev)
    out = torch.empty((n, COLS), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    table = _device_address(sh_host, dev)
    _build.launch("pinned_gather", "clmgs_pinned_gather", _ARGTYPES, dev,
                  ctypes.c_void_p(table), sh_host.shape[0], _build.ptr(ids),
                  int(ids.dtype == torch.int64), n, _build.ptr(out))
    return out


def gather_rows_pinned(sh_host: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows `ids` of the host table on the ids' device: ids on the card
    launch the kernel, ids on the CPU take the plain version."""
    if ids.device.type == "cuda":
        return gather_rows_pinned_cuda(sh_host, ids)
    return gather_rows_pinned_plain(sh_host, ids)
