"""clm_offload's `--pinned_host` transport (clm_gs_tpu/utils/hostmem.py):
the card reads the SH rows out of pinned host memory, and adds the SH
gradients into it, through the memory's mapped address.

The reference CLM-GS moves the SH stream in both directions by device index
lists over pinned host buffers: send_shs2gpu_stream gathers the visible SH
rows, and send_shs2cpu_grad_buffer_stream scatter-adds the gradient rows
that leave the working set into the pinned gradient buffer. The JAX package
compiles both as XLA programs over tables in the `pinned_host` memory space:
the gather over a mirror of the SH table (`PinnedShTable`,
hostmem.py:86-132), kept in step with its canonical numpy buffer
(`refresh`, `update_rows`) after a probe of the backend (`probe()`), and the
scatter-add over a donated gradient table (`PinnedGradBuffer`,
hostmem.py:135-190), which it leaves out of clm's drain because its backend
cannot share the donated table with the host Adam that consumes its rows.
Here the canonical buffers are themselves pinned (`ClmContext.sh_host` and
`sh_grad_host`), so the card reads and writes them in place: no mirror,
nothing to refresh, no probe, and the host Adam updates the same memory.
`gather_rows_pinned` launches csrc/pinned_gather.cu and
`scatter_add_rows_pinned` csrc/pinned_scatter.cu for tensors on the card;
on the CPU each takes its plain version. A table the card cannot map
raises, and nothing falls back to the host gather or the host scatter.
`PinnedGradBuffer` is the JAX class's counterpart over the scatter.
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import numpy as np
import torch

from clm_gs_tpu_torch import _build

COLS = 48  # the SH row width, the only one the kernel takes
_PTR_ARGTYPES = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
_GRID_ARGTYPES = [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_void_p, *_GRID_ARGTYPES]
_SCATTER_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                     *_GRID_ARGTYPES]
# csrc/pinned_gather.cu's status codes besides cudaError values
_NOT_PINNED_HOST = -1
_NO_DEVICE_POINTER = -2

# The kernels' geometry (csrc/pinned_rows.cuh): a warp moves ROW_GROUP rows
# a group and each kernel's PINNED_DEPTH groups a step, every read of a step
# issued before its first store; a block walks one contiguous range of rows.
# The bus, not the SMs, bounds them, so the grid is small: at most
# 1/SM_SHARE of the card's SMs, the rest left to the micro step beside them.
ROW_GROUP = 8
SM_SHARE = 8
# Most blocks of each kernel, from utils/pinned_probe.py's sweep and its
# matmuls beside each grid on H100 hosts (132 SMs; PERF.md §6). The gather
# runs on the compute stream, in line with the micro step: the grid nearest
# its best time on every host measured. The scatter runs beside the next
# camera's micro step: the smallest grid that leaves the card's other work
# near its time alone, at the cost of its own time (adding, above twice its
# bound)
GATHER_BLOCKS = 16
SCATTER_BLOCKS = 4


def launch_blocks(sms: int, most: int) -> int:
    """The blocks a kernel of at most `most` blocks takes on a card of
    `sms` SMs: no more than 1/SM_SHARE of them, and at least one."""
    return max(1, min(most, sms // SM_SHARE))


def pinned_grid(n: int, blocks: int) -> tuple:
    """(blocks used, rows_per_block) of a launch over n rows in at most
    `blocks` blocks: block b takes rows [b * rows_per_block, min(n, (b + 1)
    * rows_per_block)), rows_per_block a multiple of ROW_GROUP, and no block
    is empty; (0, 0) for no rows."""
    if n < 0 or blocks < 1:
        raise ValueError(f"pinned_grid({n}, {blocks}): n >= 0 rows and blocks >= 1")
    if n == 0:
        return 0, 0
    rows_per_block = -(-n // blocks)
    rows_per_block = -(-rows_per_block // ROW_GROUP) * ROW_GROUP
    return -(-n // rows_per_block), rows_per_block


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _grid(n: int, device, most: int) -> tuple:
    """`pinned_grid` of a launch over n rows on `device`."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return pinned_grid(n, launch_blocks(_sms(index), most))


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
    host holds. So a buffer of EXACT_PIN_BYTES or more is registered with
    the CUDA runtime at its exact size (`register`). It starts on a 2 MiB
    boundary and is advised to the kernel as transparent huge pages before
    its first touch (`_huge_zeros`): the card's kernels read rows spread over
    the whole table (csrc/pinned_gather.cu, pinned_scatter.cu), and with 2
    MiB pages their address translation no longer bounds them
    (utils/pinned_probe.py on an H100, 800,000 ids spread over 25M rows: the
    gather 13.0 -> 9.1 ms, the adding scatter 18.3 -> 10.1, storing 8.3 ->
    3.6, near consecutive rows' 8.8, 10.6, 4.6; PERF.md §6)."""
    itemsize = torch.empty(0, dtype=dtype).element_size()
    nbytes = int(np.prod(shape)) * itemsize
    if nbytes < EXACT_PIN_BYTES:
        return torch.zeros(shape, dtype=dtype, pin_memory=True)
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    return register(_huge_zeros(nbytes).view(np_dtype).reshape(shape))


def register(arr: np.ndarray) -> torch.Tensor:
    """A tensor over `arr`, page-locked and mapped for every card
    (cudaHostRegister) until the array, which every view of the tensor keeps
    alive, goes."""
    cudart = torch.cuda.cudart()
    torch.cuda.check_error(cudart.cudaHostRegister(arr.ctypes.data, arr.nbytes,
                                                   _REGISTER_FLAGS))
    weakref.finalize(arr, _unregister, arr.ctypes.data)
    return torch.from_numpy(arr)


HUGE_PAGE = 2 << 20
_MADV_HUGEPAGE = 14  # <sys/mman.h>


def _huge_zeros(nbytes: int) -> np.ndarray:
    """`nbytes` zero bytes starting on a HUGE_PAGE boundary, madvise'd
    MADV_HUGEPAGE before anything touches them (numpy's large allocations
    are untouched anonymous mappings), then zeroed, which faults them in.
    The advice is a hint: where the host kernel refuses it, the memory is
    the same zeros in whatever pages it gives."""
    span = -(-max(nbytes, 1) // HUGE_PAGE) * HUGE_PAGE
    raw = np.empty(span + HUGE_PAGE, np.uint8)
    off = -raw.ctypes.data % HUGE_PAGE
    libc = ctypes.CDLL(None)
    libc.madvise.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
    libc.madvise(ctypes.c_void_p(raw.ctypes.data + off), span, _MADV_HUGEPAGE)
    arr = raw[off:off + nbytes]
    arr.fill(0)
    return arr


def _unregister(ptr: int):
    torch.cuda.cudart().cudaHostUnregister(ptr)


def _check_table(sh_host: torch.Tensor, name="sh_host"):
    if not torch.is_tensor(sh_host) or sh_host.device.type != "cpu":
        raise ValueError(f"{name} must be a CPU tensor")
    if sh_host.dtype != torch.float32 or sh_host.ndim != 2 or sh_host.shape[1] != COLS:
        raise ValueError(f"{name} must be (C, {COLS}) float32, not "
                         f"{tuple(sh_host.shape)} {sh_host.dtype}")
    if not sh_host.is_contiguous():
        raise ValueError(f"{name} must be C-contiguous")


def gather_rows_pinned_plain(sh_host: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(C, 48) host rows, (n,) integer ids -> (n, 48) rows on the ids'
    device, the plain version: the rows gathered on the host and copied."""
    _check_table(sh_host)
    return sh_host[ids.cpu().long()].to(ids.device)


def _device_address(sh_host: torch.Tensor, device, name="sh_host") -> int:
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
        raise ValueError(f"{name} is not in pinned host memory")
    if err == _NO_DEVICE_POINTER:
        raise RuntimeError(f"{device} cannot address the pinned {name}")
    if err != 0:
        raise RuntimeError(f"cudaPointerGetAttributes failed: cudaError {err}")
    return dev.value + (sh_host.data_ptr() - base)


def gather_rows_pinned_cuda(sh_host: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The same through csrc/pinned_gather.cu: `sh_host` pinned, `ids`
    int32 or int64 on the card, the rows read by the card over the bus into
    a new (n, 48) tensor on the ids' device, on its current stream.

    Replaces hostmem.py:117 PinnedShTable.fetch of the reference. Bound by
    the bytes that cross the bus: a grid of at most GATHER_BLOCKS blocks
    (`pinned_grid`), each a contiguous range of rows, every lane issuing
    3 x 8 16-byte loads before it stores any. The address is
    looked up on every call, as the caller's table is replaced when it
    grows. An id outside [0, C) makes the kernel trap, and the next
    synchronisation raises."""
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
                  int(ids.dtype == torch.int64), n, _build.ptr(out),
                  *_grid(n, dev, GATHER_BLOCKS))
    return out


def gather_rows_pinned(sh_host: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows `ids` of the host table on the ids' device: ids on the card
    launch the kernel, ids on the CPU take the plain version."""
    if ids.device.type == "cuda":
        return gather_rows_pinned_cuda(sh_host, ids)
    return gather_rows_pinned_plain(sh_host, ids)


def _check_n_store(n_store: int, n: int):
    if not 0 <= n_store <= n:
        raise ValueError(f"n_store {n_store} outside [0, {n}]")


def scatter_add_rows_pinned_plain(grad_host: torch.Tensor, rows: torch.Tensor,
                                  ids: torch.Tensor, accumulate: bool = True,
                                  n_store: int = 0):
    """(n, 48) `rows` added into rows `ids` of the (C, 48) host table (stored
    there when not `accumulate`), the plain version: the rows and ids
    brought to the host and `index_add_` (a duplicate id adds each of its
    rows) or an assignment. With `accumulate`, the first `n_store` rows go
    to slots the caller knows to be zero: they are written as 0 + row, the
    bits the add into +0.0 gives (-0.0 included), and not read."""
    _check_table(grad_host, "grad_host")
    ids = ids.cpu().long()
    rows = rows.cpu()
    if not accumulate:
        grad_host[ids] = rows
        return
    _check_n_store(n_store, len(ids))
    if n_store:
        grad_host[ids[:n_store]] = rows[:n_store] + 0.0
    grad_host.index_add_(0, ids[n_store:], rows[n_store:])


def scatter_add_rows_pinned_cuda(grad_host: torch.Tensor, rows: torch.Tensor,
                                 ids: torch.Tensor, accumulate: bool = True,
                                 n_store: int = 0):
    """The same through csrc/pinned_scatter.cu: `grad_host` pinned, `rows`
    (n, 48) float32 and `ids` int32 or int64 on one card, the ids unique
    (the kernel has no atomics: a duplicate id leaves its row undefined).
    The card reads each added row of the table over the bus (not the first
    `n_store`), adds, and writes it back, on the rows' current stream; the
    host may read the rows once that stream's work so far is done (an event
    recorded after the call).

    Replaces hostmem.py:135 PinnedGradBuffer.offload of the reference. A grid
    of at most SCATTER_BLOCKS blocks (`pinned_grid`), every read of a warp's
    step issued before its writes. The address is looked up
    on every call, as the caller's table is replaced when it grows. An id
    outside [0, C) makes the kernel trap, and the next synchronisation
    raises."""
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError("scatter_add_rows_pinned_cuda takes rows on the card")
    _check_table(grad_host, "grad_host")
    if ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"ids have dtype {ids.dtype}, expected int32 or int64")
    n = ids.shape[0]
    _build.require(ids, "ids", ids.dtype, (n,), dev)
    _build.require(rows, "rows", torch.float32, (n, COLS), dev)
    _check_n_store(n_store, n)
    if n == 0:
        return
    table = _device_address(grad_host, dev, "grad_host")
    _build.launch("pinned_scatter", "clmgs_pinned_scatter", _SCATTER_ARGTYPES, dev,
                  ctypes.c_void_p(table), grad_host.shape[0], _build.ptr(ids),
                  int(ids.dtype == torch.int64), n, _build.ptr(rows), int(accumulate),
                  n_store, *_grid(n, dev, SCATTER_BLOCKS))


def scatter_add_rows_pinned(grad_host: torch.Tensor, rows: torch.Tensor, ids: torch.Tensor,
                            accumulate: bool = True, n_store: int = 0):
    """`rows` added into rows `ids` of the host table (the first `n_store`
    into slots known to be zero): rows on the card launch the kernel, rows
    on the CPU take the plain version."""
    if rows.device.type == "cuda":
        return scatter_add_rows_pinned_cuda(grad_host, rows, ids, accumulate, n_store)
    return scatter_add_rows_pinned_plain(grad_host, rows, ids, accumulate, n_store)


class PinnedGradBuffer:
    """(C, 48) float32 SH-gradient accumulator in host memory, fed by
    gradient rows on the card: the D2H direction of the transport
    (hostmem.py:135 of the reference, its kind="pinned_host").

    `offload(g, idx)` adds g[:len(idx)] into rows `idx`: through the kernel,
    on g's current stream, when g is on the card (the table is then
    pinned, `pinned_zeros`), else by the plain version. `reset_rows`
    zeroes rows (the host Adam's consumed rows) and `to_numpy` returns the
    table as a numpy view; both wait for the last offload first. Ids are
    unique within an offload on the card; the plain version also sums
    duplicates."""

    def __init__(self, shape, device="cuda"):
        self.device = torch.device(device)
        self.table = (pinned_zeros(shape) if self.device.type == "cuda"
                      else torch.zeros(shape, dtype=torch.float32))
        self._done = None  # the event behind the last offload on the card

    def _ids(self, idx, device) -> torch.Tensor:
        ids = idx if torch.is_tensor(idx) else torch.from_numpy(
            np.ascontiguousarray(idx, np.int32))
        return ids.to(device)

    def offload(self, g: torch.Tensor, idx):
        n = len(idx)
        if n == 0:
            return
        scatter_add_rows_pinned(self.table, g[:n].contiguous(), self._ids(idx, g.device))
        if g.device.type == "cuda":
            self._done = torch.cuda.Event()
            self._done.record(torch.cuda.current_stream(g.device))

    def _wait(self):
        if self._done is not None:
            self._done.synchronize()
            self._done = None

    def reset_rows(self, idx):
        if len(idx) == 0:
            return
        self._wait()
        self.table[self._ids(idx, "cpu").long()] = 0.0

    def to_numpy(self) -> np.ndarray:
        self._wait()
        return self.table.numpy()
