"""Forward fill of int32 channels for the binning expansion: kernel 4.

Semantics of clm_gs_tpu/ops/tiles.py:51-100 ``_forward_fill`` and
ops/fill_pallas.py ``forward_fill_pallas``: slot i of every channel takes the
value at the rightmost slot j <= i whose channel 0 is nonzero, and 0 when
there is none. As in the binning's scatter, the channels are expected to be
zero wherever channel 0 is zero.
"""

from __future__ import annotations

import ctypes

import torch

from clm_gs_tpu_torch import _build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_void_p]
MAX_CHANNELS = 4
# The kernel's look-back flags: one 64-bit word per block of csrc/fill.cu,
# which fills FLAG_SLOTS slots a block (the kernel checks the count). Kept
# per device between calls and never cleared: each call tags its flags with
# a new epoch. Calls on one device share them, so they must run in order on
# one stream. device -> [flags, epoch of the last call].
FLAG_SLOTS = 2048
_FLAGS: dict = {}


def _flags(device, n: int):
    need = -(-n // FLAG_SLOTS)
    st = _FLAGS.get(device)
    if st is None or st[0].numel() < need or st[1] >= 2**32 - 1:
        size = 1 << max(need - 1, 1).bit_length()
        st = _FLAGS[device] = [torch.zeros(size, dtype=torch.int64, device=device), 0]
    st[1] += 1
    return st[0], st[1]


def forward_fill_plain(x: torch.Tensor) -> torch.Tensor:
    """(C, n) int32 -> (C, n) int32, the plain PyTorch version."""
    n = x.shape[1]
    slots = torch.arange(n, device=x.device)
    src = torch.where(x[0] != 0, slots, torch.full_like(slots, -1))
    src = torch.cummax(src, dim=0).values
    out = x[:, src.clamp_min(0)]
    return torch.where(src >= 0, out, torch.zeros_like(out))


def forward_fill_cuda(x: torch.Tensor) -> torch.Tensor:
    """(C, n) int32 on the card -> (C, n) int32 through csrc/fill.cu.

    Replaces ops/fill_pallas.py:35 _fill_kernel of the reference. Bound by
    bytes (one read and one write per slot and channel): one launch, each
    block stages its tile of every channel and some slots before it in
    shared memory, finds the rightmost valid slot before the tile among
    those (or, past them, through the flags of earlier blocks), scans and
    fills in place. Takes 1 to MAX_CHANNELS channels."""
    _build.require(x, "channels", torch.int32)
    if x.dim() != 2 or x.device.type != "cuda":
        raise ValueError("forward_fill_cuda takes a (C, n) CUDA tensor")
    c, n = x.shape
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"forward_fill_cuda takes 1 to {MAX_CHANNELS} channels, not {c}")
    out = torch.empty_like(x)
    if n == 0:
        return out
    if n >= 2**31 - 2**16:
        raise ValueError(f"forward fill of {n} slots exceeds int32 indexing")
    flags, epoch = _flags(x.device, n)
    _build.launch("fill", "clmgs_forward_fill", _ARGTYPES, x.device,
                  _build.ptr(x), _build.ptr(out), n, c, _build.ptr(flags),
                  flags.numel(), epoch)
    return out


def forward_fill(x: torch.Tensor) -> torch.Tensor:
    """(C, n) int32 channels -> filled (C, n). CPU tensors take the plain
    version, CUDA tensors the kernel."""
    if x.device.type == "cuda":
        return forward_fill_cuda(x)
    return forward_fill_plain(x)
