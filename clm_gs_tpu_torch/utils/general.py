"""Math helpers, schedules and capacity buckets
(clm_gs_tpu/utils/general.py:16-173) and device selection."""

from __future__ import annotations

import math

import numpy as np
import torch


def check_device(device) -> torch.device:
    """The device a constructor builds on. CUDA is the default everywhere in
    the package; asking for it without a card raises instead of moving
    quietly to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


def build_rotation(q):
    """Unnormalized quaternion (..., 4) [w, x, y, z] -> rotation (..., 3, 3)."""
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r0 = torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1
    )
    r1 = torch.stack(
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1
    )
    r2 = torch.stack(
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1
    )
    return torch.stack([r0, r1, r2], dim=-2)


def psnr(img, gt):
    mse = torch.mean((img - gt) ** 2)
    return -10.0 * torch.log10(mse)


def get_expon_lr_func(
    lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0, max_steps=1000000
):
    """Exponential log-linear LR schedule with an optional sine-delay warmup.
    The returned function of the step computes in float32, as the reference
    does, and returns a numpy float32."""
    f32 = np.float32

    def helper(step):
        step = f32(step)
        if lr_delay_steps > 0:
            delay_rate = f32(lr_delay_mult) + f32(1 - lr_delay_mult) * np.sin(
                f32(0.5 * np.pi) * np.clip(step / f32(lr_delay_steps), f32(0), f32(1))
            )
        else:
            delay_rate = f32(1.0)
        t = np.clip(step / f32(max_steps), f32(0), f32(1))
        log_lerp = np.exp(
            np.log(f32(max(lr_init, 1e-30))) * (f32(1) - t)
            + np.log(f32(max(lr_final, 1e-30))) * t
        )
        if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
            return f32(0.0)
        return f32(delay_rate * log_lerp)

    return helper


def check_update_at_this_iter(iteration, bsz, interval, offset=0):
    """Does an interval boundary (k*interval + offset) fall inside
    [iteration, iteration+bsz)?"""
    left = iteration - offset
    right = iteration + bsz - offset
    return math.ceil(left / interval) < math.ceil(right / interval)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def next_capacity(n: int, granule: int = 65536, headroom: float = 1.25) -> int:
    """Bucketed capacity for n live Gaussians: {1, 1.5} * 2^k granules at
    least n * headroom."""
    want = max(int(n * headroom), granule)
    k = max(0, math.ceil(math.log2(max(1.0, want / granule))))
    for cand_mult in (2 ** (k - 1) * 1.5, 2**k, 2**k * 1.5):
        cap = int(granule * cand_mult)
        if cap >= want:
            return round_up(cap, granule)
    return round_up(int(granule * 2 ** (k + 1)), granule)


def memory_report(check_device: bool = False, check_host: bool = False) -> str:
    """--check_gpu_memory / --check_cpu_memory: the card's peak allocated
    bytes (torch.cuda.max_memory_allocated) and the process's peak RSS."""
    parts = []
    if check_device:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            peak = torch.cuda.max_memory_allocated() / 2**30
            live = torch.cuda.memory_allocated() / 2**30
            parts.append(f"device peak {peak:.2f} GB")
            parts.append(f"device live {live:.2f} GB")
        else:
            parts.append("device peak n/a")
    if check_host:
        import resource

        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        parts.append(f"host peak rss {rss:.2f} GB")
    return ", ".join(parts)
