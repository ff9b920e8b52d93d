"""Math helpers, schedules and capacity buckets
(clm_gs_tpu/utils/general.py:16-173) and device selection."""

from __future__ import annotations

import math
from typing import Optional

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


def nvidia_smi() -> Optional[str]:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` prints them (first card), or None without it."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=False, timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


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


def build_scaling_rotation(s, q):
    """L = R(q) diag(s), (..., 3, 3); the covariance is L L^T."""
    return build_rotation(q) * s[..., None, :]


def quat_normalize(q):
    return q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)


def strip_symmetric(cov):
    """(..., 3, 3) symmetric -> (..., 6) [xx, xy, xz, yy, yz, zz]."""
    return torch.stack([cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
                        cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]], dim=-1)


def np_sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def drop_duplicate_gaussians(xyz, coeff: float = 1.0) -> np.ndarray:
    """Ascending indices of the unique positions of (N, 3) `xyz` (numpy or a
    tensor) after scaling by `coeff` and rounding to 6 decimals: the first
    row of each group of duplicates (a debug helper)."""
    key = np.round(np.asarray(xyz) * coeff, 6)
    _, idx = np.unique(key, axis=0, return_index=True)
    return np.sort(idx)


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


class StagePeaks:
    """The card's peak allocated bytes split by stage of a run. While on
    (`start`), `enter(stage)` folds the peak since the last call into the
    stage it leaves and into the run's running maximum, then resets the
    card's counter, so `device_peak_bytes` stays the whole run's maximum.
    Off, every call is a no-op. One instance, `STAGES`, which the training
    loop (`train.py`) and the clm strategy mark and `utils/bigcity.py` `run`
    starts."""

    def __init__(self):
        self.on = False
        self.stage = None
        self.peaks = {}
        self.high = 0

    def start(self, stage: str):
        self.on, self.stage, self.peaks, self.high = True, stage, {}, 0

    def _fold(self):
        b = torch.cuda.max_memory_allocated()
        self.peaks[self.stage] = max(self.peaks.get(self.stage, 0), b)
        self.high = max(self.high, b)

    def enter(self, stage: str):
        if self.on and stage != self.stage:
            self._fold()
            torch.cuda.reset_peak_memory_stats()
            self.stage = stage

    def stop(self) -> dict:
        """{stage: peak bytes}; the meter is off after it."""
        if self.on:
            self._fold()
            self.on = False
        return dict(self.peaks)


STAGES = StagePeaks()


def device_peak_bytes() -> int:
    """The card's peak allocated bytes since its counter was last reset
    outside `STAGES` (the running maximum of a split run and the counter)."""
    return max(STAGES.high, torch.cuda.max_memory_allocated())


def memory_report(check_device: bool = False, check_host: bool = False) -> str:
    """--check_gpu_memory / --check_cpu_memory: the card's peak allocated
    bytes (`device_peak_bytes`) and the process's peak RSS
    (`peak_rss_bytes`)."""
    parts = []
    if check_device:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            peak = device_peak_bytes() / 2**30
            live = torch.cuda.memory_allocated() / 2**30
            parts.append(f"device peak {peak:.2f} GB")
            parts.append(f"device live {live:.2f} GB")
        else:
            parts.append("device peak n/a")
    if check_host:
        parts.append(f"host peak rss {peak_rss_bytes() / 2**30:.2f} GB")
    return ", ".join(parts)


def _proc_status_bytes(field: str):
    """A memory field of /proc/self/status in bytes, or None off Linux."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(field + ":"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def peak_rss_bytes() -> int:
    """The process's peak resident set: VmHWM, or getrusage's ru_maxrss off
    Linux. Either may start at the peak of the process that started this
    one (on an H100 host, a run started by a 20 GB process read 20.08 GiB,
    by a small one 5.49), so a peak of one phase is taken by sampling
    `rss_bytes` (utils/bigcity.py)."""
    peak = _proc_status_bytes("VmHWM")
    if peak is None:
        import resource

        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return peak


def rss_bytes() -> int:
    """The process's resident set now (VmRSS; its peak off Linux)."""
    now = _proc_status_bytes("VmRSS")
    return peak_rss_bytes() if now is None else now
