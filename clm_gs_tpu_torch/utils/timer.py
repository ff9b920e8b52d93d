"""Timers (clm_gs_tpu/utils/timer.py).

`Timer` sums keyed spans of host time. Given a `sync` tensor on the card, a
span's edge first waits for the card's current stream, so the span covers
the device work it launched there (and any copy that stream waits for, but
not the rest of a side stream's queue); it does so only when enabled, so a
run without --enable_timer never waits. `End2endTimer` accumulates wall-clock
time outside the eval and save windows.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Optional

import torch


def drain(x) -> None:
    """Wait for the current stream of the card when `x` is a tensor on it."""
    if torch.is_tensor(x) and x.is_cuda:
        torch.cuda.current_stream(x.device).synchronize()


class Timer:
    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.sums = defaultdict(float)
        self.counts = defaultdict(int)
        self._open = {}

    def start(self, key: str, sync=None):
        if not self.enabled:
            return
        drain(sync)
        self._open[key] = time.perf_counter()

    def stop(self, key: str, sync=None):
        if not self.enabled or key not in self._open:
            return
        drain(sync)
        dt = time.perf_counter() - self._open.pop(key)
        self.sums[key] += dt
        self.counts[key] += 1

    def report(self) -> str:
        return "\n".join(
            f"{k}: sum {self.sums[k]*1e3:.2f} ms over {self.counts[k]} calls"
            for k in sorted(self.sums)
        )


class End2endTimer:
    def __init__(self):
        self.total = 0.0
        self._t0: Optional[float] = None

    def start(self):
        if self._t0 is None:
            self._t0 = time.perf_counter()

    def pause(self, sync=None):
        if self._t0 is not None:
            drain(sync)
            self.total += time.perf_counter() - self._t0
            self._t0 = None

    def elapsed(self) -> float:
        out = self.total
        if self._t0 is not None:
            out += time.perf_counter() - self._t0
        return out
