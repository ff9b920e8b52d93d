"""Timers (clm_gs_tpu/utils/timer.py).

`Timer` sums keyed spans of host time and is the port's one tracer. Given a
`sync` tensor on the card, a span's edge first waits for the card's current
stream, so the span covers the device work it launched there (and any copy
that stream waits for, but not the rest of a side stream's queue); it does
so only when enabled, so a run without --enable_timer never waits.

While a `torch.profiler` session is active, every span, of an enabled Timer
or not, also opens a profiler range of its name (category
`user_annotation` in the Chrome trace), so the spans sit in the device
trace on its clock, nested as the calls nest. The root span of a batch
(`batch_span`) numbers the batches this Timer opened under a profiler and
gives its range that number as its argument, as does a span of that batch
on another thread (clm's host Adam), so the batch's spans share an
identifier. Arguments show in a trace that records inputs
(`record_shapes`). With neither a profiler nor an enabled Timer, a span
edge tests two flags and returns: no range, no allocation, no tensor op,
no read-back.

`OFF`, a disabled Timer, carries the spans of code that is given no Timer
(`strategies/base.py`, `no_offload.py`, `offload_common.py`,
`ops/rasterize.py`).
`End2endTimer` accumulates wall-clock time outside the eval and save
windows.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Optional

import torch
from torch.autograd import profiler as _profiler


def drain(x) -> None:
    """Wait for the current stream of the card when `x` is a tensor on it."""
    if torch.is_tensor(x) and x.is_cuda:
        torch.cuda.current_stream(x.device).synchronize()


class _Span:
    """`with timer.span(key)`: the edges of one span."""

    __slots__ = ("timer", "key", "args")

    def __init__(self, timer, key, args):
        self.timer, self.key, self.args = timer, key, args

    def __enter__(self):
        self.timer._start(self.key, None, self.args)

    def __exit__(self, *exc):
        self.timer._stop(self.key, None)


# the span of a disabled Timer with no profiler active
_NO_SPAN = contextlib.nullcontext()


class Timer:
    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.sums = defaultdict(float)
        self.counts = defaultdict(int)
        self._open = {}
        # the profiler ranges open, by span name
        self._range_open = {}
        # batches whose root span this Timer opened under a profiler
        self.batch = 0

    def start(self, key: str, sync=None):
        self._start(key, sync, ())

    def stop(self, key: str, sync=None):
        self._stop(key, sync)

    def span(self, key: str, *args: int):
        """A context manager for the span `key` (no drain at its edges);
        under a profiler its range carries the ints `args`."""
        if not (self.enabled or _profiler._is_profiler_enabled):
            return _NO_SPAN
        return _Span(self, key, args)

    def batch_span(self, key: str):
        """`span` for the root span of a batch: under a profiler its range
        carries the batch's number, `self.batch`, counted from 1 over the
        batches this Timer opened under one."""
        if not _profiler._is_profiler_enabled:
            return self.span(key)
        self.batch += 1
        return _Span(self, key, (self.batch,))

    # `span` enters here, not through `start`, so that a subclass's
    # `start(key, sync)` is never handed range arguments
    def _start(self, key, sync, args):
        if self.enabled:
            drain(sync)
            self._open[key] = time.perf_counter()
        if _profiler._is_profiler_enabled:
            # a range named `key` with the ints `args` as its arguments
            self._range_open[key] = torch._C._autograd._record_function_with_args_enter(
                key, *args)

    def _stop(self, key, sync):
        if self.enabled and key in self._open:
            drain(sync)
            dt = time.perf_counter() - self._open.pop(key)
            self.sums[key] += dt
            self.counts[key] += 1
        if self._range_open:
            handle = self._range_open.pop(key, None)
            if handle is not None:
                torch._C._autograd._record_function_with_args_exit(handle)

    def report(self) -> str:
        return "\n".join(
            f"{k}: sum {self.sums[k]*1e3:.2f} ms over {self.counts[k]} calls"
            for k in sorted(self.sums)
        )


OFF = Timer(enabled=False)


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
