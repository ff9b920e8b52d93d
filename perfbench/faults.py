"""Faults planted in the program under the check, to show that `correct`
catches them (the tests, and `calibrate.py`'s readings on the chip):

- `unchanged`: every step returns its state unchanged (the port's own
  --stop_update_param);
- `half`: half of each batch left out, the mean taken over the rest;
- `alter`: an answer altered where it is produced: every rendered image
  one 8-bit level brighter, at the compositing's output.

One card holds the whole state, so no exchange between chips can be left
out. `plant` wraps a Program's `step`; the benchmark's own runs never call
it, so the timed path holds no fault-planting code.
"""

from __future__ import annotations


def _half(prog, inner):
    from clm_gs_tpu_torch.data.cameras import CameraBatch

    def step(cams, gt, lrs, timers=None):
        h = max(1, cams.viewmats.shape[0] // 2)
        kept = CameraBatch(cams.viewmats[:h], cams.Ks[:h], cams.camtoworlds[:h],
                           cams.width, cams.height)
        return inner(kept, gt[:h], lrs, timers)

    return step


def _unchanged(prog, inner):
    prog.cfg.debug.stop_update_param = True
    return inner


def _alter(prog, inner):
    from clm_gs_tpu_torch.strategies import base

    def brighter(*args, **kwargs):
        image, alpha, n = orig(*args, **kwargs)
        return image + 1.0 / 255.0, alpha, n

    orig = base.rasterize

    def step(*args, **kwargs):
        base.rasterize = brighter
        try:
            return inner(*args, **kwargs)
        finally:
            base.rasterize = orig

    return step


FAULTS = {"unchanged": _unchanged, "half": _half, "alter": _alter}


def plant(name: str, prog):
    """Plant fault `name` in `prog`: its `step` is replaced by a broken one."""
    prog.step = FAULTS[name](prog, prog.step)
    return prog
