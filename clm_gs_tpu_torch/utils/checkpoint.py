"""Full train-state checkpoints (clm_gs_tpu/utils/checkpoint.py): params,
both Adam moments, the step count, the statistics, the next iteration and
the random generator's state.

The JAX package's layout and key names: `<model_path>/checkpoints/<it>/`
holds `chkpnt.npz` (`params.<f>`, `mu.<f>`, `nu.<f>` for each parameter
group, `alive`, `xyz_grad_accum`, `denom`, `max_radii2d`, `steps`,
`rng_key`), for the offload strategies `strategy_extra.npz` (what the
strategy keeps off the state, e.g. naive_offload's host moments), and
`meta.json`. Every file is written through a temporary name and
`os.replace`, and `meta.json` comes last: it marks a complete checkpoint,
and `latest_checkpoint` skips a directory without it. `rng_key` holds the
state of the port's `torch.Generator` (a uint8 array).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from clm_gs_tpu_torch.models.gaussians import (PARAM_FIELDS, GaussianParams,
                                               GaussianState)
from clm_gs_tpu_torch.optim import AdamState
from clm_gs_tpu_torch.utils.general import check_device

STAT_FIELDS = ("xyz_grad_accum", "denom", "max_radii2d")


def _atomic_savez(path: str, arrays: dict):
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _np(t):
    return t.detach().cpu().numpy()


def save_checkpoint(model_path: str, iteration: int, state: GaussianState,
                    opt_state: AdamState, generator: torch.Generator,
                    extra: Optional[dict] = None,
                    strategy_extra: Optional[dict] = None):
    """Write checkpoint `iteration` (the iteration a resume starts at)."""
    out_dir = os.path.join(model_path, "checkpoints", str(iteration))
    os.makedirs(out_dir, exist_ok=True)
    arrays = {}
    for name in PARAM_FIELDS:
        arrays[f"params.{name}"] = _np(getattr(state.params, name))
        arrays[f"mu.{name}"] = _np(getattr(opt_state.mu, name))
        arrays[f"nu.{name}"] = _np(getattr(opt_state.nu, name))
    arrays["alive"] = _np(state.alive)
    for name in STAT_FIELDS:
        arrays[name] = _np(getattr(state, name))
    arrays["steps"] = _np(opt_state.steps)
    arrays["rng_key"] = generator.get_state().numpy()
    _atomic_savez(os.path.join(out_dir, "chkpnt.npz"), arrays)
    if strategy_extra:
        _atomic_savez(os.path.join(out_dir, "strategy_extra.npz"), strategy_extra)
    meta = {"iteration": iteration, "n_alive": int(state.n_alive)}
    if extra:
        meta.update(extra)
    tmp = os.path.join(out_dir, "meta.json.tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(out_dir, "meta.json"))


def load_checkpoint(path: str, device="cuda") -> Tuple[
        GaussianState, AdamState, torch.Generator, int]:
    """`path` is a checkpoint directory (.../checkpoints/<it>). Returns
    (state, opt_state, generator, next_iteration), on `device`."""
    device = check_device(device)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "chkpnt.npz")) as z:
        t = {k: torch.from_numpy(z[k]).to(device) for k in z.files}

    def grp(prefix):
        return GaussianParams(*(t[f"{prefix}.{f}"] for f in PARAM_FIELDS))

    state = GaussianState(params=grp("params"), alive=t["alive"],
                          n_alive=int(t["alive"].sum()),
                          **{f: t[f] for f in STAT_FIELDS})
    opt = AdamState(mu=grp("mu"), nu=grp("nu"), steps=t["steps"])
    generator = torch.Generator(device=device)
    generator.set_state(t["rng_key"].cpu())
    return state, opt, generator, meta["iteration"]


def latest_checkpoint(model_path: str) -> Optional[str]:
    """Newest complete checkpoint directory (one with meta.json and
    chkpnt.npz), or None."""
    root = os.path.join(model_path, "checkpoints")
    if not os.path.isdir(root):
        return None
    for it in sorted((int(d) for d in os.listdir(root) if d.isdigit()),
                     reverse=True):
        d = os.path.join(root, str(it))
        if os.path.exists(os.path.join(d, "meta.json")) and os.path.exists(
                os.path.join(d, "chkpnt.npz")):
            return d
    return None
