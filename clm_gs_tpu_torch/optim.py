"""Adam for Gaussian training (clm_gs_tpu/optim.py:35-132).

Per-group learning rates (the sh group per column: dc at feature_lr, rest at
feature_lr/20), eps 1e-15, betas (0.9, 0.999), an optional selective mode
(rows outside ``update_mask`` keep params and moments) and the reference's
batch-size scaling rules. ``adam_step`` is functional: it returns new tensors
and leaves its inputs untouched.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict

import torch

from clm_gs_tpu_torch.models.gaussians import PARAM_FIELDS, GaussianParams


@dataclass(frozen=True)
class AdamConfig:
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-15

    def scaled(self, bsz: int, mode: str) -> "AdamConfig":
        """The reference's bsz scaling of eps/betas ("sqrt" mode)."""
        if mode == "sqrt":
            return AdamConfig(
                betas=tuple(b**bsz for b in self.betas), eps=self.eps / (bsz**0.5)
            )
        return self


def lr_batch_scale(bsz: int, mode: str) -> float:
    if mode == "sqrt":
        return bsz**0.5
    if mode == "linear":
        return float(bsz)
    return 1.0


@dataclass(frozen=True)
class AdamState:
    mu: GaussianParams
    nu: GaussianParams
    steps: torch.Tensor  # () float32 global step count


def init_adam(params: GaussianParams) -> AdamState:
    """Zero moments; mu and nu are distinct buffers."""
    return AdamState(
        mu=GaussianParams(*(torch.zeros_like(t) for t in params.astuple())),
        nu=GaussianParams(*(torch.zeros_like(t) for t in params.astuple())),
        steps=torch.zeros((), dtype=torch.float32, device=params.xyz.device),
    )


def sh_column_lr(feature_lr: float, capacity_cols: int = 48, device="cuda"):
    """(48,) per-column LR for the sh array: dc at feature_lr, rest /20."""
    lr = torch.full((capacity_cols,), feature_lr / 20.0, dtype=torch.float32,
                    device=device)
    lr[0:3] = feature_lr
    return lr


@torch.no_grad()
def adam_step(
    params: GaussianParams,
    grads: GaussianParams,
    state: AdamState,
    lrs: Dict[str, torch.Tensor],
    cfg: AdamConfig,
    update_mask: torch.Tensor,
):
    """One (optionally selective) Adam step; returns (new_params, new_state).

    lrs: {"xyz", "opacity", "log_scale", "quat": scalar, "sh": (48,)};
    a group without a rate keeps its parameters and moments (clm_offload's
    SH placeholder); update_mask: (C,) bool rows to update.
    """
    b1, b2 = cfg.betas
    steps = state.steps + 1.0
    bc1 = torch.clamp_min(1.0 - torch.pow(b1, steps), 1e-30)
    bc2 = torch.clamp_min(1.0 - torch.pow(b2, steps), 1e-30)

    new_p, new_m, new_v = {}, {}, {}
    for name in PARAM_FIELDS:
        p = getattr(params, name)
        m = getattr(state.mu, name)
        v = getattr(state.nu, name)
        if name not in lrs:
            new_p[name], new_m[name], new_v[name] = p, m, v
            continue
        g = getattr(grads, name)
        maskb = update_mask.reshape((p.shape[0],) + (1,) * (p.ndim - 1))
        m_new = torch.where(maskb, b1 * m + (1 - b1) * g, m)
        v_new = torch.where(maskb, b2 * v + (1 - b2) * g * g, v)
        step = lrs[name] * (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        new_p[name] = torch.where(maskb, p - step, p)
        new_m[name], new_v[name] = m_new, v_new

    return (
        GaussianParams(**new_p),
        AdamState(mu=GaussianParams(**new_m), nu=GaussianParams(**new_v),
                  steps=steps),
    )


def _zero_where(x, mask):
    """x with the masked rows zeroed; a host-kept group's (1, cols)
    placeholder (x.shape[0] != C) passes through."""
    if x.shape[0] != mask.shape[0]:
        return x
    bshape = (x.shape[0],) + (1,) * (x.ndim - 1)
    return torch.where(mask.reshape(bshape), torch.zeros_like(x), x)


def zero_rows(state: AdamState, mask: torch.Tensor) -> AdamState:
    """Zero both moments at the masked rows (optimizer-state surgery on
    densify and prune)."""
    return AdamState(
        mu=GaussianParams(*(_zero_where(x, mask) for x in state.mu.astuple())),
        nu=GaussianParams(*(_zero_where(x, mask) for x in state.nu.astuple())),
        steps=state.steps,
    )


def zero_opacity_rows(state: AdamState, mask: torch.Tensor) -> AdamState:
    """Opacity reset: only the opacity group's moments are cleared."""
    return replace(
        state,
        mu=replace(state.mu, opacity=_zero_where(state.mu.opacity, mask)),
        nu=replace(state.nu, opacity=_zero_where(state.nu.opacity, mask)),
    )
