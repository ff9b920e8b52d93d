"""The system under test: `clm_gs_tpu_torch`'s batch entries, driven as its
training CLI drives them (`train.py`'s loop): `strategies/no_offload.py`
`train_step` or `strategies/clm_offload.py` `train_one_batch`, fed camera
batches and targets gathered from a uint8 cache on the card, with the
learning rates of the trainer's schedule under `--lr_scale_mode sqrt`.

`Program` builds the state from the benchmark's scene, runs one batch per
`step`, and reads back what the check compares: the first moments after a
step (the gradient the optimizer got) and the parameters, per leaf.
"""

from __future__ import annotations

import torch

from clm_gs_tpu_torch.config import parse_config
from clm_gs_tpu_torch.data.cameras import CameraBatch
from clm_gs_tpu_torch.models.gaussians import GaussianParams, GaussianState, host_zeros
from clm_gs_tpu_torch.optim import AdamConfig, init_adam, sh_column_lr
from clm_gs_tpu_torch.strategies import clm_offload, no_offload
from clm_gs_tpu_torch.utils.timer import Timer

CARD = ("xyz", "opacity", "log_scale", "quat")


class Program:
    """One training run of the port on the benchmark's scene."""

    def __init__(self, traffic: dict, params: dict, capacity: int, width: int,
                 height: int, device):
        self.device = torch.device(device)
        self.W, self.H = width, height
        self.cfg = parse_config(traffic["flags"])
        self.bsz = self.cfg.opt.bsz
        self.clm = self.cfg.strategy == "clm_offload"
        if self.cfg.strategy not in ("clm_offload", "no_offload"):
            raise ValueError(f"strategy {self.cfg.strategy} has no driver here")
        self.adam_cfg = AdamConfig().scaled(self.bsz, self.cfg.opt.lr_scale_mode)
        self.sh_degree = self.cfg.model.sh_degree
        self.background = torch.zeros(3, device=self.device)
        n = params["xyz"].shape[0]
        dev = self.device

        def rows(x):
            out = torch.zeros((capacity,) + tuple(x.shape[1:]), dtype=torch.float32,
                              device=dev)
            out[:n] = x
            return out

        sh = params["sh"]
        if self.clm:
            sh_host = host_zeros(capacity, 48, dev)
            sh_host[:n].copy_(sh)
            sh = torch.zeros((1, 48), device=dev)
        else:
            sh = rows(sh)
        p = GaussianParams(rows(params["xyz"]), rows(params["opacity"]),
                           rows(params["log_scale"]), rows(params["quat"]), sh)
        z = lambda: torch.zeros(capacity, device=dev)  # noqa: E731
        self.state = GaussianState(p, torch.arange(capacity, device=dev) < n, n, z(), z(), z())
        self.opt = init_adam(p)
        self.ctx = (clm_offload.make_context_from_host(self.cfg, sh_host, self.adam_cfg, dev)
                    if self.clm else None)
        self.n = n

    def lrs(self, rates: dict) -> dict:
        """A batch's learning rates as `train.py` hands them over, from the
        benchmark's `rates` (already scaled by the batch size): the four
        card groups' on the card, the SH columns' (48,) on the host under
        clm_offload."""
        dev = self.device
        out = {k: torch.tensor(rates[k], dtype=torch.float32, device=dev) for k in CARD}
        out["sh"] = sh_column_lr(rates["feature"], device="cpu" if self.clm else dev)
        return out

    def step(self, cams: CameraBatch, gt, lrs, timers=None):
        """One batch; returns the port's StepOut."""
        if self.clm:
            self.state, self.opt, self.ctx, out = clm_offload.train_one_batch(
                self.state, self.opt, self.ctx, cams, gt, self.sh_degree, lrs,
                self.adam_cfg, self.background, self.W, self.H, self.cfg,
                timers=timers if timers is not None else Timer(enabled=False))
            return out
        cfg = self.cfg
        self.state, self.opt, out = no_offload.train_step(
            self.state, self.opt, cams, gt, self.sh_degree, lrs, self.adam_cfg,
            self.background, self.W, self.H, sparse_adam=cfg.aux.sparse_adam,
            accumulate_stats=not cfg.opt.disable_auto_densification,
            lambda_dssim=cfg.opt.lambda_dssim, loss_scale=cfg.opt.lr_scale_loss,
            stop_update_param=cfg.debug.stop_update_param)
        return out

    def leaf(self, name: str, moment: bool = False) -> torch.Tensor:
        """The live rows of a parameter leaf (or of its first moment)."""
        if self.clm and name == "sh":
            t = self.ctx.adam.exp_avg if moment else self.ctx.sh_host
        else:
            t = getattr((self.opt.mu if moment else self.state.params), name)
        return t[:self.n]

    def close(self):
        if self.ctx is not None:
            self.ctx.close()
        self.state = self.opt = self.ctx = None
