"""Process bootstrap for multi-GPU training (clm_gs_tpu/parallel/multihost.py).

One process per card, joined by torch.distributed: NCCL on the card, gloo
when the caller asks for the CPU. A run starts its process group from the
JAX package's flags,

    python -m clm_gs_tpu_torch.train ... --dist_coordinator HOST:PORT \\
        --dist_num_processes N --dist_process_id I

or from the environment torchrun sets (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
`MASTER_ADDR`, `MASTER_PORT`):

    torchrun --nproc_per_node N -m clm_gs_tpu_torch.train ... --mesh_shape AxB

Each rank trains on `cuda:LOCAL_RANK` (with the flags, the process id modulo
the host's card count). Every rank builds the same batches from the same
seed; rank 0 alone writes the run's files.
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist

from clm_gs_tpu_torch.utils.general import check_device


def maybe_initialize(cfg, device="cuda") -> bool:
    """Start the process group the config or the environment asks for,
    before anything touches the card. Returns whether one was started: False
    when neither asks for one, or when the caller already started a group,
    which is then used as it is and left to the caller to destroy."""
    device = check_device(device)
    t = cfg.tpu
    env = os.environ
    if dist.is_initialized():
        return False
    if t.dist_coordinator or t.dist_num_processes > 1:
        if not t.dist_coordinator:
            raise ValueError("--dist_num_processes needs --dist_coordinator HOST:PORT")
        world = max(t.dist_num_processes, 1)
        rank = t.dist_process_id if world > 1 else max(t.dist_process_id, 0)
        if not 0 <= rank < world:
            raise ValueError(f"--dist_process_id {t.dist_process_id} is not a rank "
                             f"of {world} processes")
        init = f"tcp://{t.dist_coordinator}"
        local = rank % torch.cuda.device_count() if device.type == "cuda" else rank
    elif "RANK" in env and "WORLD_SIZE" in env:
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        init = "env://"
        local = int(env.get("LOCAL_RANK", rank))
    else:
        return False
    if device.type == "cuda":
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", init_method=init, world_size=world, rank=rank,
                                device_id=torch.device("cuda", local))
    else:
        dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    return True


def fully_replicated_host_value(x):
    """Host copy of a tensor that every rank holds in full (the step's
    losses, all-gathered over the data axis): this rank's copy is the value."""
    return x.detach().cpu().numpy()


def is_rank0() -> bool:
    """Whether this process writes the run's files: rank 0 of the process
    group, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


@contextlib.contextmanager
def rank0_first():
    """Rank 0 runs the block first, the other ranks after it: they then find
    the files it wrote (the decoded image cache) complete."""
    if not dist.is_initialized():
        yield
        return
    if not is_rank0():
        dist.barrier()
    yield
    if is_rank0():
        dist.barrier()
