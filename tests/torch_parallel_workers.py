"""Rank processes for the port's multi-process tests (test_torch_parallel.py,
test_torch_parallel_cli.py).

`launch` starts `world` spawned processes on the CPU, each running
`fn(rank, world, port, *args)` with one thread, and returns their results in
rank order. This module and what it imports load no JAX: the spawned
processes import it, and the parent passes them numpy inputs.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist

from clm_gs_tpu_torch import convert, optim
from clm_gs_tpu_torch.parallel.mesh import (gather_capacity_tree, make_mesh,
                                            shard_capacity_tree, shard_state)
from clm_gs_tpu_torch.parallel.shard import make_sharded_train_step

FIELDS = ("xyz", "opacity", "log_scale", "quat", "sh")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(fn, rank, world, port, args, results):
    torch.set_num_threads(1)
    try:
        results.put((rank, True, fn(rank, world, port, *args)))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def launch(fn, world: int, *args, timeout: float = 240.0):
    """fn(rank, world, port, *args) in `world` processes; a worker's failure
    or the timeout stops them all and raises."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry, args=(fn, r, world, port, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(out) + len(errors) < world:
            try:
                rank, ok, value = results.get(timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                raise TimeoutError(f"{world - len(out)} of {world} ranks still running "
                                   f"after {timeout} s") from None
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                break
        if errors:
            raise RuntimeError("\n".join(errors))
    finally:
        for p in procs:
            p.join(timeout=0 if errors or len(out) < world else 30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return [out[r] for r in range(world)]


def init_gloo(rank, world, port):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))


def sharded_steps(rank, world, port, meshes, cases):
    """For each mesh shape, each case {"state", "opt", "cams", "gts",
    "sparse_adam", "lrs", "sh_degree"} (numpy) through the sharded step:
    the gathered state and moments, the step's outputs and the row counts of
    this rank's shard."""
    init_gloo(rank, world, port)
    try:
        out = {}
        for shape in meshes:
            mesh = make_mesh(shape, "cpu")
            for name, case in cases.items():
                state = convert.state_from_numpy(case["state"], "cpu")
                opt = convert.adam_from_numpy(case["opt"], "cpu")
                cap = state.capacity
                state = shard_state(state, mesh)
                opt = shard_capacity_tree(opt, mesh, cap)
                rows = {f"{g}.{f}": getattr(p, f).shape[0] for f in FIELDS
                        for g, p in (("params", state.params), ("mu", opt.mu),
                                     ("nu", opt.nu))}
                rows.update(alive=state.alive.shape[0], denom=state.denom.shape[0],
                            xyz_grad_accum=state.xyz_grad_accum.shape[0])
                step = make_sharded_train_step(mesh, case["cams"]["width"],
                                               case["cams"]["height"],
                                               sparse_adam=case["sparse_adam"])
                lrs = {k: torch.tensor(v) for k, v in case["lrs"].items()}
                s, o, res = step(state, opt, convert.cameras_from_numpy(case["cams"], "cpu"),
                                 torch.from_numpy(case["gts"]), case["sh_degree"], lrs,
                                 optim.AdamConfig(), torch.zeros(3))
                local = s.capacity
                out[shape, name] = {
                    "state": convert.state_to_numpy(gather_capacity_tree(s, mesh, local)),
                    "opt": convert.adam_to_numpy(gather_capacity_tree(o, mesh, local)),
                    "losses": res.losses.numpy(), "n_isects": res.n_isects,
                    "max_isects": res.max_isects, "max_shard_vis": res.max_shard_vis,
                    "visible_any": gather_capacity_tree(res.visible_any, mesh,
                                                        local).numpy(),
                    "rows": rows, "mesh": mesh.shape,
                    "index": (mesh.data_index, mesh.gauss_index),
                }
        return out
    finally:
        dist.destroy_process_group()


def cli_runs(rank, world, port, runs):
    """The port's `main` once for each (argv, env) of `runs`, on the CPU,
    with "{rank}" in them replaced by the rank; each run starts and ends its
    own process group (from the --dist_* flags in argv, or from the torchrun
    variables in env). Returns per run the final state's capacity and
    n_alive, or the NotImplementedError's message, and whether a process
    group was left behind."""
    import os

    from clm_gs_tpu_torch.train import main

    out = []
    for argv, env in runs:
        argv = [a.format(rank=rank) for a in argv]
        old = {k: os.environ.get(k) for k in env}
        os.environ.update({k: v.format(rank=rank) for k, v in env.items()})
        try:
            state, _ = main(argv, device="cpu")
            out.append({"n_alive": state.n_alive, "capacity": state.capacity,
                        "group_left": dist.is_initialized()})
        except NotImplementedError as e:
            out.append({"raised": type(e).__name__, "message": str(e),
                        "group_left": dist.is_initialized()})
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v
    return out
