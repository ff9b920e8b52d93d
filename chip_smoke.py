#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (clm_gs_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--out DIR]

Phases, one JSON line each:
  1. device: the card's name and power limit (nvidia-smi), then an nvcc build
     of the seven kernels from csrc/, one process per source.
  2. kernels_mid: each kernel against its plain PyTorch version at a mid
     size (20,000 Gaussians, one 640x480 camera), and the kernel-path
     rasterizer against the dense oracle on a small scene.
  3. train_step_mid: one no_offload train_step on the card (kernel path)
     against the same step on the CPU (plain path).
  4. full: the bench scene, 1,000,000 Gaussians in a capacity of 1,048,576
     (SH degree 3), 4 cameras at 1237x822: one warm-up step and 3 timed
     train_steps, with each kernel's launch count over the timed steps.
  4b. micro_group: on phase 4's state, from seeded moments, one train_step
     with micro_group=B (projection and SH batched over the 4 cameras,
     compositing per camera, one backward of the summed losses) against the
     one-camera step: losses, parameter moves and first moments within
     train_step_mid's tolerances, each step's seconds and peak memory.
  5. kernels: each kernel against its plain version at the full-width
     shapes of camera 0, with times, bounds and (segment reduce) the time of
     one PyTorch call computing the same function; the backward and segment
     reduce are also held to identical output over two launches, and each
     compositing kernel reports the (instance, pixel) slots its block shapes
     walk. At the mid size, fill is also held exactly to its plain version
     on channels whose only valid slot is the first, with n % 4 == 3.
  5b. visibility: clm's visibility kernel (csrc/visibility.cu) against its
     plain version, bit for bit at radius_clip 0 and 1.5, at bicycle's
     shapes (phase 4's rows and its 4 cameras of 1237x822) and at BigCity's
     (one FILTER_CHUNK_ROWS chunk of city rows at the 25M scene's spacing,
     64 street cameras of 1600x900): the kernel's time, its bound (the
     operations these rows need: the pairs between the planes by the
     view's depth) and the plain version's time. The phases that run clm
     report its launches.
  6. naive_step, on phase 4's scene: from one state with the same seeded
     moments on the card and on the host, one naive_offload.train_one_batch
     (parameters and moments on the host, the host Adam of
     csrc/host/cpu_adam.cpp, built by g++ in phase 1) against one
     no_offload.train_step: losses and parameter moves, the times, the
     naive.grads / naive.d2h_adam split, and the device memory left after
     the batch, which must be below the parameters' bytes (the device copy
     was freed).
  6b. clm_step, on the state phase 6 leaves: from the same seeded moments,
     clm_offload.train_one_batch (SH rows and moments on the host, the
     camera order of csrc/host/fast_tsp.cpp) with retention, without it,
     and with retention and --pinned_host's card-side gather and gradient
     scatter (csrc/pinned_gather.cu, csrc/pinned_scatter.cu), against one
     no_offload.train_step: losses (sorted, as the TSP reorders the
     cameras), parameter moves and first moments, retention against the
     full re-gather, the card-side path against the host path to the bit
     (losses, parameters, first moments, the host SH rows) with the same
     bytes but the arriving rows' ids, a flush's permutation and the
     gradient rows the scatter reads back for its add (all but the first
     departures, which it stores into zero slots), the
     bytes of the clm state and card moments against no_offload's (at least
     the SH parameters' and their two moments' less), and for each: a first
     batch, five warm ones taken in turns with the other variants (the
     median's batch time, bytes each way, the overlap meter) and one under
     --enable_timer's spans. Then the gather kernel against its
     plain version on camera 0's visible rows, bit-equal, timed beside the
     host-staged fetch it replaces and bounded by the pinned host-to-card
     copy rate measured in the same call; and the scatter kernel on the
     same rows, adding, storing, and adding with the first half stored into
     zero slots, bit-equal over the whole pinned table, timed beside the
     download and host scatter it replaces, with the card-to-pinned copy
     rate. Each reports its grid (blocks of the SMs), its share of its
     bound and 20 matmuls' time beside it against alone (timing, not
     gated).
  6c. mesh_step: a world-1 NCCL process group and a 1x1 (data x gauss) mesh
     on a fresh copy of phase 4's scene: from the same seeded moments, one
     step of parallel/shard.py's sharded step (compact visible rows, the
     gather over the gauss group, the four kernels) against one
     no_offload.train_step: losses, parameter moves, first moments,
     xyz_grad_accum (and its increment's ratio, 1 where the JAX package's
     is n_gauss) and denom; then 5 timed steps of each, peak device memory
     and the bytes of a rank's state and moments, each kernel's launches
     over the sharded steps. On a host with 2 or more cards the same check
     runs at 1x2 and 2x1 (and 2x2 with 4) in spawned NCCL processes, one a
     card, with each rank's peak memory; otherwise the phase prints a line
     that only world 1 ran, and why.
  6d. clm_mesh_step: a world-1 NCCL process group and a 1x1 mesh on a fresh
     copy of phase 4's scene: from the same seeded moments (the SH ones on
     the host), one clm_offload.train_one_batch on the mesh (the state, card
     moments and host SH rows cut to the rank's gauss shard, the compact
     rows gathered over the gauss group) against one on this process alone:
     losses, parameter moves and first moments (the host SH rows' and
     moments' included), xyz_grad_accum and its increment's ratio, denom,
     visibility and instance counts; the mesh batch with --pinned_host
     (both pinned kernels launched) to the bit; then 3 batches of each in turns, timed, with peak device
     memory, a rank's host and card bytes and each kernel's launches over
     the first mesh batch. On a host with 2 or more cards the same check
     runs at 1x2 and 2x1 (and 2x2 with 4) in spawned NCCL processes, with
     the data sum's ms and bytes a batch (two camera chains where the data
     axis is 2).
  6e. bench4k: a fresh bench scene at 3840x2160 (60x68 tiles of 64x32;
     clm_gs_tpu_torch/utils/bench4k.py): one warm-up train_step and 3 timed
     ones (finite losses, Mpix/s, s/batch, peak device memory, each
     camera's instances, each kernel's launches over the timed steps), then
     each kernel against its plain version on camera 0's 4K shapes, timed
     and bounded, within the full-width tolerances.
  7. cli: the bench scene's 1M Gaussians written as a COLMAP scene (32
     cameras of 1237x822, utils/synthetic_colmap.py). A short run to the
     first densification round reports the rows each gradient threshold
     would add there. Then the CLI's main trains the scene with
     FULL_TRAIN_ARGS: 200 iterations, densification past the first
     capacity, an opacity reset, eval, a PLY and a checkpoint, with each
     kernel's launch count over the run and the --enable_timer spans of
     its loop. Each kernel is held against its plain version on the final
     state seen by a train camera (segment reduce over the grown
     capacity). Then `python -m clm_gs_tpu_torch.train` resumes from the
     checkpoint. Checks the losses, the growth, the PSNR, the PLY against
     the final state, release_scripts/log2csv.py on the run, the resume,
     and the fill after its flags regrow.
  8. naive: the CLI's main with FULL_TRAIN_ARGS under --naive_offload on
     phase 7's scene and decoded images: growth past the first capacity, an
     opacity reset, a final test PSNR within 0.5 dB of phase 7's, the PLY,
     each kernel's launches, a device peak below phase 7's; then a resume
     from its checkpoint with `python -m clm_gs_tpu_torch.train
     --naive_offload`, which restores the host moments from
     strategy_extra.npz.
  9. clm: the same under --clm_offload (the default strategy): growth, a
     reset, the PSNR within 0.5 dB of phase 7's, the PLY against the final
     state, each kernel's launches, a device peak below phase 7's (beside
     phase 8's), the `clm overlap:` line, the bytes each way a batch and the
     clm spans; then a resume from its checkpoint with `python -m
     clm_gs_tpu_torch.train --clm_offload --pinned_host` (through runpy,
     which then prints the run's kernel launches), which restores the host
     SH rows and moments from strategy_extra.npz into new pinned buffers
     that the card gathers from and scatters into: its log says so, its test
     PSNR rises and both pinned kernels launched.
  9b. mesh: the CLI's main with FULL_TRAIN_ARGS on phase 7's scene, started
     as a process group of one by the --dist_* flags with --mesh_shape 1x1
     (the sharded step, densification and growth on the whole state, eval,
     the PLY and checkpoint gathered): the mesh line, growth, a reset, the
     final test PSNR within 0.1 dB of phase 7's, the PLY against the final
     state, each kernel's launches, the process group destroyed; then a
     resume from its checkpoint to iteration 120 with `python -m
     clm_gs_tpu_torch.train` on one card, without a process group.
  9c. clm_mesh: the same under --clm_offload: the clm run on a 1x1 mesh (the
     host SH rows and moments gathered and cut again at each densification,
     timed by the `mesh.gather`, `clm.host_gather` and `clm.host_shard`
     spans), its final test PSNR within 0.1 dB of phase 9's, the PLY
     against the final state, each kernel's launches, the process group
     destroyed; then a resume from its checkpoint to iteration 120 with
     `python -m clm_gs_tpu_torch.train --clm_offload` on one card.
 10. trajectory: `python -m clm_gs_tpu_torch.render_trajectory` (through
     runpy) on phase 9's final PLY with phase 7's training cameras, 8
     frames of 1280x720 and --topdown, under --no_offload and
     --clm_offload (the top-down view is best-effort: it is written only
     where matplotlib is installed, and the phase records whether it was
     and why): every frame with structure, consecutive frames apart,
     the two runs' frames within one level, frame 0 of both as floats in
     this process within 1e-5 relative and 1e-6 absolute, frames/s, peak
     device memory and the forward and fill launches of each run.
 10b. parity: the JAX repo's strategy-parity scene (48 cameras of 320x240,
     seed 3; clm_gs_tpu_torch/utils/parity30k.py) trained under each of the
     three strategies, a process each, the three at once sharing the card,
     with its schedule cut to PARITY_ITERS iterations
     (densification from 500, an eval every 1,000): each offload strategy's test PSNR within 0.5 dB of
     no_offload's at every eval, test PSNR rising from the first eval to
     the last, finite losses, every kernel launched, and the process's RSS
     at each eval.
 11. bigcity: the reference's BigCity regime at its 25M size
     (clm_gs_tpu_torch/utils/bigcity.py, each step a process of its own):
     `make` draws 25,000,000 city Gaussians, renders 64 cameras of 640x400
     on the card and writes the degraded init PLY (started before phase 7,
     so that its host work overlaps phases 7-10b); `run` trains it with
     BIGCITY_ARGS (bsz 64, --sparse_adam, no densification) for 128
     iterations under --clm_offload, a test eval at its end, then times
     one batch of the final state in situ against
     clm_offload.prepare_device_loop's replay (the card's share) and one
     more on the host path against the same batch with --pinned_host from
     one start (bit-equal; its seconds, clm.d2h_scatter and clm.advance
     beside the host path's), and under --no_offload; each run's peak device memory split by stage
     (`peak_by_stage`: set-up, the loop, the clm filters, order, micro
     loop and Adam tail, eval, the end). Gates: finite losses, clm's test
     PSNR above the init's and within 0.5 dB of no_offload's, clm's peak
     device memory below no_offload's and at most 198 bytes a row of the
     capacity and 1.5 GiB, the host state 768 bytes a row, the load's host
     peak within the host state plus 2 GiB, the replay's last loss equal to
     the in-situ batch's to the bit, every kernel launched; then, on the
     init PLY's state, the in-place Adam tail bit-equal to adam_step on a
     slice of 6M rows, the row-chunked filters' ids, counts and sample
     equal to the unchunked pass for two cameras, and each kernel against
     its plain version on the first training camera's visible rows (the
     scatter into a pinned table of the whole capacity). The summary and
     kernels lines follow it.
The summary line also gives each phase's seconds (`phase_s`) and the
script's (`total_s`). Any failed check exits 1. The last line is the device
summary. Without CUDA,
or without the package beside it, the script exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import csv
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 FLOP/s outside
# the tensor cores; both at the full 700 W power limit.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# the card's host link (NVIDIA data sheet): PCIe Gen5 x16, 128 GB/s both
# ways, so 64 GB/s host to card
PEAK_PCIE_H2D = 64e9
# float32 operations per (instance, pixel) pair, counted from the kernels'
# source (an FMA is two, exp one), by how far the pair goes through the
# tests of csrc/raster_common.cuh: past the row's staged sigma cut (the
# offsets, the quadratic form and a compare, 12), sigma < 0 (13), or
# alpha < 1/255 after exp, op * vis, the clamp and the compare (17); a
# composited pair adds the forward's transmittance and colour sums (11,
# rasterize_fwd.cu) or the backward's replayed weight and its 9 gradient
# terms (46, rasterize_bwd.cu).
OPS_CUT = 12
OPS_CULLED = 13
OPS_TESTED = 17
OPS_COMPOSITED = {"fwd": OPS_TESTED + 11, "bwd": OPS_TESTED + 46}
KINDS = ("cut", "culled", "tested", "composited")
# about 1 ms of the card's clock: longer than the host takes to queue the
# timed launches of a short kernel
SLEEP_CYCLES = 2_000_000

KERNELS = {
    "fill": ("clm_gs_tpu_torch/csrc/fill.cu", "clm_gs_tpu/ops/fill_pallas.py:35"),
    "segreduce": ("clm_gs_tpu_torch/csrc/segreduce.cu",
                  "clm_gs_tpu/ops/segreduce.py:45"),
    "rasterize_fwd": ("clm_gs_tpu_torch/csrc/rasterize_fwd.cu",
                      "clm_gs_tpu/ops/rasterize.py:321"),
    "rasterize_bwd": ("clm_gs_tpu_torch/csrc/rasterize_bwd.cu",
                      "clm_gs_tpu/ops/rasterize.py:372"),
}
# The --pinned_host SH gather: a kernel of the port whose JAX counterpart is
# an XLA host-space gather program, not a Pallas kernel.
GATHER = "pinned_gather"
GATHER_SOURCE = ("clm_gs_tpu_torch/csrc/pinned_gather.cu", "clm_gs_tpu/utils/hostmem.py:117")
# Its other half, the SH-gradient scatter-add into pinned memory, whose JAX
# counterpart is an XLA host-space scatter-add program.
SCATTER = "pinned_scatter"
SCATTER_SOURCE = ("clm_gs_tpu_torch/csrc/pinned_scatter.cu",
                  "clm_gs_tpu/utils/hostmem.py:135")
# clm's visibility pass: a kernel of the port that replaces no Pallas
# kernel, as the JAX package's calculate_filters is fused by XLA.
VISIBILITY = "visibility"
VISIBILITY_SOURCE = ("clm_gs_tpu_torch/csrc/visibility.cu",
                     "none: clm_gs_tpu/strategies/offload_common.py calculate_filters "
                     "is XLA-fused")
# its float32 operations, counted from its source (a division, square
# root, rsqrt, exp, ceil, clamp or compare one): a live row's rotation and
# world covariance (106), a (live row, camera) pair's view transform and
# plane tests (20), and the rest of a pair between the planes (150); and the
# bytes a row reads (xyz, quat, log_scale, alive)
OPS_VIS_ROW = 106
OPS_VIS_PAIR = 20
OPS_VIS_FRONT = 150
VIS_ROW_BYTES = 41
# bytes of one SH row (48 float32)
ROW_BYTES = 192
# `python -m MODULE ARGS...` as runpy runs it, then one JSON line on stdout:
# the kernels the run launched and its peak device memory
RUN_MODULE = """
import json, runpy, sys, torch
from clm_gs_tpu_torch import _build
sys.argv = sys.argv[1:]
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
print(json.dumps({"launches": dict(_build.LAUNCHES),
                  "peak_device_bytes": torch.cuda.max_memory_allocated()}))
"""
# stated tolerances, kernel against plain version
TOL = {
    # termination near T = 1e-4 can flip by one instance where expf and
    # torch.exp differ by 1 ulp: ~1e-4 alpha times a colour of up to ~2
    "image": 5e-4,
    # same saved forward for both: rounding of sequential sums against
    # cumulative products, relative to each column's largest |value|
    "rows_rel": 1e-3,
    "segreduce_rel": 1e-5,
    # kernel path against the dense oracle (tests/test_rasterize.py bounds)
    "oracle_image": 2e-5,
    "oracle_grad_rel": 5e-4,
    # train_step on the card against the CPU: losses, parameter moves and
    # gradients (first moments) relative to their largest value
    "loss_rel": 1e-4,
    "step_rel": 1e-3,
    # the offload strategies' CLI runs against no_offload's: final test
    # PSNR (dB)
    "naive_psnr_db": 0.5,
    "clm_psnr_db": 0.5,
    # the sharded step against no_offload.train_step, both on the card from
    # the same seeded moments (the rows reach the rasterizer compacted, in
    # rank order): losses relative, parameter moves and first moments
    # relative to each group's largest, xyz_grad_accum relative to its
    # largest; denom exact
    "mesh_loss_rel": 1e-5,
    "mesh_step_rel": 1e-4,
    "mesh_grad_rel": 1e-5,
    "mesh_accum_rel": 1e-4,
    # the mesh CLI run's final test PSNR against the cli run's (dB); the clm
    # mesh CLI run's against the clm run's
    "mesh_psnr_db": 0.1,
    # the bigcity phase's clm run against its no_offload run: final test
    # PSNR (dB)
    "bigcity_psnr_db": 0.5,
    # clm_offload's batch on a mesh against the single-process batch, both on
    # the card from the same seeded moments (the rows reach the rasterizer
    # through the gauss gather; with two chains the finish sets are summed
    # over the data group): losses relative, parameter moves (the host SH
    # rows' included) and first moments (the host ones included) relative
    # to each group's largest, xyz_grad_accum relative to its largest; denom
    # exact
    "clm_mesh_loss_rel": 1e-5,
    "clm_mesh_step_rel": 1e-4,
    "clm_mesh_grad_rel": 1e-5,
    "clm_mesh_accum_rel": 1e-4,
    # clm_step with retention against the full re-gather, relative to each
    # group's largest move
    "retention_rel": 1e-5,
}


class CheckFailed(Exception):
    pass


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="directory for the full JSON report")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    try:
        import clm_gs_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 1
    report = {}
    try:
        run(torch, report)
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        return 1
    finally:
        if args.out:
            from pathlib import Path

            Path(args.out).mkdir(parents=True, exist_ok=True)
            (Path(args.out) / "chip_smoke.json").write_text(
                json.dumps(report, indent=1))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def time_ms(torch, fn, reps=10, warmup=2):
    """Device time per call of `fn`: CUDA events around `reps` calls queued
    behind a busy wait of the card, so that a kernel shorter than the host's
    time to launch it is timed, and not the host's pace."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run(torch, report):
    from clm_gs_tpu_torch import _build

    # each phase's seconds, from the end of the one before
    phase_s = report["phase_s"] = {}
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        phase_s[name] = now - clock[0]
        clock[0] = now

    # 1. device and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    ).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    t0 = time.perf_counter()
    ptxas = _build.build()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for lib in ("cpu_adam", "fast_tsp"):
        _build.host_library(lib)
    host_build_s = time.perf_counter() - t0
    regs = {k: [ln.strip() for ln in v.splitlines() if "Used" in ln]
            for k, v in ptxas.items()}
    report["device"] = {"phase": "device", "nvidia_smi": smi,
                        "name": torch.cuda.get_device_name(0),
                        "build_s": build_s, "host_build_s": host_build_s,
                        "ptxas": regs}
    emit({"phase": "device", "build_s": round(build_s, 3),
          "built": sorted(ptxas), "host_build_s": round(host_build_s, 3),
          "host_built": ["cpu_adam", "fast_tsp"]})
    lap("device")

    # 2. kernels against plain versions at a mid size, and against the oracle
    mid = kernel_checks(torch, n=20_000, w=640, h=480, reps=5)
    mid["oracle"] = oracle_check(torch)
    report["kernels_mid"] = mid
    emit({"phase": "kernels_mid", **mid})
    lap("kernels_mid")

    # 3. train_step: kernel path on the card against plain path on the CPU
    report["train_step_mid"] = train_step_check(torch)
    emit(report["train_step_mid"])
    lap("train_step_mid")

    # 4. full width
    scene, report["full"], step_args = full_width(torch)
    emit(report["full"])
    lap("full")

    # 4b. train_step's camera groups on the same scene
    report["micro_group"] = micro_group_check(torch, scene, *step_args)
    emit(report["micro_group"])
    lap("micro_group")

    # 5. kernels at the full-width shapes
    full = kernel_checks(torch, reps=10, scene=scene)
    report["kernels_full"] = full
    lap("kernels_full")

    # 5b. clm's visibility kernel at bicycle's and BigCity's shapes
    report["visibility"] = visibility_checks(torch, scene)
    emit({"phase": "visibility", **report["visibility"]})
    lap("visibility")

    # 6. naive_offload's batch on the same scene, which it takes over
    box = [scene]
    del scene
    report["naive_step"] = naive_step(torch, box, *step_args)
    emit(report["naive_step"])
    lap("naive_step")
    torch.cuda.empty_cache()
    report["clm_step"] = clm_step(torch, box, *step_args)
    emit(report["clm_step"])
    lap("clm_step")
    box.clear()
    torch.cuda.empty_cache()
    report["mesh_step"] = mesh_step(torch)
    emit(report["mesh_step"])
    lap("mesh_step")
    torch.cuda.empty_cache()
    report["clm_mesh_step"] = clm_mesh_step(torch)
    emit(report["clm_mesh_step"])
    lap("clm_mesh_step")
    torch.cuda.empty_cache()
    report["bench4k"] = bench4k_run(torch)
    emit(report["bench4k"])
    lap("bench4k")
    torch.cuda.empty_cache()

    # 11.'s scene, made by a process of its own while phases 7-10b run
    city = bigcity_start()
    try:
        cli_phases(torch, report, lap, city)
    finally:
        bigcity_stop(city)
    lap("bigcity")

    emit(summary(report))
    launches = report["full"]["launches"]

    def other_launches(k):
        return {"cli_launches": report["cli"]["launches"].get(k, 0),
                "naive_step_launches": report["naive_step"]["launches"].get(k, 0),
                "naive_launches": report["naive"]["launches"].get(k, 0),
                "clm_step_launches": report["clm_step"]["launches"].get(k, 0),
                "clm_step_card_gather_launches":
                    report["clm_step"]["card_gather_launches"].get(k, 0),
                "micro_group_launches": report["micro_group"]["launches"].get(k, 0),
                "clm_launches": report["clm"]["launches"].get(k, 0),
                "clm_pinned_resume_launches":
                    report["clm"]["resume"]["launches"].get(k, 0),
                "mesh_step_launches": report["mesh_step"]["launches"].get(k, 0),
                "mesh_launches": report["mesh"]["launches"].get(k, 0),
                "clm_mesh_step_launches": report["clm_mesh_step"]["launches"].get(k, 0),
                "clm_mesh_step_pinned_launches":
                    report["clm_mesh_step"]["pinned_launches"].get(k, 0),
                "clm_mesh_launches": report["clm_mesh"]["launches"].get(k, 0),
                "trajectory_launches": {f: r["launches"].get(k, 0) for f, r in
                                        report["trajectory"]["runs"].items()},
                "bigcity_launches": {f: r.get(k, 0) for f, r in
                                     report["bigcity"]["launches"].items()},
                "bigcity_pinned_batch_launches":
                    report["bigcity"]["pinned_ab"]["runs"]["pinned"]["launches"].get(k, 0),
                "bench4k_launches": report["bench4k"]["launches"].get(k, 0),
                "parity_launches": {s: r["launches"].get(k, 0) for s, r in
                                    report["parity"]["runs"].items()}}

    g = report["clm_step"]["pinned_gather"]
    sc = report["clm_step"]["pinned_scatter"]
    sc_city = report["bigcity"]["kernels"]["pinned_scatter"]
    k4 = report["bench4k"]["kernels"]
    vis = report["visibility"]
    emit({"kernels": [
        {"name": k, "status": "ported", "route": "cuda", "source": KERNELS[k][0],
         "replaces": KERNELS[k][1], "launches": launches.get(k, 0), **other_launches(k),
         "max_abs_err": full[k]["max_abs_err"], "ms": full[k]["ms"],
         "plain_ms": full[k]["plain_ms"], "bound_ms": full[k]["bound_ms"],
         "bound_by": full[k]["bound_by"], "library_ms": full[k]["library_ms"],
         "ms_4k": k4[k]["ms"], "bound_ms_4k": k4[k]["bound_ms"],
         "max_abs_err_4k": k4[k]["max_abs_err"], "plain_ms_4k": k4[k]["plain_ms"],
         "library_ms_4k": k4[k]["library_ms"]}
        for k in KERNELS
    ] + [
        # its main path is clm_step's card-gather variant (first batch)
        {"name": GATHER, "status": "ported", "route": "cuda", "source": GATHER_SOURCE[0],
         "replaces": GATHER_SOURCE[1],
         "launches": report["clm_step"]["card_gather_launches"].get(GATHER, 0),
         **other_launches(GATHER), "max_abs_err": g["max_abs_err"], "ms": g["ms"],
         "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"], "bound_by": g["bound_by"],
         "library_ms": None, "host_staged_fetch_ms": g["host_staged_fetch_ms"],
         "bound_rate": g["bound_rates"]["bus"],
         "h2d_copy_bytes_per_s": g["h2d_bytes_per_s"], "rows": g["rows"],
         "grid": g["grid"], "share_of_bound": g["share_of_bound"],
         "matmuls_beside_ratio": {k: g["beside"]["gather"][k]
                                  for k in ("once_ratio", "stream_ratio")}},
        # the same main path
        {"name": SCATTER, "status": "ported", "route": "cuda", "source": SCATTER_SOURCE[0],
         "replaces": SCATTER_SOURCE[1],
         "launches": report["clm_step"]["card_gather_launches"].get(SCATTER, 0),
         **other_launches(SCATTER), "max_abs_err": sc["max_abs_err"], "ms": sc["ms"],
         "plain_ms": sc["plain_ms"], "bound_ms": sc["bound_ms"], "bound_by": sc["bound_by"],
         "library_ms": None, "store_ms": sc["store_ms"],
         "host_path_ms": sc["host_path_ms"], "bound_rate": sc["bound_rates"]["bus"],
         "d2h_copy_bytes_per_s": sc["d2h_bytes_per_s"], "rows": sc["rows"],
         "split_half_ms": sc["split_half_ms"], "grid": sc["grid"],
         "share_of_bound": sc["share_of_bound"],
         "store_share_of_bound": sc["store_share_of_bound"],
         "matmuls_beside_ratio": {name: {k: sc["beside"][name][k] for k in (
             "once_ratio", "stream_ratio")} for name in ("scatter_add", "scatter_store")},
         "first_departure_share":
             report["clm_step"]["card_gather_bytes_vs_host"]["warm"]["first_departure_share"],
         "bigcity_rows": sc_city["rows"], "bigcity_ms": sc_city["ms"],
         "bigcity_bound_ms": sc_city["bound_ms"],
         "bigcity_share_of_bound": sc_city["share_of_bound"],
         "bigcity_grid": sc_city["grid"],
         "bigcity_matmuls_beside_ratio": {name: {k: sc_city["beside"][name][k] for k in (
             "once_ratio", "stream_ratio")} for name in ("scatter_add", "scatter_store")},
         "bigcity_max_abs_err": sc_city["max_abs_err"],
         "bigcity_host_path_ms": sc_city["host_path_ms"],
         "bigcity_first_departure_share":
             report["bigcity"]["pinned_ab"]["first_departure_share"]},
        # its main path is clm's plan, once a row chunk for the batch
        {"name": VISIBILITY, "status": "added", "route": "cuda",
         "source": VISIBILITY_SOURCE[0], "replaces": VISIBILITY_SOURCE[1],
         "launches": report["clm_step"]["launches"].get(VISIBILITY, 0),
         **other_launches(VISIBILITY),
         **{f"{shape}_{k}": vis[shape][k] for shape in ("bicycle", "bigcity")
            for k in ("rows", "cameras", "equal", "ms", "bound_ms", "bound_by",
                      "share_of_bound", "plain_ms")}}
    ]})


def cli_phases(torch, report, lap, city):
    """Phases 7-11 into `report`, `lap(name)` after each: 7.-10. the
    training CLI and the renderer on one synthetic COLMAP scene at full
    width, written and decoded once, 10b. parity, 11. bigcity on the scene
    of the started make `city`."""
    from clm_gs_tpu_torch.utils.synthetic_colmap import make_dataset

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as work:
        t0 = time.perf_counter()
        colmap = make_dataset(f"{work}/scene", full=True)
        scene_s = time.perf_counter() - t0
        report["cli"] = cli_run(torch, work, colmap)
        report["cli"]["scene_s"] = scene_s
        emit(report["cli"])
        lap("cli")
        for name, fn, args in (
                ("naive", naive_cli_run, ("cli",)),
                ("clm", clm_cli_run, ("cli", "naive")),
                ("mesh", mesh_cli_run, ("cli",)),
                ("clm_mesh", clm_mesh_cli_run, ("clm",))):
            torch.cuda.empty_cache()
            report[name] = fn(torch, work, colmap, *(report[a] for a in args))
            emit(report[name])
            lap(name)
        torch.cuda.empty_cache()
        report["trajectory"] = trajectory_run(torch, work, colmap)
        emit(report["trajectory"])
        lap("trajectory")
    torch.cuda.empty_cache()
    report["parity"] = parity_run(torch)
    emit(report["parity"])
    lap("parity")
    torch.cuda.empty_cache()

    # 11. the BigCity regime on one card
    report["bigcity"] = bigcity_run(torch, city)
    emit(report["bigcity"])


def summary(report):
    """The numbers of the long phase lines that a reader compares across
    calls, on one short line near the end of the output."""
    step = report["clm_step"]
    runs = step["runs"]
    clm = report["clm"]
    return {"phase": "summary", "phase_s": report["phase_s"],
            "total_s": sum(report["phase_s"].values()), "clm_step": {
        "warm_batch_s": {k: r["warm"]["batch_s"] for k, r in runs.items()},
        "warm_batches_s": {k: r["warm"]["warm_batches_s"] for k, r in runs.items()},
        "timed_batch_s": {k: r["timed"]["batch_s"] for k, r in runs.items()},
        "warm_h2d_d2h_bytes": {k: [r["warm"]["h2d_bytes"], r["warm"]["d2h_bytes"]]
                               for k, r in runs.items()},
        "warm_trailing_s": {k: r["warm"]["trailing_s"] for k, r in runs.items()},
        "spans_ms_host_vs_card_gather": step["spans_ms_host_vs_card_gather"],
        "card_gather_equal_to_host_gather": all(
            step["card_gather_equal_to_host_gather"].values()),
        "pinned_gather": step["pinned_gather"],
        "pinned_scatter": {k: step["pinned_scatter"][k] for k in (
            "rows", "ms", "store_ms", "split_half_ms", "plain_ms", "host_path_ms",
            "bound_ms", "share_of_bound", "grid", "beside", "d2h_bytes_per_s", "exact")},
        "first_departure_share": {
            when: b["first_departure_share"]
            for when, b in step["card_gather_bytes_vs_host"].items()}},
        "micro_group": {k: report["micro_group"][k] for k in (
            "group", "loss_rel_err", "param_step_rel_err", "grad_rel_err", "step_s")},
        "clm_it_per_s": clm["it_per_s"], "cli_it_per_s": report["cli"]["it_per_s"],
        "naive_it_per_s": report["naive"]["it_per_s"],
        "clm_pinned_resume": {k: clm["resume"][k] for k in ("end2end", "test_psnr", "launches")},
        "trajectory": {f: {k: r[k] for k in ("frames_per_s", "render_readback_s", "s",
                                              "peak_device_bytes")}
                       for f, r in report["trajectory"]["runs"].items()},
        "mesh_step": {k: report["mesh_step"][k] for k in (
            "single_median_step_s", "sharded_median_step_s", "single_peak_device_bytes",
            "sharded_peak_device_bytes", "rank_state_bytes", "errors", "ranks")},
        "mesh": {k: report["mesh"][k] for k in ("it_per_s", "cli_it_per_s",
                                                 "final_test_psnr_minus_cli")},
        "clm_mesh_step": {k: report["clm_mesh_step"][k] for k in (
            "single_median_batch_s", "mesh_median_batch_s", "single_peak_device_bytes",
            "mesh_peak_device_bytes", "rank_host_bytes", "rank_card_bytes", "errors")},
        "clm_mesh_step_ranks": {shape: [{k: r.get(k) for k in (
            "rank", "mesh_batch_s", "mesh_peak_device_bytes", "rank_host_bytes",
            "data_sum_ms_per_batch", "data_sum_bytes_per_batch")} for r in rs]
            for shape, rs in report["clm_mesh_step"]["ranks"].items()},
        "clm_mesh": {k: report["clm_mesh"][k] for k in (
            "it_per_s", "clm_it_per_s", "final_test_psnr_minus_clm",
            "densify_gather_ms_calls", "host_gather_bytes", "peak_device_bytes")},
        "bench4k": {k: report["bench4k"][k] for k in (
            "resolution", "mpix_s", "sec_per_batch", "peak_device_bytes", "n_isects",
            "s")},
        "parity": {k: report["parity"][k] for k in ("iterations", "test_psnr",
                                                     "max_gap_db", "rss_gb_at_eval", "s")},
        "bigcity": {k: report["bigcity"][k] for k in (
            "n", "capacity", "it_per_s", "s_per_batch", "init_test_psnr",
            "final_test_psnr", "peak_device_bytes", "sampled_peak_rss_bytes",
            "clm_host_state_bytes", "rss_before_bytes", "load_rss_over_host_state_bytes",
            "clm_spans_ms_per_call", "clm_overlap")} | {
            "pinned_ab": report["bigcity"]["pinned_ab"]} | {
            "device_loop": {k: report["bigcity"]["device_loop"][k] for k in (
                "replay_median_s", "batch_s", "card_share_of_batch",
                "replay_equal_to_in_situ", "batch_h2d_bytes", "batch_d2h_bytes",
                "batch_trailing_s", "unique_cameras")}}}


def _bound(bytes_, flops):
    tb = bytes_ / PEAK_BYTES * 1e3
    tf = flops / PEAK_F32 * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def pair_counts(torch, table, gauss_ids, tile_offsets, last, w, h):
    """The (instance, pixel) pairs this run's data needs, by how far each
    goes: {"fwd" | "bwd": {kind: count for kind in KINDS}}, and each
    pixel's depth, the instances it walks: {"fwd" | "bwd": (tiles, 2048)}.
    The forward tests a pixel's instances up to the one that ends it (or its
    tile's end); the backward replays them up to the pixel's saved last
    composited instance. Replays the forward's termination as
    rasterize_fwd_plain does; the instance that ends a pixel counts as tested
    only."""
    from clm_gs_tpu_torch.ops import rasterize as R

    px, py, inside = R._tile_pixels(w, h, table.device)
    starts = tile_offsets[:-1].long()
    counts = tile_offsets[1:].long() - starts
    last_t = R._to_tiles(last[None].long(), fill=-1)[:, 0]
    n = {d: dict.fromkeys(KINDS, 0) for d in ("fwd", "bwd")}
    depths = []
    # in groups of tiles, as the plain versions walk them
    for g in range(0, px.shape[0], R.TILE_GROUP):
        s = slice(g, g + R.TILE_GROUP)
        depths.append(_group_pairs(torch, n, table, gauss_ids, starts[s], counts[s],
                                   last_t[s], px[s], py[s], inside[s]))
    return n, {d: torch.cat([x[d] for x in depths]) for d in ("fwd", "bwd")}


def _group_pairs(torch, n, table, gauss_ids, starts, counts, last_t, px, py, inside):
    """pair_counts of a group of tiles: adds its pairs to `n`, returns its
    depths."""
    from clm_gs_tpu_torch.ops import rasterize as R

    T = torch.ones_like(px)
    done = ~inside
    depth = {"fwd": torch.zeros_like(last_t),
             "bwd": torch.clamp_min(last_t - starts[:, None] + 1, 0)}
    for k0 in range(0, int(counts.max()), R.CHUNK):
        idx, valid, attrs, dx, dy, _, _, alpha, ok = R._chunk(
            table, gauss_ids, starts, counts, k0, px, py)
        ca, cb, cc = attrs[..., 2:3], attrs[..., 3:4], attrs[..., 4:5]
        sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
        past = valid[..., None] & (sigma > torch.log(255 * attrs[..., 5:6]) + 1e-3)
        culled = valid[..., None] & ~past & (sigma < 0)
        a = torch.where(ok, alpha, torch.zeros_like(alpha))
        om = 1.0 - a
        T_excl = T[:, None] * R._excl_cumprod(torch.cumprod(om, dim=1))
        viol = (a > 0) & (T_excl * om <= R.T_EPS)
        ended = (torch.cumsum(viol.int(), dim=1) - viol.int()) > 0
        live = valid[..., None] & ~done[:, None] & ~ended
        keep = live & ~viol & (a > 0)
        replay = valid[..., None] & (idx[..., None] <= last_t[:, None, :])
        for d, mask, comp in (("fwd", live, keep), ("bwd", replay, replay & ok)):
            n[d]["cut"] += int((mask & past).sum())
            n[d]["culled"] += int((mask & culled).sum())
            n[d]["composited"] += int(comp.sum())
            n[d]["tested"] += int((mask & ~past & ~culled & ~comp).sum())
        depth["fwd"] += live.sum(1)
        T = T * torch.where(keep, om, torch.ones_like(om)).prod(1)
        done = done | viol.any(1)
        if bool(done.all()):
            break
    return depth


def walk(depth, gw, gh):
    """(instance, pixel) slots walked when every gw x gh group of a tile's
    pixels moves in lockstep to its deepest pixel's depth."""
    from clm_gs_tpu_torch.ops.rasterize import TILE_H, TILE_W

    g = depth.reshape(-1, TILE_H // gh, gh, TILE_W // gw, gw).amax((2, 4))
    return int(g.sum()) * gw * gh


def walks(depth):
    """Slots the compositing kernels' block shapes walk: one block that owns
    a whole 64x32 tile moves it to its deepest pixel; a warp of a 16x16
    sub-tile block covers a 16x2 patch. `serial` is the sum over tiles of
    the deepest pixel's depth: the instances the tile's slowest warp walks
    one after another."""
    out = {}
    for d, dep in depth.items():
        out[d] = {"needed": int(dep.sum()), "warp_16x2": walk(dep, 16, 2),
                  "block_16x16": walk(dep, 16, 16), "tile_64x32": walk(dep, 64, 32),
                  "serial": int(dep.amax(1).sum())}
    return out


def _pair_ops(pairs, d):
    p = pairs[d]
    return (p["cut"] * OPS_CUT + p["culled"] * OPS_CULLED + p["tested"] * OPS_TESTED
            + p["composited"] * OPS_COMPOSITED[d])


def camera_inputs(torch, state, cb, b):
    """What the main path hands the rasterizer for camera b."""
    from clm_gs_tpu_torch.strategies.base import rasterize_inputs

    with torch.no_grad():
        out = rasterize_inputs(state.params, state.alive, cb.viewmats[b],
                               cb.Ks[b], cb.camtoworlds[b, :3, 3], 3,
                               cb.width, cb.height)
    return tuple(t.contiguous() for t in out)


def kernel_checks(torch, n=None, w=None, h=None, reps=10, scene=None, timed=True):
    """Each kernel against its plain version on the inputs the main path
    gives it for one camera: errors, and unless `timed` is false, times and
    bounds."""
    from clm_gs_tpu_torch.ops import fill, rasterize as R, segreduce, tiles
    from clm_gs_tpu_torch.strategies.base import photometric_loss
    from clm_gs_tpu_torch.utils.bench_scene import make_scene

    if scene is None:
        state, _, cb, gts, _, _, bg = make_scene(n=n, cap=n, bsz=1, w=w, h=h)
    else:
        state, cb, gts, bg = scene
    w, h = cb.width, cb.height
    m2d, conics, colors, opac, depths, radii = camera_inputs(torch, state, cb, 0)
    tx, ty = R.tile_grid(w, h)
    out = {"shape": {"gaussians": int(state.n_alive), "width": w, "height": h}}

    # kernel 4: the binning's fill inputs
    ext = tiles.tight_extents(conics, opac, radii)
    ch, n_isects = tiles.expansion_channels(m2d, radii, depths, (R.TILE_W, R.TILE_H),
                                            tx, ty, extents=ext)
    k = fill.forward_fill_cuda(ch)
    p = fill.forward_fill_plain(ch)
    check(torch.equal(k, p), "fill kernel differs from its plain version")
    out["fill"] = {"max_abs_err": 0.0, "tol": 0, "n": n_isects}
    if timed:
        b, by = _bound(2 * ch.numel() * 4, 0)
        out["fill"].update(
            ms=time_ms(torch, lambda: fill.forward_fill_cuda(ch), reps),
            plain_ms=time_ms(torch, lambda: fill.forward_fill_plain(ch), 3, 1),
            bound_ms=b, bound_by=by, library_ms=None)
    if scene is None:
        # one valid slot, the first, in rows that start off 16-byte
        # boundaries: every block finds its carry only through the others
        n_adv = 4 * (n_isects // 4) + 3
        adv = torch.randint(1, 1000, (3, n_adv), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(7)).cuda()
        adv[0, 1:] = 0
        check(torch.equal(fill.forward_fill_cuda(adv), fill.forward_fill_plain(adv)),
              "fill kernel differs from its plain version on one valid slot")
        out["fill"]["adversarial"] = {"n": n_adv, "valid": 1, "exact": True}

    # binning on the card against the plain path on the CPU
    isect = tiles.isect_tiles(m2d, radii, depths, (R.TILE_W, R.TILE_H), tx, ty,
                              extents=ext)
    cpu = tiles.isect_tiles(m2d.cpu(), radii.cpu(), depths.cpu(),
                            (R.TILE_W, R.TILE_H), tx, ty,
                            extents=tuple(e.cpu() for e in ext))
    check(cpu.n_isects == isect.n_isects
          and torch.equal(isect.gauss_ids.cpu(), cpu.gauss_ids)
          and torch.equal(isect.tile_offsets.cpu(), cpu.tile_offsets),
          "binning on the card differs from the CPU")
    out["binning"] = {"n_isects": isect.n_isects, "exact": True}

    # kernel 1
    table = torch.cat([m2d, conics, opac[:, None], colors], 1).contiguous()
    fargs = (table, isect.gauss_ids, isect.tile_offsets, bg.contiguous(), w, h)
    kf = R.rasterize_fwd_cuda(*fargs)
    pf = R.rasterize_fwd_plain(*fargs)
    err_img = (kf[0] - pf[0]).abs().max().item()
    err_alpha = (kf[1] - pf[1]).abs().max().item()
    torch.cuda.synchronize()
    check(err_img <= TOL["image"] and err_alpha <= TOL["image"],
          f"rasterize_fwd: image err {err_img}, alpha err {err_alpha}")
    m = isect.n_isects
    out["rasterize_fwd"] = {
        "max_abs_err": max(err_img, err_alpha), "tol": TOL["image"],
        "pixels_over_1e-5": int(((kf[0] - pf[0]).abs() > 1e-5).sum()),
    }
    if timed:
        pairs, depth = pair_counts(torch, table, isect.gauss_ids,
                                   isect.tile_offsets, kf[3], w, h)
        walked = walks(depth)
        fwd_bytes = table.numel() * 4 + m * 4 + (tx * ty + 1) * 4 + 12 + 6 * w * h * 4
        b, by = _bound(fwd_bytes, _pair_ops(pairs, "fwd"))
        out["rasterize_fwd"].update(
            pairs=pairs["fwd"], walk=walked["fwd"],
            ms=time_ms(torch, lambda: R.rasterize_fwd_cuda(*fargs), reps),
            plain_ms=time_ms(torch, lambda: R.rasterize_fwd_plain(*fargs), 2, 1),
            bound_ms=b, bound_by=by, library_ms=None)

    # kernel 2, with the loss gradient the main path gives it
    img = kf[0].clone().requires_grad_(True)
    photometric_loss(img, gts[0]).backward()
    v_img = img.grad.contiguous()
    v_alpha = torch.zeros_like(kf[1])
    bargs = (table, isect.gauss_ids, isect.tile_offsets, kf[0], kf[1], kf[3],
             v_img, v_alpha, w, h)
    rk = R.rasterize_bwd_cuda(*bargs)
    check(torch.equal(rk, R.rasterize_bwd_cuda(*bargs)),
          "rasterize_bwd: two launches on the same inputs differ")
    rp = R.rasterize_bwd_plain(*bargs)
    col_scale = rp.abs().amax(0).clamp_min(1e-30)
    err_rows = (rk - rp).abs().max().item()
    rel_rows = ((rk - rp).abs() / col_scale).max().item()
    check(rel_rows <= TOL["rows_rel"] and bool(torch.isfinite(rk).all()),
          f"rasterize_bwd: rows rel err {rel_rows}")
    out["rasterize_bwd"] = {
        "max_abs_err": err_rows, "rel_err": rel_rows, "tol": TOL["rows_rel"],
        "deterministic": True,
    }
    if timed:
        bwd_bytes = (table.numel() * 4 + m * 4 + (tx * ty + 1) * 4 + 9 * w * h * 4
                     + m * 9 * 4)
        b, by = _bound(bwd_bytes, _pair_ops(pairs, "bwd"))
        out["rasterize_bwd"].update(
            pairs=pairs["bwd"], walk=walked["bwd"],
            ms=time_ms(torch, lambda: R.rasterize_bwd_cuda(*bargs), reps),
            plain_ms=time_ms(torch, lambda: R.rasterize_bwd_plain(*bargs), 2, 1),
            bound_ms=b, bound_by=by, library_ms=None)

    # kernel 3 on the rows in sorted order, as the main path gathers them
    ids_sorted, perm = torch.sort(isect.gauss_ids, stable=True)
    rows_sorted = rk[perm].contiguous()
    ng = table.shape[0]
    seg = lambda: segreduce.segment_reduce_cuda(ids_sorted, rows_sorted, ng)
    sk = seg()
    check(torch.equal(sk, seg()), "segreduce: two launches on the same inputs differ")
    sp = segreduce.segment_reduce_plain(ids_sorted, rows_sorted, ng)
    err_seg = (sk - sp).abs().max().item()
    rel_seg = err_seg / max(sp.abs().max().item(), 1e-30)
    check(rel_seg <= TOL["segreduce_rel"], f"segreduce rel err {rel_seg}")
    out["segreduce"] = {
        "max_abs_err": err_seg, "rel_err": rel_seg, "tol": TOL["segreduce_rel"],
        "deterministic": True, "n": ng,
    }
    if timed:
        ids_long = ids_sorted.long()
        b, by = _bound(m * 4 + m * 36 + ng * 36, 0)
        out["segreduce"].update(
            ms=time_ms(torch, seg, reps),
            plain_ms=time_ms(torch, lambda: segreduce.segment_reduce_plain(
                ids_sorted, rows_sorted, ng), reps),
            library_ms=time_ms(torch, lambda: torch.zeros(
                ng, 9, device=rows_sorted.device).index_add_(0, ids_long, rows_sorted),
                reps),
            bound_ms=b, bound_by=by,
            # the main path's gather of the rows into sorted order, in torch
            gather_ms=time_ms(torch, lambda: rk[perm].contiguous(), reps))
    return out


def visibility_check(torch, xyz, quat, log_scale, alive, viewmats, Ks, w, h, reps=10):
    """csrc/visibility.cu against its plain version on one row chunk for a
    batch of cameras: the masks bit for bit at radius_clip 0 and 1.5, the
    kernel's time, its bound and the plain version's time."""
    from clm_gs_tpu_torch.strategies import offload_common as oc

    rows, B = xyz.shape[0], viewmats.shape[0]
    cams = oc.camera_table(viewmats, Ks, w, h)
    args = (xyz, quat, log_scale, alive)
    differ, visible = {}, {}
    for clip in (0.0, 1.5):
        k = oc.visibility_cuda(*args, cams, w, h, clip)
        p = oc.visibility_plain(*args, viewmats, Ks, w, h, clip)
        differ[str(clip)] = int((k != p).sum())
        visible[str(clip)] = int(p.sum())
        del k, p
    check(not any(differ.values()),
          f"visibility: (camera, row) pairs that differ from the plain version at "
          f"{rows} rows and {B} cameras, by radius_clip: {differ}")
    # the work these rows need: the live pairs between the planes, by the
    # view's depth (near the planes this float32 product may round apart
    # from the kernel's, a handful of pairs)
    z = xyz @ viewmats[:, 2, :3].T + viewmats[:, 2, 3]
    front = int(((z > 0.01) & (z < 1e10) & alive[:, None]).sum())
    del z
    n_live = int(alive.sum())
    b, by = _bound(rows * VIS_ROW_BYTES + B * rows,
                   OPS_VIS_ROW * n_live + OPS_VIS_PAIR * n_live * B + OPS_VIS_FRONT * front)
    ms = time_ms(torch, lambda: oc.visibility_cuda(*args, cams, w, h, 0.0), reps)
    return {"rows": rows, "cameras": B, "width": w, "height": h, "live_rows": n_live,
            "front_pairs": front, "visible_pairs": visible, "equal": True,
            "differ": differ, "ms": ms, "bound_ms": b, "bound_by": by,
            "share_of_bound": b / ms,
            "plain_ms": time_ms(torch, lambda: oc.visibility_plain(
                *args, viewmats, Ks, w, h, 0.0), 2, 1)}


def visibility_checks(torch, scene):
    """`visibility_check` at bicycle's shapes (the full scene's rows and its
    4 cameras of 1237x822) and at BigCity's: one FILTER_CHUNK_ROWS chunk of
    city rows (`bigcity.city_gaussians`, log scales shifted to the
    BIGCITY_N scene's spacing, every row alive) and 64 street cameras of
    1600x900 (`bigcity.serpentine_cameras`)."""
    import numpy as np

    from clm_gs_tpu_torch.data.cameras import stack_cameras
    from clm_gs_tpu_torch.strategies import offload_common as oc
    from clm_gs_tpu_torch.utils.bigcity import SEED, city_gaussians, serpentine_cameras

    state, cb = scene[0], scene[1]
    p = state.params
    out = {"bicycle": visibility_check(torch, p.xyz, p.quat, p.log_scale, state.alive,
                                       cb.viewmats, cb.Ks, cb.width, cb.height)}
    rows = oc.FILTER_CHUNK_ROWS
    xyz, log_scale, quat, _, _ = city_gaussians(rows, np.random.RandomState(SEED))
    log_scale += np.float32(0.5 * np.log(rows / BIGCITY_N))
    city = stack_cameras(serpentine_cameras(64, 1600, 900), device="cuda")
    t = [torch.from_numpy(a).cuda() for a in (xyz, quat, log_scale)]
    out["bigcity"] = visibility_check(torch, *t, torch.ones(rows, dtype=torch.bool,
                                                            device="cuda"),
                                      city.viewmats, city.Ks, 1600, 900)
    return out


def oracle_check(torch):
    """Kernel-path rasterize (forward and grads) against the dense oracle on
    the small projected scene of the reference's rasterizer tests (80
    Gaussians, 64x48), on the card."""
    import numpy as np

    from clm_gs_tpu_torch.data.cameras import stack_cameras
    from clm_gs_tpu_torch.ops.projection import fully_fused_projection
    from clm_gs_tpu_torch.ops.rasterize import rasterize
    from clm_gs_tpu_torch.ops.rasterize_ref import rasterize_reference
    from clm_gs_tpu_torch.ops.sh import spherical_harmonics
    from clm_gs_tpu_torch.utils.bench_scene import make_camera

    rng = np.random.RandomState(3)
    n, w, h = 80, 64, 48
    xyz = rng.uniform(-1.5, 1.5, (n, 3))
    log_scales = rng.uniform(-3.5, -2.0, (n, 3))
    quats = rng.normal(size=(n, 4))
    opacity_logits = rng.uniform(-1.0, 3.0, (n,))
    sh = np.concatenate([rng.uniform(-1.0, 1.0, (n, 1, 3)),
                         0.1 * rng.normal(size=(n, 15, 3))], 1)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device="cuda")
    cb = stack_cameras([make_camera(width=w, height=h, angle=0.4)])
    with torch.no_grad():
        proj = fully_fused_projection(t(xyz), t(quats), torch.exp(t(log_scales)),
                                      cb.viewmats, cb.Ks, w, h)
        colors = torch.clamp_min(spherical_harmonics(
            3, t(xyz) - cb.camera_centers[0], t(sh)) + 0.5, 0.0)
    arrs = [proj.means2d[0], proj.conics[0], colors,
            torch.sigmoid(t(opacity_logits)), proj.depths[0], proj.radii[0],
            t([0.1, 0.2, 0.3])]
    target = t(rng.rand(3, h, w))
    grads, imgs = [], []
    for fn in (lambda *a: rasterize(*a[:6], w, h, a[6])[:2],
               lambda *a: rasterize_reference(*a[:6], w, h, a[6])):
        leaves = [a.detach().clone().requires_grad_(i in (0, 1, 2, 3, 6))
                  for i, a in enumerate(arrs)]
        img, _ = fn(*leaves)
        ((img - target) ** 2).sum().backward()
        imgs.append(img.detach())
        grads.append([leaves[i].grad for i in (0, 1, 2, 3, 6)])
    err = (imgs[0] - imgs[1]).abs().max().item()
    rel = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-3)).item()
              for a, b in zip(*grads))
    check(err <= TOL["oracle_image"] and rel <= TOL["oracle_grad_rel"],
          f"kernel path vs oracle: image err {err}, grad rel err {rel}")
    return {"max_abs_err": err, "grad_rel_err": rel,
            "tol": [TOL["oracle_image"], TOL["oracle_grad_rel"]]}


def _seeded_moments(torch, params, device, seed=5):
    """Moments at step 10 (nu >> g^2): the update is smooth in g, unlike the
    first step from zero moments, which is lr * sign(g)."""
    import numpy as np

    from clm_gs_tpu_torch.models.gaussians import GaussianParams
    from clm_gs_tpu_torch.optim import AdamState

    rng = np.random.RandomState(seed)
    mu, nu = [], []
    for t in params.astuple():
        mu.append(torch.tensor(1e-3 * rng.normal(size=t.shape), dtype=torch.float32))
        nu.append(torch.tensor(rng.uniform(0.5e-2, 1.5e-2, t.shape),
                               dtype=torch.float32))
    return AdamState(GaussianParams(*(x.to(device) for x in mu)),
                     GaussianParams(*(x.to(device) for x in nu)),
                     torch.tensor(10.0, device=device))


def _to(torch, obj, device):
    import dataclasses

    if torch.is_tensor(obj):
        return obj.to(device)
    if dataclasses.is_dataclass(obj):
        return type(obj)(**{f.name: _to(torch, getattr(obj, f.name), device)
                            for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: _to(torch, v, device) for k, v in obj.items()}
    return obj


def _clone(torch, obj):
    """A copy of a state or moments with every tensor cloned: clm's batch
    updates the ones it is given in place (its donation contract)."""
    import dataclasses

    if torch.is_tensor(obj):
        return obj.clone()
    if dataclasses.is_dataclass(obj):
        return type(obj)(**{f.name: _clone(torch, getattr(obj, f.name))
                            for f in dataclasses.fields(obj)})
    return obj


def train_step_check(torch):
    from clm_gs_tpu_torch.strategies.no_offload import train_step
    from clm_gs_tpu_torch.utils.bench_scene import make_scene

    n, w, h = 20_000, 640, 480
    state, _, cb, _, lrs, cfg, bg = make_scene(n=n, cap=n, bsz=1, w=w, h=h)
    g = torch.Generator(device="cpu").manual_seed(1)
    gts = torch.rand(1, 3, h, w, generator=g).cuda()
    opt = _seeded_moments(torch, state.params, "cuda")
    outs = {}
    for name, dev in (("kernel", "cuda"), ("plain", "cpu")):
        t0 = time.perf_counter()
        s, o, out = train_step(_to(torch, state, dev), _to(torch, opt, dev),
                               _to(torch, cb, dev), gts.to(dev), 3,
                               _to(torch, lrs, dev), cfg, bg.to(dev), w, h)
        if dev == "cuda":
            torch.cuda.synchronize()
        outs[name] = (_to(torch, s, "cpu"), _to(torch, o, "cpu"),
                      out.losses.cpu(), time.perf_counter() - t0, out.max_isects)
    (sk, ok_, lk, tk, nk), (sp, op_, lp, tp, np_) = outs["kernel"], outs["plain"]
    loss_rel = ((lk - lp).abs() / lp.abs()).max().item()
    p0 = _to(torch, state.params, "cpu")
    step_rel, grad_rel = 0.0, 0.0
    for f in ("xyz", "opacity", "log_scale", "quat", "sh"):
        dk = getattr(sk.params, f) - getattr(p0, f)
        dp = getattr(sp.params, f) - getattr(p0, f)
        step_rel = max(step_rel, ((dk - dp).abs().max()
                                  / dp.abs().max().clamp_min(1e-30)).item())
        gscale = (getattr(op_.mu, f) - 0.9 * getattr(opt.mu, f).cpu()).abs().max()
        grad_rel = max(grad_rel, ((getattr(ok_.mu, f) - getattr(op_.mu, f)).abs().max()
                                  / gscale.clamp_min(1e-30)).item())
    check(bool(torch.isfinite(lk).all()) and loss_rel <= TOL["loss_rel"]
          and step_rel <= TOL["step_rel"] and grad_rel <= TOL["step_rel"]
          and nk == np_,
          f"train_step card vs CPU: loss {loss_rel}, step {step_rel}, "
          f"grad {grad_rel}, isects {nk} vs {np_}")
    return {"phase": "train_step_mid", "losses": lk.tolist(),
            "loss_rel_err": loss_rel, "param_step_rel_err": step_rel,
            "grad_rel_err": grad_rel, "n_isects": nk,
            "tol": [TOL["loss_rel"], TOL["step_rel"]],
            "kernel_s": tk, "plain_cpu_s": tp}


def full_width(torch):
    from clm_gs_tpu_torch import _build
    from clm_gs_tpu_torch.strategies.no_offload import train_step
    from clm_gs_tpu_torch.utils.bench_scene import make_scene

    state, opt, cb, gts, lrs, cfg, bg = make_scene()
    w, h, bsz = cb.width, cb.height, gts.shape[0]
    t0 = time.perf_counter()
    state, opt, out = train_step(state, opt, cb, gts, 3, lrs, cfg, bg, w, h)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    step_s, losses, n_isects = [], [], []
    for _ in range(3):
        t0 = time.perf_counter()
        state, opt, out = train_step(state, opt, cb, gts, 3, lrs, cfg, bg, w, h)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(out.losses.tolist())
        n_isects.append(list(out.n_isects))
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    finite = all(all(map(lambda v: v == v and abs(v) != float("inf"), ls))
                 for ls in losses)
    check(finite, f"non-finite losses {losses}")
    check(all(launches.get(k, 0) > 0 for k in KERNELS),
          f"a kernel of the main path never launched: {launches}")
    mean_s = sum(step_s) / len(step_s)
    return (state, cb, gts, bg), {
        "phase": "full", "gaussians": int(state.n_alive),
        "capacity": state.capacity, "cameras": bsz, "width": w, "height": h,
        "warmup_s": warm_s, "step_s": step_s, "mean_step_s": mean_s,
        "mpix_per_s": bsz * w * h / mean_s / 1e6, "losses": losses,
        "n_isects": n_isects, "max_memory_allocated": peak,
        "launches": launches,
    }, (lrs, cfg)


def micro_group_check(torch, scene, lrs, adam_cfg):
    """Phase 4b: on phase 4's state, from the same seeded moments, one
    no_offload.train_step with micro_group=B (one group of the whole batch:
    projection and SH batched, compositing per camera, one backward of the
    summed losses) against the one-camera step (G = 1): losses, parameter
    moves and first moments within train_step_mid's tolerances; each step's
    seconds and peak device memory, and the group step's launches."""
    from clm_gs_tpu_torch import _build
    from clm_gs_tpu_torch.strategies.no_offload import group_size, train_step

    state, cb, gts, bg = scene
    w, h, bsz = cb.width, cb.height, gts.shape[0]
    opt = _seeded_moments(torch, state.params, "cuda")
    outs, launches = {}, {}
    for G in (1, bsz):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        s, o, out = train_step(state, opt, cb, gts, 3, lrs, adam_cfg, bg, w, h,
                               micro_group=G)
        torch.cuda.synchronize()
        outs[G] = (s, o, out.losses.cpu(), time.perf_counter() - t0,
                   torch.cuda.max_memory_allocated())
        launches[G] = dict(_build.LAUNCHES)
    (s1, o1, l1, t1, m1), (sg, og, lg, tg, mg) = outs[1], outs[bsz]
    loss_rel = ((lg - l1).abs() / l1.abs()).max().item()
    step_rel = grad_rel = 0.0
    for f in GROUPS:
        p0 = getattr(state.params, f)
        d1, dg = getattr(s1.params, f) - p0, getattr(sg.params, f) - p0
        step_rel = max(step_rel, ((dg - d1).abs().max()
                                  / d1.abs().max().clamp_min(1e-30)).item())
        gscale = (getattr(o1.mu, f) - 0.9 * getattr(opt.mu, f)).abs().max()
        grad_rel = max(grad_rel, ((getattr(og.mu, f) - getattr(o1.mu, f)).abs().max()
                                  / gscale.clamp_min(1e-30)).item())
    result = {"phase": "micro_group", "group": group_size(bsz, bsz), "cameras": bsz,
              "losses_group": lg.tolist(), "losses_one": l1.tolist(),
              "loss_rel_err": loss_rel, "param_step_rel_err": step_rel,
              "grad_rel_err": grad_rel, "tol": [TOL["loss_rel"], TOL["step_rel"]],
              "step_s": {"one": t1, "group": tg},
              "peak_device_bytes": {"one": m1, "group": mg},
              "launches": launches[bsz], "one_launches": launches[1]}
    check(bool(torch.isfinite(lg).all()) and loss_rel <= TOL["loss_rel"]
          and step_rel <= TOL["step_rel"] and grad_rel <= TOL["step_rel"],
          f"micro_group {bsz} against one camera at a time: loss {loss_rel}, "
          f"step {step_rel}, grad {grad_rel}")
    check(all(launches[bsz].get(k, 0) >= bsz for k in ("rasterize_fwd", "rasterize_bwd",
                                                        "segreduce")),
          f"micro_group: the kernels launch per camera: {launches[bsz]}")
    return result


# gradient thresholds of the cli phase's densification probe
PROBE_THRESHOLDS = (5e-8, 1e-7, 2e-7, 5e-7, 1e-6, 2e-6, 5e-6, 1e-5, 1e-4, 2e-4)
# the --enable_timer spans that run inside the end2end timer (eval, save and
# checkpoint pause it)
SPANS_IN_END2END = ("data_next", "train_step", "log", "count_densify",
                    "grow_capacity", "densify", "reset_opacity")


# The cli phase: the bench scene as a COLMAP scene on disk, trained through
# the CLI with synthetic_colmap.FULL_TRAIN_ARGS (its densification threshold
# makes the model outgrow its first capacity; PERF.md §4).
def _parse_log(text):
    """What the cli phase reads from a python.log."""
    out = {"losses": [], "n3dgs": [], "capacity": [], "densify": [],
           "test_psnr": [], "timers": {}, "resets": 0, "end2end": None}
    for ln in text.splitlines():
        if " loss: " in ln:
            out["losses"].append(float(ln.split("loss: ")[1].split()[0]))
            out["n3dgs"].append(int(ln.split("n3dgs: ")[1]))
        elif ln.startswith("capacity "):
            a, b = ln.split()[1], ln.split()[3]
            out["capacity"].append([int(a), int(b)])
        elif "densify_and_prune. Now num of 3dgs:" in ln:
            out["densify"].append(int(ln.split("3dgs: ")[1].split(".")[0]))
        elif ln.endswith(" reset_opacity"):
            out["resets"] += 1
        elif "Evaluating test:" in ln:
            out["test_psnr"].append(float(ln.split("PSNR ")[1]))
        elif ln.startswith("end2end total_time:"):
            out["end2end"] = (float(ln.split("total_time: ")[1].split(" s")[0]),
                              float(ln.split("throughput ")[1].split(" it/s")[0]))
        elif " ms over " in ln and ": sum " in ln:
            key, rest = ln.split(": sum ")
            ms, calls = rest.split(" ms over ")
            out["timers"][key] = (float(ms), int(calls.split()[0]))
        elif ln.startswith("Initialized "):
            out["initialized"] = int(ln.split()[1])
    return out


def _fill_flag_words(torch):
    from clm_gs_tpu_torch.ops import fill

    st = fill._FLAGS.get(torch.device("cuda", torch.cuda.current_device()))
    return 0 if st is None else st[0].numel()


def fill_regrow_check(torch):
    """The fill's look-back flags are reallocated when a call needs more
    blocks than they hold: calls just past the current size, then smaller
    ones on the regrown flags, each exactly equal to the plain version."""
    from clm_gs_tpu_torch.ops import fill

    g = torch.Generator(device="cpu").manual_seed(5)
    sizes = []
    for n in (_fill_flag_words(torch) * fill.FLAG_SLOTS + 4099, 1_000_003, 77):
        x = torch.randint(1, 9, (3, n), dtype=torch.int32, generator=g)
        x[:, torch.rand(n, generator=g) < 0.7] = 0
        x = x.cuda()
        check(torch.equal(fill.forward_fill_cuda(x), fill.forward_fill_plain(x)),
              f"fill differs from its plain version at n = {n} after regrowth")
        sizes.append([n, _fill_flag_words(torch)])
    return {"n_and_flag_words": sizes, "exact": True}


def _flag(args, name):
    return args[args.index(name) + 1]


def densify_probe(torch, scene, work):
    """Rows `count_densify` gives at each gradient threshold on the state
    that the cli run's first densification round sees: FULL_TRAIN_ARGS run
    to that round with densification deferred (its statistics still
    accumulate) and no eval. This is how FULL_TRAIN_ARGS got its
    --densify_grad_threshold."""
    from clm_gs_tpu_torch.config import parse_config
    from clm_gs_tpu_torch.data.readers import read_colmap_scene
    from clm_gs_tpu_torch.models.densify import count_densify
    from clm_gs_tpu_torch.train import main as train_main
    from clm_gs_tpu_torch.utils.synthetic_colmap import FULL_TRAIN_ARGS

    start = int(_flag(FULL_TRAIN_ARGS, "--densify_from_iter"))
    every = int(_flag(FULL_TRAIN_ARGS, "--densification_interval"))
    first = (start // every + 1) * every
    never = str(10**9)
    argv = (["-s", scene, "-m", f"{work}/probe", "--decode_dataset_path",
             f"{work}/decoded", "--quiet", "--do_not_save"] + FULL_TRAIN_ARGS
            + ["--iterations", str(first), "--densify_from_iter", never,
               "--densify_until_iter", never, "--test_iterations", never])
    cfg = parse_config(argv)
    extent = read_colmap_scene(scene, eval_split=True, llffhold=cfg.aux.llffhold
                               ).nerf_normalization["radius"]
    state, _ = train_main(argv)
    return {"iteration": first, "gaussians": state.n_alive, "extent": extent,
            "new_rows": {str(t): count_densify(state, t, cfg.opt.percent_dense, extent)
                         for t in PROBE_THRESHOLDS}}


def final_state_checks(torch, state, scene, decoded):
    """Each kernel against its plain version at the shapes the end of the
    cli run gives it: the final state (segment reduce's n is its capacity)
    seen by the first train camera, against that camera's ground truth."""
    from clm_gs_tpu_torch.data.cameras import stack_cameras
    from clm_gs_tpu_torch.data.dataset import load_raw_image
    from clm_gs_tpu_torch.data.readers import read_colmap_scene
    from clm_gs_tpu_torch.utils.synthetic_colmap import FULL_TRAIN_ARGS

    llffhold = int(_flag(FULL_TRAIN_ARGS, "--llffhold"))
    cam = read_colmap_scene(scene, eval_split=True, llffhold=llffhold).train_cameras[0]
    dev = state.params.xyz.device
    gt = torch.from_numpy(load_raw_image(decoded, cam.image_name, cam.width,
                                         cam.height)).to(dev).float()[None] / 255.0
    bg = torch.zeros(3, device=dev)
    out = kernel_checks(torch, scene=(state, stack_cameras([cam], device=dev), gt, bg),
                        timed=False)
    out["shape"]["camera"] = cam.image_name
    return out


def cli_run(torch, work, scene):
    """`main` of clm_gs_tpu_torch.train on the full synthetic scene in
    `work` (launch counts over the run), each kernel against its plain
    version on the final state, then `python -m clm_gs_tpu_torch.train`
    resuming from its checkpoint; checks the run's log, PLY and log2csv."""
    from pathlib import Path

    from clm_gs_tpu_torch import _build
    from clm_gs_tpu_torch.models import gaussians as G
    from clm_gs_tpu_torch.train import main as train_main
    from clm_gs_tpu_torch.utils.synthetic_colmap import FULL_TRAIN_ARGS

    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    probe = densify_probe(torch, scene, work)
    probe["s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    out = f"{work}/run"
    argv = ["-s", scene, "-m", out, "--decode_dataset_path",
            f"{work}/decoded", "--quiet"] + FULL_TRAIN_ARGS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flags_before = _fill_flag_words(torch)
    _build.reset_launches()
    t0 = time.perf_counter()
    state, _ = train_main(argv)
    run_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    flags_after = _fill_flag_words(torch)
    log = _parse_log(Path(out, "python.log").read_text())

    ply = Path(out, "point_cloud", "iteration_200", "point_cloud.ply")
    with open(ply, "rb") as f:
        head = f.read(4096).decode("ascii", errors="replace")
    ply_rows = int(head.split("element vertex ")[1].split()[0])
    alive = state.alive
    back = G.load_ply(str(ply), device=state.params.xyz.device)
    ply_equal = all(torch.equal(getattr(back.params, f)[back.alive],
                                getattr(state.params, f)[alive])
                    for f in ("xyz", "opacity", "log_scale", "quat", "sh"))
    n_end = state.n_alive
    del back, alive
    t0 = time.perf_counter()
    final = final_state_checks(torch, state, scene, f"{work}/decoded")
    final["s"] = time.perf_counter() - t0
    del state
    torch.cuda.empty_cache()
    l2c = subprocess.run(
        [sys.executable, str(root / "release_scripts" / "log2csv.py"), out,
         "-o", f"{work}/r.csv"], capture_output=True, text=True, check=False,
        timeout=120)
    csv_rows = []
    if l2c.returncode == 0:
        with open(f"{work}/r.csv", newline="") as f:
            csv_rows = list(csv.DictReader(f))

    ckpt = Path(out, "checkpoints", "101")
    out2 = f"{work}/resume"
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "clm_gs_tpu_torch.train", "-s", scene, "-m", out2,
         "--decode_dataset_path", f"{work}/decoded", "--quiet",
         "--start_checkpoint", str(ckpt), "--do_not_save"]
        + [a for a in FULL_TRAIN_ARGS if a != "--enable_timer"],
        cwd=root, capture_output=True, text=True, check=False, timeout=600)
    resume_s = time.perf_counter() - t0
    log2_text = (Path(out2, "python.log").read_text()
                 if Path(out2, "python.log").exists() else "")
    log2 = _parse_log(log2_text)

    steps = log["timers"].get("train_step", (0.0, 0))[1]
    tm = {k: v[0] / max(v[1], 1) for k, v in log["timers"].items()}
    e2e_s, it_s = log["end2end"] or (float("nan"), float("nan"))
    timer_ms = lambda keys: sum(log["timers"].get(k, (0.0, 0))[0] for k in keys)
    loop_ms = timer_ms(("train_step", "data_next", "densify"))
    result = {
        "phase": "cli", "args": FULL_TRAIN_ARGS,
        "width": 1237, "height": 822, "run_s": run_s,
        "gaussians_start": log.get("initialized"), "gaussians_end": n_end,
        "capacity_growths": log["capacity"], "densify_rounds": len(log["densify"]),
        "densify_counts": log["densify"], "resets": log["resets"],
        "test_psnr": log["test_psnr"], "losses": log["losses"], "n3dgs": log["n3dgs"],
        "end2end_s": e2e_s, "it_per_s": it_s, "steps": steps,
        "timer_mean_ms": tm, "timer_sum_ms": {k: v[0] for k, v in log["timers"].items()},
        "timer_calls": {k: v[1] for k, v in log["timers"].items()},
        "host_ms_per_step": (e2e_s * 1e3 - loop_ms) / max(steps, 1),
        # end2end less every timer span inside it: the LR tensor, the
        # loss read and the schedule
        "remainder_ms_per_step": (e2e_s * 1e3 - timer_ms(SPANS_IN_END2END))
        / max(steps, 1),
        "densify_probe": probe,
        "final_state_kernels": {
            "shape": final["shape"], "s": final["s"],
            **{k: {f: final[k][f] for f in ("max_abs_err", "rel_err", "tol", "n")
                   if f in final[k]} for k in KERNELS}},
        "peak_device_bytes": peak, "launches": launches,
        "fill_flag_words": [flags_before, flags_after],
        "fill_regrow": fill_regrow_check(torch),
        "ply_rows": ply_rows, "ply_equal": ply_equal, "log2csv": csv_rows,
        "resume": {"rc": res.returncode, "s": resume_s,
                   "resumed": "Resumed from" in log2_text,
                   "end2end": log2["end2end"], "test_psnr": log2["test_psnr"],
                   "densify_counts": log2["densify"]},
    }
    if res.returncode != 0:
        print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
    finite = all(v == v and abs(v) != float("inf") for v in log["losses"])
    check(finite and log["losses"], f"cli: losses {log['losses']}")
    check(all(launches.get(k, 0) > 0 for k in KERNELS),
          f"cli: a kernel of the path never launched: {launches}")
    check(n_end > (log.get("initialized") or n_end), "cli: the model did not grow")
    check(log["capacity"], "cli: the model never outgrew its first capacity")
    check(log["resets"] >= 1, "cli: no reset_opacity line")
    check(len(log["test_psnr"]) >= 2 and log["test_psnr"][-1] > log["test_psnr"][0],
          f"cli: test PSNR did not rise: {log['test_psnr']}")
    check(ply_rows == n_end and ply_equal,
          f"cli: PLY rows {ply_rows} vs n_alive {n_end}, equal {ply_equal}")
    check(len(csv_rows) == 1 and all(csv_rows[0][k] for k in (
        "test_psnr", "train_psnr", "num_3dgs", "total_time_s", "throughput")),
          f"cli: log2csv: rc {l2c.returncode} {l2c.stderr[-500:]} {csv_rows}")
    last = (log2_text.rstrip().splitlines() or [""])[-1]
    check(res.returncode == 0 and result["resume"]["resumed"]
          and last.startswith("end2end total_time:"),
          f"cli: the resumed call failed (rc {res.returncode}): {last}")
    return result


# float32 columns of a Gaussian's parameters: xyz 3, opacity 1, log_scale 3,
# quat 4, sh 48; naive_offload moves them up and their gradients down once
# a batch
PARAM_COLS = 59


def naive_step(torch, box, lrs, adam_cfg):
    """Phase 4's scene, popped from `box` so that its device parameters can
    be freed, through one no_offload.train_step and one
    naive_offload.train_one_batch from the same parameters and the same
    seeded moments (on the card for the one, on the host for the other)."""
    from clm_gs_tpu_torch import _build
    from clm_gs_tpu_torch.config import Config, init_config
    from clm_gs_tpu_torch.strategies import naive_offload as naive
    from clm_gs_tpu_torch.strategies.no_offload import train_step
    from clm_gs_tpu_torch.utils.native import host_threads
    from clm_gs_tpu_torch.utils.timer import Timer

    state, cb, gts, bg = box.pop()
    w, h, C = cb.width, cb.height, state.capacity
    dev = state.alive.device
    cfg = Config()
    cfg.aux.naive_offload = True
    init_config(cfg)
    opt = _seeded_moments(torch, state.params, dev)
    ctx = naive.make_context(cfg, state, adam_cfg)
    for f, cols in naive.GROUP_COLS.items():
        ctx.adams[f].exp_avg = getattr(opt.mu, f).reshape(C, cols).cpu()
        ctx.adams[f].exp_avg_sq = getattr(opt.nu, f).reshape(C, cols).cpu()
        ctx.adams[f].step_count = int(opt.steps)
    p0 = {f: t.clone() for f, t in ctx.params_host.items()}
    mu0 = {f: a.exp_avg.clone() for f, a in ctx.adams.items()}

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_no, o_no, out_no = train_step(state, opt, cb, gts, 3, lrs, adam_cfg, bg, w, h)
    losses_no = out_no.losses.cpu()
    no_offload_s = time.perf_counter() - t0
    moves_no = {f: (getattr(s_no.params, f) - getattr(state.params, f)).reshape(
        C, cols).cpu() for f, cols in naive.GROUP_COLS.items()}
    mu_no = {f: getattr(o_no.mu, f).reshape(C, cols).cpu()
             for f, cols in naive.GROUP_COLS.items()}
    del s_no, o_no, out_no, opt

    # the device copy of the parameters goes: the host buffers hold them
    state = naive.strip_device_params(state)
    host_lrs = {k: v.cpu() for k, v in lrs.items()}
    timers = Timer(enabled=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    _build.reset_launches()
    t0 = time.perf_counter()
    state, _, ctx, out = naive.train_one_batch(
        state, None, ctx, cb, gts, 3, host_lrs, adam_cfg, bg, w, h, cfg, timers=timers)
    losses = out.losses.cpu()
    naive_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    after = torch.cuda.memory_allocated()
    peak = torch.cuda.max_memory_allocated()

    loss_rel = ((losses - losses_no).abs() / losses_no.abs()).max().item()
    # The two Adams order their float32 operations differently, so an
    # update that differs in its last bits can round p - update to the
    # neighbouring float: moves may differ by one unit in the last place of
    # the parameter beyond TOL["step_rel"] of the group's largest move. The
    # first moments hold the gradients without that rounding.
    step_rel, ulp_rel, grad_rel = {}, {}, {}
    for f, d in moves_no.items():
        diff = (ctx.params_host[f] - p0[f] - d).abs()
        big = torch.maximum(p0[f].abs(), ctx.params_host[f].abs())
        ulp = torch.nextafter(big, torch.full_like(big, float("inf"))) - big
        scale = d.abs().max().clamp_min(1e-30)
        step_rel[f] = (diff.max() / scale).item()
        ulp_rel[f] = ((diff - ulp).clamp_min(0).max() / scale).item()
        g_scale = (mu_no[f] - 0.9 * mu0[f]).abs().max().clamp_min(1e-30)
        grad_rel[f] = ((ctx.adams[f].exp_avg - mu_no[f]).abs().max() / g_scale).item()
    param_bytes = PARAM_COLS * 4 * C
    result = {
        "phase": "naive_step", "gaussians": state.n_alive, "capacity": C,
        "cameras": gts.shape[0], "width": w, "height": h,
        "losses": losses.tolist(), "no_offload_losses": losses_no.tolist(),
        "loss_rel_err": loss_rel, "param_step_rel_err": step_rel,
        "param_step_rel_err_past_one_ulp": ulp_rel, "grad_rel_err": grad_rel,
        "tol": [TOL["loss_rel"], TOL["step_rel"]],
        "naive_s": naive_s, "no_offload_s": no_offload_s,
        "span_ms": {k: timers.sums[k] * 1e3 for k in ("naive.grads", "naive.d2h_adam")},
        "bytes_h2d": param_bytes, "bytes_d2h": param_bytes,
        "host_threads": host_threads(), "param_bytes": param_bytes,
        "memory_allocated_before": before, "memory_allocated_after": after,
        "max_memory_allocated": peak, "launches": launches,
    }
    check(bool(torch.isfinite(losses).all()) and loss_rel <= TOL["loss_rel"]
          and max(ulp_rel.values()) <= TOL["step_rel"]
          and max(grad_rel.values()) <= TOL["step_rel"],
          f"naive_step against no_offload: loss {loss_rel}, steps past one ulp "
          f"{ulp_rel}, first moments {grad_rel}")
    check(after < param_bytes,
          f"naive_step: {after} bytes on the card after the batch, the parameters "
          f"take {param_bytes}")
    check(all(launches.get(k, 0) > 0 for k in KERNELS),
          f"naive_step: a kernel of the path never launched: {launches}")
    # the next phase starts from this batch's parameters, on the card
    box.append((naive.materialize(state, ctx), cb, gts, bg))
    return result


def naive_cli_run(torch, work, scene, cli):
    """`main` of clm_gs_tpu_torch.train under --naive_offload on the scene
    and decoded images of phase 7 in `work` (launch counts over the run),
    then `python -m clm_gs_tpu_torch.train --naive_offload` resuming from its
    checkpoint to iteration 120; checked against phase 7's result `cli`."""
    from pathlib import Path

    from clm_gs_tpu_torch import _build
    from clm_gs_tpu_torch.models import gaussians as G
    from clm_gs_tpu_torch.train import main as train_main
    from clm_gs_tpu_torch.utils.native import host_threads
    from clm_gs_tpu_torch.utils.synthetic_colmap import FULL_TRAIN_ARGS

    root = Path(__file__).resolve().parent
    args = [a for a in FULL_TRAIN_ARGS if a != "--no_offload"] + ["--naive_offload"]
    out = f"{work}/naive"
    argv = ["-s", scene, "-m", out, "--decode_dataset_path", f"{work}/decoded",
            "--quiet"] + args
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    state, opt = train_main(argv)
    run_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log = _parse_log(Path(out, "python.log").read_text())

    ply = Path(out, "point_cloud", "iteration_200", "point_cloud.ply")
    back = G.load_ply(str(ply), device=state.alive.device)
    ply_equal = all(torch.equal(getattr(back.params, f)[back.alive],
                                getattr(state.params, f)[state.alive])
                    for f in ("xyz", "opacity", "log_scale", "quat", "sh"))
    ply_rows, n_end, cap_end = back.n_alive, state.n_alive, state.capacity
    del back, state
    torch.cuda.empty_cache()

    ckpt = Path(out, "checkpoints", "101")
    extra_saved = Path(ckpt, "strategy_extra.npz").exists()
    out2 = f"{work}/naive_resume"
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "clm_gs_tpu_torch.train", "-s", scene, "-m", out2,
         "--decode_dataset_path", f"{work}/decoded", "--quiet",
         "--start_checkpoint", str(ckpt), "--do_not_save"]
        + [a for a in args if a != "--enable_timer"] + ["--iterations", "120"],
        cwd=root, capture_output=True, text=True, check=False, timeout=600)
    resume_s = time.perf_counter() - t0
    log2_text = (Path(out2, "python.log").read_text()
                 if Path(out2, "python.log").exists() else "")
    log2 = _parse_log(log2_text)

    steps = log["timers"].get("train_step", (0.0, 0))[1]
    e2e_s, it_s = log["end2end"] or (float("nan"), float("nan"))
    psnr_gap = ((log["test_psnr"] or [float("nan")])[-1] - cli["test_psnr"][-1])
    result = {
        "phase": "naive", "args": args, "run_s": run_s,
        "gaussians_start": log.get("initialized"), "gaussians_end": n_end,
        "cli_gaussians_end": cli["gaussians_end"], "capacity_end": cap_end,
        "capacity_growths": log["capacity"], "densify_counts": log["densify"],
        "resets": log["resets"], "test_psnr": log["test_psnr"],
        "final_test_psnr_minus_cli": psnr_gap, "losses": log["losses"],
        "n3dgs": log["n3dgs"], "end2end_s": e2e_s, "it_per_s": it_s,
        "cli_it_per_s": cli["it_per_s"], "steps": steps,
        "timer_mean_ms": {k: v[0] / max(v[1], 1) for k, v in log["timers"].items()},
        "timer_calls": {k: v[1] for k, v in log["timers"].items()},
        "bytes_each_way_per_batch_at_end": PARAM_COLS * 4 * cap_end,
        "host_threads": host_threads(),
        "peak_device_bytes": peak, "cli_peak_device_bytes": cli["peak_device_bytes"],
        "launches": launches, "ply_rows": ply_rows, "ply_equal": ply_equal,
        "resume": {"rc": res.returncode, "s": resume_s, "strategy_extra": extra_saved,
                   "resumed": "Resumed from" in log2_text,
                   "end2end": log2["end2end"], "test_psnr": log2["test_psnr"],
                   "densify_counts": log2["densify"]},
    }
    if res.returncode != 0:
        print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
    finite = all(v == v and abs(v) != float("inf") for v in log["losses"])
    check(finite and log["losses"] and opt is None, f"naive: losses {log['losses']}")
    check(all(launches.get(k, 0) > 0 for k in KERNELS),
          f"naive: a kernel of the path never launched: {launches}")
    check(log["capacity"], "naive: the model never outgrew its first capacity")
    check(log["resets"] >= 1, "naive: no reset_opacity line")
    check(len(log["test_psnr"]) >= 2 and log["test_psnr"][-1] > log["test_psnr"][0]
          and abs(psnr_gap) <= TOL["naive_psnr_db"],
          f"naive: test PSNR {log['test_psnr']}, {psnr_gap} dB from the cli run's")
    check(ply_rows == n_end == log["n3dgs"][-1] and ply_equal,
          f"naive: PLY rows {ply_rows}, n_alive {n_end}, last n3dgs "
          f"{log['n3dgs'][-1]}, equal {ply_equal}")
    check(peak < cli["peak_device_bytes"],
          f"naive: device peak {peak} not below the cli run's {cli['peak_device_bytes']}")
    last = (log2_text.rstrip().splitlines() or [""])[-1]
    check(res.returncode == 0 and result["resume"]["resumed"] and extra_saved
          and last.startswith("end2end total_time:"),
          f"naive: the resumed call failed (rc {res.returncode}, strategy_extra.npz "
          f"{extra_saved}): {last}")
    return result


# clm_offload keeps the 48 SH floats of a Gaussian, their gradients and
# their two moments on the host
SH_COLS = 48
GROUPS = ("xyz", "opacity", "log_scale", "quat", "sh")
CLM_SPANS = ("clm.filters", "clm.order", "clm.fetch_h2d", "clm.micro", "clm.advance",
             "clm.d2h_scatter")
# clm_step's variants: (name, retention, --pinned_host)
CLM_VARIANTS = (("retention", True, False), ("full_regather", False, False),
                ("card_gather", True, True))
# warm batches of each variant, in turns; the warm figures are their median
CLM_WARM_TURNS = 5
# In a fresh process (the caching host allocator holds no block yet): the
# seconds to allocate a pinned (rows, 48) float32 buffer, as grow_context
# does, and to zero it; then the same again, served from the cache.
PIN_PROBE = """
import json, sys, time, torch
rows = int(sys.argv[1])
torch.zeros(1, device="cuda")
out = {}
for name in ("fresh", "cached"):
    t0 = time.perf_counter()
    buf = torch.empty((rows, 48), dtype=torch.float32, pin_memory=True)
    out[name + "_pin_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    buf.zero_()
    out[name + "_zero_s"] = time.perf_counter() - t0
    del buf
print(json.dumps(out))
"""


def _tensor_bytes(torch, obj) -> int:
    """Bytes of every tensor in a state or optimizer state."""
    import dataclasses

    if torch.is_tensor(obj):
        return obj.numel() * obj.element_size()
    if dataclasses.is_dataclass(obj):
        return sum(_tensor_bytes(torch, getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    return 0


def _moves_against(torch, got_params, got_mu, p0, mu0, moves_no, mu_no):
    """Parameter moves past one unit in the last place, and first moments,
    against no_offload's, relative to each group's largest (naive_step's
    measure)."""
    ulp_rel, grad_rel = {}, {}
    for f, d in moves_no.items():
        diff = (got_params[f] - p0[f] - d).abs()
        big = torch.maximum(p0[f].abs(), got_params[f].abs())
        ulp = torch.nextafter(big, torch.full_like(big, float("inf"))) - big
        scale = d.abs().max().clamp_min(1e-30)
        ulp_rel[f] = ((diff - ulp).clamp_min(0).max() / scale).item()
        g_scale = (mu_no[f] - 0.9 * mu0[f]).abs().max().clamp_min(1e-30)
        grad_rel[f] = ((got_mu[f] - mu_no[f]).abs().max() / g_scale).item()
    return ulp_rel, grad_rel


def clm_step(torch, box, lrs, adam_cfg):
    """The state phase 6 leaves in `box`, through one no_offload.train_step
    and clm_offload.train_one_batch with retention, without it, and with
    retention and --pinned_host's card-side gather, all from the same seeded
    moments (the SH ones on the host for clm). For each variant, batches
    from that start on one context: the first (staging buffers allocated),
    CLM_WARM_TURNS warm ones in turns with the other variants (the median's
    times, bytes, overlap meter) and one with --enable_timer's spans. Then the gather kernel against its plain version
    and the host-staged fetch it replaces on camera 0's visible rows."""
    from dataclasses import replace

    from clm_gs_tpu_torch import _build
    from clm_gs_tpu_torch.config import Config, init_config
    from clm_gs_tpu_torch.optim import AdamState
    from clm_gs_tpu_torch.strategies import clm_offload as clm
    from clm_gs_tpu_torch.strategies.no_offload import train_step
    from clm_gs_tpu_torch.utils.native import host_threads
    from clm_gs_tpu_torch.utils.timer import Timer

    state, cb, gts, bg = box.pop()
    w, h, C = cb.width, cb.height, state.capacity
    dev = state.alive.device
    opt = _seeded_moments(torch, state.params, dev)

    def rows(t):
        return t.reshape(C, -1).cpu()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_no, o_no, out_no = train_step(state, opt, cb, gts, 3, lrs, adam_cfg, bg, w, h)
    losses_no = torch.sort(out_no.losses.cpu()).values
    no_offload_s = time.perf_counter() - t0
    p0 = {f: rows(getattr(state.params, f)) for f in GROUPS}
    mu0 = {f: rows(getattr(opt.mu, f)) for f in GROUPS}
    moves_no = {f: rows(getattr(s_no.params, f)) - p0[f] for f in GROUPS}
    mu_no = {f: rows(getattr(o_no.mu, f)) for f in GROUPS}
    no_bytes = _tensor_bytes(torch, s_no) + _tensor_bytes(torch, o_no)
    del s_no, o_no, out_no

    sh_nu0 = opt.nu.sh.cpu()
    s = clm.strip_device_sh(state)

    def placeholder():
        return torch.zeros((1, SH_COLS), device=dev)

    o = AdamState(replace(opt.mu, sh=placeholder()), replace(opt.nu, sh=placeholder()),
                  opt.steps)
    clm_bytes = _tensor_bytes(torch, s) + _tensor_bytes(torch, o)
    host_lrs = dict(lrs, sh=lrs["sh"].cpu())

    arriving = []  # rows arriving at each transition of a batch
    down = []  # gradient rows going down at each camera of a batch
    permuted = []  # rows of a flush whose int32 permutation went up
    classify = clm._classify_transition
    download, scatter, flush = clm._download, clm._scatter, clm._flush

    def counted(prev_ids, next_ids):
        out = classify(prev_ids, next_ids)
        arriving.append(len(out[3]))
        return out

    def counted_down(fn):
        def wrapper(ctx, rows, *args):
            down.append(rows.shape[0])
            return fn(ctx, rows, *args)
        return wrapper

    def counted_flush(ctx, grad_buf, ids_dev, ids_host, departed=None):
        out = flush(ctx, grad_buf, ids_dev, ids_host, departed)
        if 0 < out[2] < len(ids_host):
            permuted.append(len(ids_host))
        return out

    def batch(cfg, ctx, timed):
        """One batch from the seeded start (the state and moments cloned),
        the context reset to it."""
        arriving.clear()
        down.clear()
        permuted.clear()
        ctx.sh_host.copy_(p0["sh"])
        ctx.sh_grad_host.zero_()
        ctx.adam.exp_avg, ctx.adam.exp_avg_sq = mu0["sh"].clone(), sh_nu0.clone()
        ctx.adam.step_count = int(opt.steps)
        ctx.trailing_s = ctx.scatter_work_s = ctx.adam_work_s = 0.0
        ctx.n_batches = ctx.h2d_bytes = ctx.d2h_bytes = 0
        ctx.scatter_rows = ctx.stored_rows = 0
        timers = Timer(enabled=timed)
        s1, o1 = _clone(torch, s), _clone(torch, o)  # the batch updates them in place
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        s2, o2, ctx, out = clm.train_one_batch(s1, o1, ctx, cb, gts, 3, host_lrs,
                                               adam_cfg, bg, w, h, cfg, timers=timers)
        losses = torch.sort(out.losses.cpu()).values
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t0
        params = {f: rows(getattr(s2.params, f)) for f in GROUPS[:4]}
        params["sh"] = ctx.sh_host.clone()
        mu = {f: rows(getattr(o2.mu, f)) for f in GROUPS[:4]}
        mu["sh"] = ctx.adam.exp_avg.clone()
        ulp_rel, grad_rel = _moves_against(torch, params, mu, p0, mu0, moves_no, mu_no)
        run = {
            "batch_s": batch_s, "order_losses_sorted": losses.tolist(),
            "loss_rel_err": ((losses - losses_no).abs() / losses_no.abs()).max().item(),
            "param_step_rel_err_past_one_ulp": ulp_rel, "grad_rel_err": grad_rel,
            "h2d_bytes": ctx.h2d_bytes, "d2h_bytes": ctx.d2h_bytes,
            "trailing_s": ctx.trailing_s, "scatter_work_s": ctx.scatter_work_s,
            "adam_work_s": ctx.adam_work_s,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "launches": dict(_build.LAUNCHES), "arriving_rows": sum(arriving),
            "down_rows": sum(down), "scatter_rows": ctx.scatter_rows,
            "stored_rows": ctx.stored_rows, "permuted_rows": sum(permuted),
        }
        if timed:
            run["span_ms"] = {k: timers.sums[k] * 1e3 for k in CLM_SPANS if k in timers.sums}
            run["span_calls"] = {k: timers.counts[k] for k in CLM_SPANS
                                 if k in timers.counts}
        return run, params, mu, losses

    # every variant's first batch, then the warm batches of the variants in
    # turns (forward, then reverse order), then each one's timed batch: a
    # batch's time depends on the host's other load, which drifts
    cfgs, ctxs = {}, {}
    for key, retention, pinned in CLM_VARIANTS:
        cfg = cfgs[key] = Config()
        cfg.aux.clm_offload = True
        cfg.tpu.retention = retention
        cfg.tpu.pinned_host = pinned
        init_config(cfg)
    keys = list(cfgs)
    clm._classify_transition = counted
    clm._download, clm._scatter = counted_down(download), counted_down(scatter)
    clm._flush = counted_flush
    try:
        for key in keys:
            ctxs[key] = clm.make_context(cfgs[key], state, adam_cfg)
        first = {key: batch(cfgs[key], ctxs[key], False) for key in keys}
        warm = {key: [] for key in keys}
        for turn in range(CLM_WARM_TURNS):
            for key in keys if turn % 2 == 0 else keys[::-1]:
                warm[key].append(batch(cfgs[key], ctxs[key], False)[0])
        timed = {key: batch(cfgs[key], ctxs[key], True)[0] for key in keys}
    finally:
        clm._classify_transition = classify
        clm._download, clm._scatter, clm._flush = download, scatter, flush
        for ctx in ctxs.values():
            ctx.close()
    runs, finals = {}, {}
    for key in keys:
        ws = sorted(warm[key], key=lambda r: r["batch_s"])
        median = dict(ws[len(ws) // 2], warm_batches_s=[r["batch_s"] for r in warm[key]])
        runs[key] = {"first": first[key][0], "warm": median, "timed": timed[key]}
        finals[key] = first[key][1:]
        for r in warm[key]:  # each warm batch from the same start: the same bytes
            check(r["h2d_bytes"] == median["h2d_bytes"]
                  and r["d2h_bytes"] == median["d2h_bytes"]
                  and r["order_losses_sorted"] == median["order_losses_sorted"],
                  f"clm_step {key}: warm batches differ")
    gather = gather_check(torch, s, cb, w, h, ctxs)
    scatter_k = scatter_check(torch, s, cb, w, h, ctxs)
    del ctxs
    # the card-side gather and scatter against the host gather and scatter,
    # to the bit: a gather is a copy, and both paths sum the same rows in
    # the same order
    host_p, host_mu, host_l = finals["retention"]
    card_p, card_mu, card_l = finals["card_gather"]
    card_equal = {f: torch.equal(card_p[f], host_p[f]) and torch.equal(card_mu[f], host_mu[f])
                  for f in GROUPS}
    card_equal["losses"] = torch.equal(card_l, host_l)
    bytes_vs_host = {when: {"h2d_minus_host": runs["card_gather"][when]["h2d_bytes"]
                            - runs["retention"][when]["h2d_bytes"],
                            "arriving_id_bytes": 4 * runs["card_gather"][when]["arriving_rows"],
                            # the rows the scatter reads back for its add:
                            # those it does not store into a zero slot
                            "scatter_read_bytes": ROW_BYTES * (
                                runs["card_gather"][when]["down_rows"]
                                - runs["card_gather"][when]["stored_rows"]),
                            "permutation_bytes": 4 * runs["card_gather"][when]["permuted_rows"],
                            "first_departure_share": runs["card_gather"][when]["stored_rows"]
                            / max(1, runs["card_gather"][when]["scatter_rows"]),
                            "d2h_minus_host": runs["card_gather"][when]["d2h_bytes"]
                            - runs["retention"][when]["d2h_bytes"]}
                     for when in ("first", "warm", "timed")}
    spans_vs_host = {k: [runs["retention"]["timed"]["span_ms"].get(k),
                         runs["card_gather"]["timed"]["span_ms"].get(k)] for k in CLM_SPANS}
    finals = {k: v[0] for k, v in finals.items()}
    ret_rel = max(((finals["retention"][f] - finals["full_regather"][f]).abs().max()
                   / moves_no[f].abs().max().clamp_min(1e-30)).item() for f in GROUPS)
    result = {
        "phase": "clm_step", "gaussians": state.n_alive, "capacity": C,
        "cameras": gts.shape[0], "width": w, "height": h,
        "no_offload_losses_sorted": losses_no.tolist(), "no_offload_s": no_offload_s,
        "runs": runs, "retention_vs_full_rel": ret_rel,
        "state_and_moment_bytes": {"no_offload": no_bytes, "clm_offload": clm_bytes,
                                   "saved": no_bytes - clm_bytes,
                                   "sh_param_bytes": C * SH_COLS * 4},
        "host_threads": host_threads(),
        "tol": [TOL["loss_rel"], TOL["step_rel"], TOL["retention_rel"]],
        "launches": runs["retention"]["first"]["launches"],
        "card_gather_launches": runs["card_gather"]["first"]["launches"],
        "card_gather_equal_to_host_gather": card_equal,
        "card_gather_bytes_vs_host": bytes_vs_host,
        "spans_ms_host_vs_card_gather": spans_vs_host,
        "pinned_gather": gather,
        "pinned_scatter": scatter_k,
    }
    for key, r in runs.items():
        for when, run in r.items():
            check(run["loss_rel_err"] <= TOL["loss_rel"]
                  and max(run["param_step_rel_err_past_one_ulp"].values()) <= TOL["step_rel"]
                  and max(run["grad_rel_err"].values()) <= TOL["step_rel"],
                  f"clm_step {key} {when} against no_offload: loss "
                  f"{run['loss_rel_err']}, steps past one ulp "
                  f"{run['param_step_rel_err_past_one_ulp']}, first moments "
                  f"{run['grad_rel_err']}")
            check(all(run["launches"].get(k, 0) > 0 for k in KERNELS),
                  f"clm_step {key} {when}: a kernel of the path never launched: "
                  f"{run['launches']}")
    check(ret_rel <= TOL["retention_rel"],
          f"clm_step: retention against the full re-gather {ret_rel}")
    check(all(card_equal.values()),
          f"clm_step: the card-side gather differs from the host gather: {card_equal}")
    for when, b in bytes_vs_host.items():
        card_run = runs["card_gather"][when]
        check(b["h2d_minus_host"] == (b["arriving_id_bytes"] + b["scatter_read_bytes"]
                                      + b["permutation_bytes"])
              and b["arriving_id_bytes"] > 0 and b["d2h_minus_host"] == 0
              and 0 < card_run["stored_rows"] <= card_run["scatter_rows"]
              == card_run["down_rows"]
              and runs["card_gather"][when]["arriving_rows"]
              == runs["retention"][when]["arriving_rows"]
              and runs["card_gather"][when]["down_rows"]
              == runs["retention"][when]["down_rows"] > 0,
              f"clm_step: card-side gather and scatter bytes against the host path "
              f"({when}): {b}")
    for key, r in runs.items():
        for name in (GATHER, SCATTER):
            n = [run["launches"].get(name, 0) for run in r.values()]
            check(all(n) if key == "card_gather" else not any(n),
                  f"clm_step {key}: {name} launches {n}")
    check(runs["retention"]["warm"]["h2d_bytes"] < runs["full_regather"]["warm"]["h2d_bytes"],
          "clm_step: retention moved no fewer bytes up than the full re-gather")
    check(no_bytes - clm_bytes >= 3 * (C - 1) * SH_COLS * 4,
          f"clm_step: the clm state and moments take {clm_bytes} bytes, "
          f"no_offload's {no_bytes}")
    return result


def wall_ms(torch, fn, reps=5, warmup=1):
    """Host-clock time per call of `fn`, which involves the host (a read
    back, a host gather), from an idle card to the end of its work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def gather_check(torch, state, cb, w, h, ctxs):
    """csrc/pinned_gather.cu against its plain version on camera 0's visible
    rows of `state` (the ids the first fetch gives it), read out of the
    pinned SH table of the card-gather context: bit-equal, timed beside the
    plain version and the host-staged fetch it replaces (native.gather_rows
    into a pinned staging slot and its upload, the retention context's
    `_fetch`). The bound is the rows' bytes over the link's published
    host-to-card rate (PEAK_PCIE_H2D), or the ids' and output's bytes over
    HBM's, whichever is longer. Beside it, `h2d_bytes_per_s` is the rate a
    copy engine reaches here (a non-blocking copy_ of the whole table out
    of pinned memory), the achievable rate of a bulk upload."""
    from clm_gs_tpu_torch.strategies import clm_offload as clm
    from clm_gs_tpu_torch.strategies import offload_common as oc
    from clm_gs_tpu_torch.utils import hostmem

    p = state.params
    ids = oc.calculate_filters(p.xyz, p.quat, p.log_scale, state.alive, cb.viewmats[:1],
                               cb.Ks[:1], w, h, 0.0).ids[0]
    ids_host = ids.cpu()
    table = ctxs["card_gather"].sh_host
    host_ctx = ctxs["retention"]
    check(table.is_pinned() and not host_ctx.card_gather, "clm_step: gather contexts")
    k = hostmem.gather_rows_pinned_cuda(table, ids)
    torch.cuda.synchronize()
    plain = hostmem.gather_rows_pinned_plain(table, ids)
    staged = clm._fetch(host_ctx, None, ids_host)
    exact = torch.equal(k, plain) and torch.equal(staged, plain)
    check(exact, "pinned_gather differs from its plain version or the host-staged fetch")
    n = ids.numel()
    dst = torch.empty(table.shape, dtype=table.dtype, device=ids.device)
    copy_ms = time_ms(torch, lambda: dst.copy_(table, non_blocking=True), reps=5, warmup=1)
    h2d_rate = table.numel() * 4 / (copy_ms * 1e-3)
    del dst
    row_bytes = n * 48 * 4
    t_bus = row_bytes / PEAK_PCIE_H2D * 1e3
    t_hbm = (n * ids.element_size() + row_bytes) / PEAK_BYTES * 1e3
    ms = time_ms(torch, lambda: hostmem.gather_rows_pinned_cuda(table, ids), reps=10)
    return {
        "rows": n, "table_rows": table.shape[0], "row_bytes": row_bytes,
        "max_abs_err": (k - plain).abs().max().item() if n else 0.0, "exact": exact,
        "ms": ms, **pinned_grid_report(torch, hostmem.GATHER_BLOCKS, n, ms,
                                       max(t_bus, t_hbm)),
        "beside": pinned_beside(torch, table, ids, ("gather",)),
        "plain_ms": wall_ms(torch, lambda: hostmem.gather_rows_pinned_plain(table, ids)),
        "host_staged_fetch_ms": wall_ms(torch, lambda: clm._fetch(host_ctx, None, ids_host)),
        "h2d_copy_ms": copy_ms, "h2d_bytes_per_s": h2d_rate,
        "bound_ms": max(t_bus, t_hbm), "bound_by": "bytes",
        "bound_rates": {"bus": "PCIe Gen5 x16, 64e9 B/s host to card (NVIDIA data sheet)",
                        "hbm": "3.35e12 B/s"},
        "bound_parts_ms": {"bus": t_bus, "hbm": t_hbm},
        "library_ms": None,
    }


def pinned_grid_report(torch, most, n, ms, bound_ms):
    """A pinned kernel's launch geometry over n rows (hostmem.pinned_grid
    in at most `most` blocks, capped by this card's SMs) and its share of
    its bound."""
    from clm_gs_tpu_torch.utils import hostmem

    sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    blocks, rows_per_block = hostmem.pinned_grid(n, hostmem.launch_blocks(sms, most))
    return {"grid": {"blocks": blocks, "rows_per_block": rows_per_block,
                     "threads_per_block": 256, "sms": sms},
            "share_of_bound": bound_ms / ms}


# float32 matmuls of 4096 x 4096 timed beside a pinned kernel
BESIDE_MATMULS = 20


def pinned_beside(torch, table, ids, names, rows=None):
    """The card beside a pinned kernel (utils/pinned_probe.py `beside`):
    BESIDE_MATMULS matmuls alone and with the kernels `names` on a side
    stream, launched once first and back to back, each ratio a median over
    the median alone; `rows` (the scatter's) default to random ones.
    Timing, not gated."""
    from clm_gs_tpu_torch.utils import pinned_probe

    if rows is None:
        rows = torch.rand((ids.numel(), SH_COLS), device=ids.device)
    res = pinned_probe.beside(pinned_probe._kernels(table, rows, ids), BESIDE_MATMULS, names)
    return {k: v if k not in names else {
        f: v[f] for f in ("kernel_alone_ms", "once_ratio", "stream_ratio",
                          "stream_kernel_ratio")} for k, v in res.items()}


def scatter_check(torch, state, cb, w, h, ctxs):
    """csrc/pinned_scatter.cu on camera 0's visible rows of `state` (the ids
    its flush gives the kernel), into the pinned SH-gradient table of the
    card-gather context (`scatter_kernel_check`)."""
    from clm_gs_tpu_torch.strategies import offload_common as oc

    p = state.params
    ids = oc.calculate_filters(p.xyz, p.quat, p.log_scale, state.alive, cb.viewmats[:1],
                               cb.Ks[:1], w, h, 0.0).ids[0]
    table = ctxs["card_gather"].sh_grad_host
    check(table.is_pinned() and ctxs["card_gather"].card_gather, "clm_step: scatter context")
    return scatter_kernel_check(torch, table, ids)


def scatter_kernel_check(torch, table, ids, reps=10):
    """csrc/pinned_scatter.cu against its plain version on the pinned (C,
    48) `table` at `ids` (unique, on the card), the table and the rows
    random: adding and storing, bit-equal over the whole table. Then the
    kernel timed adding and storing, beside the plain version and the host
    path it replaces: the rows downloaded into a pinned slot on a comm
    stream (`clm_offload._download`), the wait for its event and
    native.scatter_add_rows. The bound is the rows' bytes over the link's
    published rate a direction (PEAK_PCIE_H2D; adding moves them up for the
    read and down for the write, at once), or the ids' and rows' bytes over
    HBM's, whichever is longer. Beside it, `d2h_bytes_per_s` is the rate a
    copy engine reaches here card to pinned memory (a non-blocking copy_ of
    the whole table), the achievable rate of a bulk download."""
    from clm_gs_tpu_torch.config import Config, init_config
    from clm_gs_tpu_torch.strategies import clm_offload as clm
    from clm_gs_tpu_torch.utils import hostmem, native

    dev = ids.device
    n = ids.numel()
    gen = torch.Generator(device=dev).manual_seed(11)
    rows = torch.rand((n, SH_COLS), generator=gen, device=dev)
    start = torch.rand(tuple(table.shape), generator=gen, device=dev)
    exact, err = {}, 0.0
    touched = ids.cpu().long()
    # the split: the first half of the rows stored into zero slots
    half = n // 2
    start[ids[:half].long()] = 0.0
    start_host = start.cpu()
    for name, accumulate, n_store in (("add", True, 0), ("store", False, 0),
                                      ("split", True, half)):
        table.copy_(start)
        hostmem.scatter_add_rows_pinned_cuda(table, rows, ids, accumulate, n_store)
        torch.cuda.synchronize()
        want = start_host.clone()
        hostmem.scatter_add_rows_pinned_plain(want, rows, ids, accumulate, n_store)
        exact[name] = torch.equal(table.view(torch.int32), want.view(torch.int32))
        err = max(err, (table[touched] - want[touched]).abs().max().item())
        del want
    del start_host
    check(all(exact.values()), f"pinned_scatter differs from its plain version: {exact}")
    ms = time_ms(torch, lambda: hostmem.scatter_add_rows_pinned_cuda(table, rows, ids),
                 reps=reps)
    store_ms = time_ms(torch, lambda: hostmem.scatter_add_rows_pinned_cuda(
        table, rows, ids, False), reps=reps)
    split_ms = time_ms(torch, lambda: hostmem.scatter_add_rows_pinned_cuda(
        table, rows, ids, True, half), reps=reps)
    plain_ms = wall_ms(torch, lambda: hostmem.scatter_add_rows_pinned_plain(table, rows, ids),
                       reps=3)
    # the host path's own context: its comm stream and download slots
    ctx = clm._context(table, None, dev, init_config(Config()))
    ctx.sh_grad_host = table
    ids_host = ids.cpu()

    def host_path():
        host, landed = clm._download(ctx, rows)
        if landed is not None:
            landed.synchronize()
        native.scatter_add_rows(table, host, ids_host)

    try:
        host_ms = wall_ms(torch, host_path)
    finally:
        ctx.close()
    copy_ms = time_ms(torch, lambda: table.copy_(start, non_blocking=True), reps=3, warmup=1)
    del start
    row_bytes = n * ROW_BYTES
    t_bus = row_bytes / PEAK_PCIE_H2D * 1e3
    t_hbm = (n * ids.element_size() + row_bytes) / PEAK_BYTES * 1e3
    bound = max(t_bus, t_hbm)
    return {
        "rows": n, "table_rows": table.shape[0], "row_bytes": row_bytes,
        "max_abs_err": err, "exact": exact, "ms": ms, "store_ms": store_ms,
        # the first half stored into zero slots, the rest added
        "split_half_ms": split_ms,
        **pinned_grid_report(torch, hostmem.SCATTER_BLOCKS, n, ms, bound),
        "store_share_of_bound": bound / store_ms,
        "beside": pinned_beside(torch, table, ids, ("scatter_add", "scatter_store"), rows),
        "plain_ms": plain_ms, "host_path_ms": host_ms,
        "d2h_copy_ms": copy_ms, "d2h_bytes_per_s": table.numel() * 4 / (copy_ms * 1e-3),
        "bound_ms": bound, "bound_by": "bytes",
        "bound_rates": {"bus": "PCIe Gen5 x16, 64e9 B/s each way (NVIDIA data sheet)",
                        "hbm": "3.35e12 B/s"},
        "bound_parts_ms": {"bus": t_bus, "hbm": t_hbm},
        "library_ms": None,
    }


def clm_cli_run(torch, work, scene, cli, naive):
    """`main` of clm_gs_tpu_torch.train under --clm_offload on the scene and
    decoded images of phase 7 in `work` (launch counts over the run, the
    context's bytes and overlap meter read from its last batch), then
    `python -m clm_gs_tpu_torch.train --clm_offload` resuming from its
    checkpoint to iteration 120; checked against phase 7's result `cli` and
    reported beside phase 8's `naive`."""
    from pathlib import Path

    from clm_gs_tpu_torch import _build
    from clm_gs_tpu_torch.models import gaussians as G
    from clm_gs_tpu_torch.strategies import clm_offload as clm
    from clm_gs_tpu_torch.train import main as train_main
    from clm_gs_tpu_torch.utils.native import host_threads
    from clm_gs_tpu_torch.utils.synthetic_colmap import FULL_TRAIN_ARGS

    root = Path(__file__).resolve().parent
    args = [a for a in FULL_TRAIN_ARGS if a != "--no_offload"] + ["--clm_offload"]
    out = f"{work}/clm"
    argv = ["-s", scene, "-m", out, "--decode_dataset_path", f"{work}/decoded",
            "--quiet"] + args
    last_ctx = []
    real = clm.train_one_batch

    def spy(*a, **k):
        res = real(*a, **k)
        last_ctx[:] = [res[2]]
        return res

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    clm.train_one_batch = spy
    t0 = time.perf_counter()
    try:
        state, opt = train_main(argv)
    finally:
        clm.train_one_batch = real
    run_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    text = Path(out, "python.log").read_text()
    log = _parse_log(text)
    overlap = [ln for ln in text.splitlines() if ln.startswith("clm overlap: ")]
    ctx = last_ctx[0]

    ply = Path(out, "point_cloud", "iteration_200", "point_cloud.ply")
    back = G.load_ply(str(ply), device=state.alive.device)
    # the run returns its SH field as the host buffer (`materialize_host`)
    ply_equal = all(torch.equal(getattr(back.params, f)[back.alive],
                                getattr(state.params, f).cuda()[state.alive])
                    for f in GROUPS)
    ply_rows, n_end, cap_end = back.n_alive, state.n_alive, state.capacity
    placeholder = [tuple(opt.mu.sh.shape), tuple(opt.nu.sh.shape)]
    del back, state, opt
    torch.cuda.empty_cache()

    ckpt = Path(out, "checkpoints", "101")
    extra_saved = Path(ckpt, "strategy_extra.npz").exists()
    out2 = f"{work}/clm_resume"
    t0 = time.perf_counter()
    # with --pinned_host: the card gathers every SH row it fetches, through
    # the CLI, restore_extra's new pinned buffer, the growth and eval
    res = subprocess.run(
        [sys.executable, "-c", RUN_MODULE, "clm_gs_tpu_torch.train", "-s", scene,
         "-m", out2, "--decode_dataset_path", f"{work}/decoded", "--quiet",
         "--start_checkpoint", str(ckpt), "--do_not_save", "--pinned_host"]
        + [a for a in args if a != "--enable_timer"] + ["--iterations", "120"],
        cwd=root, capture_output=True, text=True, check=False, timeout=600)
    resume_s = time.perf_counter() - t0
    resume_run = _module_run(res)
    log2_text = (Path(out2, "python.log").read_text()
                 if Path(out2, "python.log").exists() else "")
    log2 = _parse_log(log2_text)
    said = [ln for ln in log2_text.splitlines() if ln.startswith("pinned_host:")]
    # the growth's page-locking: this process's host cache still holds the
    # naive phase's freed pinned buffers, which grow_context reuses
    probe = subprocess.run([sys.executable, "-c", PIN_PROBE, str(cap_end)],
                           capture_output=True, text=True, check=False, timeout=120)

    steps = log["timers"].get("train_step", (0.0, 0))[1]
    e2e_s, it_s = log["end2end"] or (float("nan"), float("nan"))
    psnr_gap = ((log["test_psnr"] or [float("nan")])[-1] - cli["test_psnr"][-1])
    nb = max(ctx.n_batches, 1)
    result = {
        "phase": "clm", "args": args, "run_s": run_s,
        "gaussians_start": log.get("initialized"), "gaussians_end": n_end,
        "cli_gaussians_end": cli["gaussians_end"],
        "naive_gaussians_end": naive["gaussians_end"], "capacity_end": cap_end,
        "capacity_growths": log["capacity"], "densify_counts": log["densify"],
        "resets": log["resets"], "test_psnr": log["test_psnr"],
        "final_test_psnr_minus_cli": psnr_gap, "losses": log["losses"],
        "n3dgs": log["n3dgs"], "end2end_s": e2e_s, "it_per_s": it_s,
        "cli_it_per_s": cli["it_per_s"], "naive_it_per_s": naive["it_per_s"],
        "steps": steps,
        "timer_mean_ms": {k: v[0] / max(v[1], 1) for k, v in log["timers"].items()},
        "timer_calls": {k: v[1] for k, v in log["timers"].items()},
        "batches": ctx.n_batches, "h2d_bytes_per_batch": ctx.h2d_bytes / nb,
        "d2h_bytes_per_batch": ctx.d2h_bytes / nb,
        "trailing_ms_per_batch": ctx.trailing_s / nb * 1e3,
        "scatter_work_ms_per_batch": ctx.scatter_work_s / nb * 1e3,
        "adam_work_ms_per_batch": ctx.adam_work_s / nb * 1e3,
        "overlap_line": overlap[-1] if overlap else None,
        "host_threads": host_threads(), "sh_placeholder_moments": placeholder,
        "pin_probe": {"rows": cap_end, "rc": probe.returncode,
                      **(json.loads(probe.stdout.strip().splitlines()[-1])
                         if probe.returncode == 0 else {})},
        "peak_device_bytes": peak, "cli_peak_device_bytes": cli["peak_device_bytes"],
        "naive_peak_device_bytes": naive["peak_device_bytes"],
        "launches": launches, "ply_rows": ply_rows, "ply_equal": ply_equal,
        "resume": {"rc": res.returncode, "s": resume_s, "strategy_extra": extra_saved,
                   "resumed": "Resumed from" in log2_text,
                   "end2end": log2["end2end"], "test_psnr": log2["test_psnr"],
                   "densify_counts": log2["densify"], "pinned_host_line": said,
                   "launches": resume_run["launches"],
                   "peak_device_bytes": resume_run["peak_device_bytes"]},
    }
    if res.returncode != 0:
        print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
    finite = all(v == v and abs(v) != float("inf") for v in log["losses"])
    check(finite and log["losses"], f"clm: losses {log['losses']}")
    check(all(launches.get(k, 0) > 0 for k in KERNELS),
          f"clm: a kernel of the path never launched: {launches}")
    check(log["capacity"], "clm: the model never outgrew its first capacity")
    check(log["resets"] >= 1, "clm: no reset_opacity line")
    check(len(log["test_psnr"]) >= 2 and log["test_psnr"][-1] > log["test_psnr"][0]
          and abs(psnr_gap) <= TOL["clm_psnr_db"],
          f"clm: test PSNR {log['test_psnr']}, {psnr_gap} dB from the cli run's")
    check(ply_rows == n_end == log["n3dgs"][-1] and ply_equal,
          f"clm: PLY rows {ply_rows}, n_alive {n_end}, last n3dgs "
          f"{log['n3dgs'][-1]}, equal {ply_equal}")
    check(placeholder == [(1, SH_COLS)] * 2, f"clm: SH moments on the card {placeholder}")
    check(probe.returncode == 0, f"clm: the pinning probe failed: {probe.stderr[-500:]}")
    check(peak < cli["peak_device_bytes"],
          f"clm: device peak {peak} not below the cli run's {cli['peak_device_bytes']}")
    check(overlap and ctx.n_batches == steps and ctx.h2d_bytes > 0 and ctx.d2h_bytes > 0,
          f"clm: overlap lines {len(overlap)}, batches {ctx.n_batches} of {steps}")
    last = (log2_text.rstrip().splitlines() or [""])[-1]
    check(res.returncode == 0 and result["resume"]["resumed"] and extra_saved
          and last.startswith("end2end total_time:"),
          f"clm: the resumed call failed (rc {res.returncode}, strategy_extra.npz "
          f"{extra_saved}): {last}")
    psnr2 = log2["test_psnr"]
    check(len(said) == 1 and "card-side SH gather and gradient scatter on" in said[0]
          and "csrc/pinned_gather.cu" in said[0] and "csrc/pinned_scatter.cu" in said[0],
          f"clm: the --pinned_host resume's log says {said}")
    check(len(psnr2) >= 2 and psnr2[-1] > psnr2[0],
          f"clm: the --pinned_host resume's test PSNR did not rise: {psnr2}")
    check(resume_run["launches"].get(GATHER, 0) > 0
          and resume_run["launches"].get(SCATTER, 0) > 0
          and all(resume_run["launches"].get(k, 0) > 0 for k in KERNELS),
          f"clm: the --pinned_host resume's launches {resume_run['launches']}")
    return result


# The mesh phases: parallel/ on one card (world 1, mesh 1x1), and across the
# host's cards where it has more than one.
MESH_SHAPES = {2: ("1x2", "2x1"), 4: ("1x2", "2x1", "2x2")}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mesh_errors(torch, p0, mu0, single, sharded):
    """The sharded step's result against no_offload's from the same state:
    `single` and `sharded` are (state, opt_state, StepOut) with every row."""
    (s1, o1, out1), (s2, o2, out2) = single, sharded
    l1, l2 = out1.losses.sort().values, out2.losses.sort().values
    step_rel = grad_rel = 0.0
    for f in GROUPS:
        d1 = getattr(s1.params, f) - getattr(p0, f)
        d2 = getattr(s2.params, f) - getattr(p0, f)
        step_rel = max(step_rel, ((d2 - d1).abs().max()
                                  / d1.abs().max().clamp_min(1e-30)).item())
        g = (getattr(o1.mu, f) - 0.9 * getattr(mu0, f)).abs().max().clamp_min(1e-30)
        grad_rel = max(grad_rel, ((getattr(o2.mu, f) - getattr(o1.mu, f)).abs().max()
                                  / g).item())
    a1, a2 = s1.xyz_grad_accum, s2.xyz_grad_accum
    seen = a1 > 1e-3 * a1.max()
    return {"loss_rel": ((l2 - l1).abs() / l1.abs()).max().item(),
            "param_step_rel": step_rel, "grad_rel": grad_rel,
            "accum_rel": ((a2 - a1).abs().max() / a1.abs().max()).item(),
            # the JAX package's sharded step gives n_gauss here
            "accum_increment_ratio": (a2[seen] / a1[seen]).median().item(),
            "denom_equal": torch.equal(s1.denom, s2.denom),
            "visible_equal": torch.equal(out1.visible_any, out2.visible_any),
            "n_isects_equal": tuple(out1.n_isects) == tuple(out2.n_isects)}


def _mesh_ok(e):
    return (e["loss_rel"] <= TOL["mesh_loss_rel"] and e["param_step_rel"] <= TOL["mesh_step_rel"]
            and e["grad_rel"] <= TOL["mesh_grad_rel"] and e["accum_rel"] <= TOL["mesh_accum_rel"]
            and e["denom_equal"] and e["visible_equal"] and e["n_isects_equal"])


def _timed_steps(torch, fn, st, op, n=5):
    """n steps of fn from (st, op); seconds each (a sync after each)."""
    secs = []
    for _ in range(n):
        t0 = time.perf_counter()
        st, op, _ = fn(st, op)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return secs


def mesh_rank_check(torch, shape, time_single):
    """On this rank's card, inside a started process group: the bench scene
    with seeded moments through one no_offload.train_step and one sharded
    step of `shape`, compared; then 5 timed no_offload steps (when
    `time_single`) and 5 timed sharded steps, with each block's peak memory
    and the kernels' launches over the sharded steps."""
    from clm_gs_tpu_torch import _build
    from clm_gs_tpu_torch.parallel import mesh as M
    from clm_gs_tpu_torch.parallel.shard import make_sharded_train_step
    from clm_gs_tpu_torch.strategies.no_offload import train_step
    from clm_gs_tpu_torch.utils.bench_scene import make_scene

    mesh = M.make_mesh(shape, "cuda")
    state, _, cb, gts, lrs, cfg, bg = make_scene()
    opt = _seeded_moments(torch, state.params, "cuda")
    w, h, C, n_alive = cb.width, cb.height, state.capacity, state.n_alive
    single = train_step(state, opt, cb, gts, 3, lrs, cfg, bg, w, h)
    sharded = make_sharded_train_step(mesh, w, h)
    sh_state = M.shard_state(state, mesh)
    sh_opt = M.shard_capacity_tree(opt, mesh, C)
    rank_bytes = _tensor_bytes(torch, sh_state) + _tensor_bytes(torch, sh_opt)
    s2, o2, out2 = sharded(sh_state, sh_opt, cb, gts, 3, lrs, cfg, bg)
    del sh_state, sh_opt
    rows = s2.capacity
    whole = (M.gather_capacity_tree(s2, mesh, rows), M.gather_capacity_tree(o2, mesh, rows),
             out2._replace(visible_any=M.gather_capacity_tree(out2.visible_any, mesh, rows)))
    errors = _mesh_errors(torch, state.params, opt.mu, single, whole)
    losses = out2.losses.tolist()
    del whole, state, opt
    torch.cuda.empty_cache()
    result = {"shape": shape, "mesh": mesh.shape, "rank": mesh.data_index * mesh.n_gauss
              + mesh.gauss_index, "device": torch.cuda.current_device(),
              "gaussians": int(n_alive), "width": w, "height": h, "cameras": gts.shape[0],
              "rows": rows, "capacity": C, "rank_state_bytes": rank_bytes,
              "losses": losses, "max_shard_vis": out2.max_shard_vis,
              "n_isects": list(out2.n_isects), "errors": errors}
    if time_single:
        torch.cuda.reset_peak_memory_stats()
        result["single_step_s"] = _timed_steps(
            torch, lambda st, op: train_step(st, op, cb, gts, 3, lrs, cfg, bg, w, h),
            single[0], single[1])
        result["single_peak_device_bytes"] = torch.cuda.max_memory_allocated()
    del single
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    result["sharded_step_s"] = _timed_steps(
        torch, lambda st, op: sharded(st, op, cb, gts, 3, lrs, cfg, bg), s2, o2)
    result["launches"] = dict(_build.LAUNCHES)
    result["sharded_peak_device_bytes"] = torch.cuda.max_memory_allocated()
    return result


def _mesh_rank(rank, world, port, shape, results, kind="no_offload"):
    """A spawned rank of the multi-card check (`kind`: mesh_rank_check or
    clm_mesh_rank_check): one card, NCCL."""
    import torch
    import torch.distributed as dist

    rank_check = {"no_offload": mesh_rank_check, "clm": clm_mesh_rank_check}[kind]
    try:
        torch.cuda.set_device(rank)
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank,
                                device_id=torch.device("cuda", rank))
        try:
            results.put((rank, rank_check(torch, shape, time_single=False)))
        finally:
            dist.destroy_process_group()
    except Exception as e:  # reported to the parent, which fails the phase
        results.put((rank, {"error": f"{type(e).__name__}: {e}"}))


def mesh_ranks(shape, world, timeout=240, kind="no_offload"):
    """mesh_rank_check (or with kind "clm" clm_mesh_rank_check) at `shape` in
    `world` spawned processes, one a card; every process is joined or
    stopped before this returns."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_mesh_rank, args=(r, world, port, shape, results, kind))
             for r in range(world)]
    for p in procs:
        p.start()
    out = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world and time.monotonic() < deadline:
            try:
                rank, res = results.get(timeout=5)
            except queue.Empty:
                # a rank that died without reporting leaves the others waiting
                # in a collective for it
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                continue
            out[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30 if len(out) == world else 5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return [out.get(r, {"error": f"no result (exit code {procs[r].exitcode})"})
            for r in range(world)]


def mesh_step(torch):
    """Phase 6c: the sharded step in a world-1 NCCL process group on this
    card (mesh 1x1) against no_offload.train_step, timed beside it; then the
    multi-card meshes where the host has the cards."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0, device_id=torch.device("cuda", 0))
    try:
        one = mesh_rank_check(torch, "1x1", time_single=True)
    finally:
        dist.destroy_process_group()
    cards = torch.cuda.device_count()
    ranks, ranks_s = {}, {}
    if cards >= 2:
        world = 4 if cards >= 4 else 2
        for shape in MESH_SHAPES[world]:
            t0 = time.perf_counter()
            ranks[shape] = mesh_ranks(shape, int(shape[0]) * int(shape[2]))
            ranks_s[shape] = time.perf_counter() - t0
            print(f"mesh_step: {shape} took {ranks_s[shape]:.1f} s", flush=True)
            torch.cuda.empty_cache()
    else:
        print(f"mesh_step: only world 1 (mesh 1x1) was run: the host has {cards} "
              "card; 1x2, 2x1 and 2x2 need 2 or 4", flush=True)
    e = one["errors"]
    result = {
        "phase": "mesh_step", "process_group": "nccl, world 1", "shape": "1x1",
        **{k: one[k] for k in ("gaussians", "capacity", "cameras", "width", "height")},
        "losses": one["losses"], "errors": e,
        "tol": {k: v for k, v in TOL.items() if k.startswith("mesh_") and k != "mesh_psnr_db"},
        "single_step_s": one["single_step_s"], "sharded_step_s": one["sharded_step_s"],
        "single_median_step_s": statistics.median(one["single_step_s"]),
        "sharded_median_step_s": statistics.median(one["sharded_step_s"]),
        "single_peak_device_bytes": one["single_peak_device_bytes"],
        "sharded_peak_device_bytes": one["sharded_peak_device_bytes"],
        "rank_state_bytes": one["rank_state_bytes"], "max_shard_vis": one["max_shard_vis"],
        "launches": one["launches"], "cards": cards, "ranks_s": ranks_s,
        "ranks": {shape: [{k: r.get(k) for k in (
            "rank", "device", "mesh", "rows", "rank_state_bytes", "sharded_step_s",
            "sharded_peak_device_bytes", "max_shard_vis", "errors", "launches", "error")}
            for r in rs] for shape, rs in ranks.items()},
    }
    check(_mesh_ok(e) and abs(e["accum_increment_ratio"] - 1.0) <= TOL["mesh_accum_rel"],
          f"mesh_step 1x1 against no_offload: {e}")
    check(all(one["launches"].get(k, 0) > 0 for k in KERNELS),
          f"mesh_step: a kernel of the path never launched: {one['launches']}")
    for shape, rs in ranks.items():
        for r in rs:
            check("error" not in r, f"mesh_step {shape} rank: {r.get('error')}")
            check(_mesh_ok(r["errors"])
                  and abs(r["errors"]["accum_increment_ratio"] - 1.0) <= TOL["mesh_accum_rel"],
                  f"mesh_step {shape} rank {r['rank']} against no_offload: {r['errors']}")
            check(r["rows"] * r["mesh"]["gauss"] == one["capacity"],
                  f"mesh_step {shape}: rank {r['rank']} holds {r['rows']} rows")
    return result


# The clm mesh phases: clm_offload on the (data x gauss) mesh, the host SH
# rows of a rank's gauss shard in its own host memory.
CLM_MESH_TURNS = 3


def _host_bytes(ctx) -> int:
    """Bytes of a clm context's host state: SH rows, gradients, moments."""
    return sum(t.numel() * t.element_size() for t in (
        ctx.sh_host, ctx.sh_grad_host, ctx.adam.exp_avg, ctx.adam.exp_avg_sq))


def clm_mesh_rank_check(torch, shape, time_single):
    """On this rank's card, inside a started process group: the bench scene
    with seeded moments (the SH ones on the host) through one
    clm_offload.train_one_batch on this process alone and one on the
    `shape` mesh (the state, card moments and context cut to the rank's
    shard), compared; the mesh batch again with --pinned_host, to the bit.
    Then CLM_MESH_TURNS batches of the mesh (and, when `time_single`, of the
    single process, in turns), timed, with peak memory, the data sum's meter
    and the rank's host and card bytes; the launches are the first mesh
    batch's."""
    from dataclasses import replace

    from clm_gs_tpu_torch import _build
    from clm_gs_tpu_torch.config import Config, init_config
    from clm_gs_tpu_torch.optim import AdamState
    from clm_gs_tpu_torch.parallel import mesh as M
    from clm_gs_tpu_torch.strategies import clm_offload as clm
    from clm_gs_tpu_torch.utils.bench_scene import make_scene

    mesh = M.make_mesh(shape, "cuda")
    state, _, cb, gts, lrs, adam_cfg, bg = make_scene()
    opt = _seeded_moments(torch, state.params, "cuda")
    w, h, C, n_alive = cb.width, cb.height, state.capacity, state.n_alive
    host_lrs = dict(lrs, sh=lrs["sh"].cpu())
    s0 = clm.strip_device_sh(state)

    def placeholder():
        return torch.zeros((1, SH_COLS), device="cuda")

    o0 = AdamState(replace(opt.mu, sh=placeholder()), replace(opt.nu, sh=placeholder()),
                   opt.steps)
    sh_mu0, sh_nu0 = opt.mu.sh.cpu(), opt.nu.sh.cpu()

    def start(pinned, on_mesh):
        """A context at the seeded start (cut to the rank's shard on the
        mesh), and a copy of the stripped state and card moments to give
        it."""
        cfg = Config()
        cfg.aux.clm_offload = True
        cfg.tpu.pinned_host = pinned
        init_config(cfg)
        ctx = clm.make_context(cfg, state, adam_cfg)
        ctx.adam.exp_avg, ctx.adam.exp_avg_sq = sh_mu0.clone(), sh_nu0.clone()
        ctx.adam.step_count = int(opt.steps)
        st, op = _clone(torch, s0), _clone(torch, o0)  # a batch updates them in place
        if not on_mesh:
            return cfg, ctx, st, op
        clm.shard_context(ctx, mesh)
        return cfg, ctx, M.shard_state(st, mesh), M.shard_capacity_tree(op, mesh, C)

    def batch(cfg, ctx, st, op):
        s2, o2, ctx, out = clm.train_one_batch(st, op, ctx, cb, gts, 3, host_lrs,
                                               adam_cfg, bg, w, h, cfg)
        torch.cuda.synchronize()
        return s2, o2, out

    def full(ctx, st, op, out):
        """(state, moments, StepOut) with every row, the SH ones uploaded
        from the host; instance counts sorted (the chains' order is
        step-major)."""
        if ctx.mesh is not None:
            rows = st.capacity
            st, op = (M.gather_capacity_tree(st, mesh, rows),
                      M.gather_capacity_tree(op, mesh, rows))
            out = out._replace(visible_any=M.gather_capacity_tree(out.visible_any, mesh,
                                                                   rows))
        mu_sh = clm.checkpoint_extra(ctx)["clm.exp_avg"]
        op = replace(op, mu=replace(op.mu, sh=torch.from_numpy(mu_sh).cuda()))
        return (clm.materialize(st, ctx), op,
                out._replace(n_isects=tuple(sorted(out.n_isects))))

    cfg1, ctx1, st1, op1 = start(False, False)
    single = batch(cfg1, ctx1, st1, op1)
    cfgm, ctxm, stm, opm = start(False, True)
    rank_card_bytes = _tensor_bytes(torch, stm) + _tensor_bytes(torch, opm)
    rank_host_bytes = _host_bytes(ctxm)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    sharded = batch(cfgm, ctxm, stm, opm)
    first_mesh_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    cfgp, ctxp, stp, opp = start(True, True)
    _build.reset_launches()
    pinned = batch(cfgp, ctxp, stp, opp)
    pinned_launches = dict(_build.LAUNCHES)
    pinned_equal = {"losses": torch.equal(pinned[2].losses, sharded[2].losses),
                    "sh_host": torch.equal(ctxp.sh_host, ctxm.sh_host),
                    "sh_exp_avg": torch.equal(ctxp.adam.exp_avg, ctxm.adam.exp_avg),
                    "sh_exp_avg_sq": torch.equal(ctxp.adam.exp_avg_sq, ctxm.adam.exp_avg_sq)}
    for f in GROUPS[:4]:
        pinned_equal[f] = (torch.equal(getattr(pinned[0].params, f),
                                       getattr(sharded[0].params, f))
                           and torch.equal(getattr(pinned[1].mu, f),
                                           getattr(sharded[1].mu, f)))
    ctxp.close()
    del pinned, stp, opp
    errors = _mesh_errors(torch, state.params, opt.mu, full(ctx1, *single),
                          full(ctxm, *sharded))
    losses = sharded[2].losses.tolist()
    n_isects = list(sharded[2].n_isects)
    del state, opt, s0, o0, st1, op1, stm, opm
    torch.cuda.empty_cache()

    # timed batches from where the first ones left the state, in turns
    runs = {"mesh": [cfgm, ctxm, *sharded[:2], []]}
    if time_single:
        runs["single"] = [cfg1, ctx1, *single[:2], []]
    else:
        ctx1.close()
    del single, sharded
    ctxm.data_sum_s = ctxm.data_sum_bytes = ctxm.n_batches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    peaks = {k: 0 for k in runs}
    keys = list(runs)
    for turn in range(CLM_MESH_TURNS):
        for k in keys if turn % 2 == 0 else keys[::-1]:
            cfg, ctx, st, op, secs = runs[k]
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            st, op, _ = batch(cfg, ctx, st, op)
            secs.append(time.perf_counter() - t0)
            peaks[k] = max(peaks[k], torch.cuda.max_memory_allocated())
            runs[k][2:4] = [st, op]
    nb = max(ctxm.n_batches, 1)
    result = {"shape": shape, "mesh": mesh.shape,
              "rank": mesh.data_index * mesh.n_gauss + mesh.gauss_index,
              "device": torch.cuda.current_device(), "gaussians": int(n_alive),
              "width": w, "height": h, "cameras": gts.shape[0], "capacity": C,
              "rows": ctxm.sh_host.shape[0], "rank_host_bytes": rank_host_bytes,
              "rank_card_bytes": rank_card_bytes, "losses": losses,
              "n_isects": n_isects, "errors": errors, "first_mesh_batch_s": first_mesh_s,
              "mesh_batch_s": runs["mesh"][4],
              "mesh_peak_device_bytes": peaks["mesh"],
              "data_sum_ms_per_batch": ctxm.data_sum_s / nb * 1e3,
              "data_sum_bytes_per_batch": ctxm.data_sum_bytes / nb,
              "pinned_equal_to_host_gather": pinned_equal,
              "launches": launches, "pinned_launches": pinned_launches}
    if time_single:
        result["single_batch_s"] = runs["single"][4]
        result["single_peak_device_bytes"] = peaks["single"]
    for k in runs:
        runs[k][1].close()
    return result


def clm_mesh_step(torch):
    """Phase 6d: clm_offload's batch on a 1x1 mesh in a world-1 NCCL process
    group on this card, against the single-process batch, timed beside it;
    then the multi-card meshes where the host has the cards."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0, device_id=torch.device("cuda", 0))
    try:
        one = clm_mesh_rank_check(torch, "1x1", time_single=True)
    finally:
        dist.destroy_process_group()
    cards = torch.cuda.device_count()
    ranks, ranks_s = {}, {}
    if cards >= 2:
        world = 4 if cards >= 4 else 2
        for shape in MESH_SHAPES[world]:
            t0 = time.perf_counter()
            ranks[shape] = mesh_ranks(shape, int(shape[0]) * int(shape[2]), kind="clm")
            ranks_s[shape] = time.perf_counter() - t0
            print(f"clm_mesh_step: {shape} took {ranks_s[shape]:.1f} s", flush=True)
            torch.cuda.empty_cache()
    else:
        print(f"clm_mesh_step: only world 1 (mesh 1x1) was run: the host has {cards} "
              "card; 1x2, 2x1 and 2x2 need 2 or 4", flush=True)
    e = one["errors"]
    result = {
        "phase": "clm_mesh_step", "process_group": "nccl, world 1", "shape": "1x1",
        **{k: one[k] for k in ("gaussians", "capacity", "cameras", "width", "height",
                               "losses", "n_isects", "errors", "rank_host_bytes",
                               "rank_card_bytes", "first_mesh_batch_s", "mesh_batch_s",
                               "single_batch_s", "mesh_peak_device_bytes",
                               "single_peak_device_bytes", "launches", "pinned_launches",
                               "pinned_equal_to_host_gather")},
        "tol": {k: v for k, v in TOL.items() if k.startswith("clm_mesh_")},
        "single_median_batch_s": statistics.median(one["single_batch_s"]),
        "mesh_median_batch_s": statistics.median(one["mesh_batch_s"]),
        "cards": cards, "ranks_s": ranks_s,
        "ranks": {shape: [{k: r.get(k) for k in (
            "rank", "device", "mesh", "rows", "rank_host_bytes", "rank_card_bytes",
            "mesh_batch_s", "mesh_peak_device_bytes", "data_sum_ms_per_batch",
            "data_sum_bytes_per_batch", "errors", "pinned_equal_to_host_gather",
            "launches", "error")} for r in rs] for shape, rs in ranks.items()},
    }
    check(_clm_mesh_ok(e), f"clm_mesh_step 1x1 against the single process: {e}")
    check(all(one["pinned_equal_to_host_gather"].values()),
          f"clm_mesh_step: --pinned_host differs: {one['pinned_equal_to_host_gather']}")
    check(all(one["launches"].get(k, 0) > 0 for k in KERNELS)
          and one["pinned_launches"].get(GATHER, 0) > 0
          and one["pinned_launches"].get(SCATTER, 0) > 0
          and not one["launches"].get(GATHER, 0) and not one["launches"].get(SCATTER, 0),
          f"clm_mesh_step: launches {one['launches']}, pinned {one['pinned_launches']}")
    for shape, rs in ranks.items():
        for r in rs:
            check("error" not in r, f"clm_mesh_step {shape} rank: {r.get('error')}")
            check(_clm_mesh_ok(r["errors"]) and all(r["pinned_equal_to_host_gather"].values()),
                  f"clm_mesh_step {shape} rank {r['rank']}: {r['errors']}, "
                  f"{r['pinned_equal_to_host_gather']}")
            check(r["rows"] * r["mesh"]["gauss"] == one["capacity"]
                  and (r["data_sum_bytes_per_batch"] > 0) == (r["mesh"]["data"] > 1),
                  f"clm_mesh_step {shape}: rank {r['rank']} holds {r['rows']} rows, "
                  f"sums {r['data_sum_bytes_per_batch']} bytes a batch")
    return result


def _clm_mesh_ok(e):
    return (e["loss_rel"] <= TOL["clm_mesh_loss_rel"]
            and e["param_step_rel"] <= TOL["clm_mesh_step_rel"]
            and e["grad_rel"] <= TOL["clm_mesh_grad_rel"]
            and e["accum_rel"] <= TOL["clm_mesh_accum_rel"]
            and abs(e["accum_increment_ratio"] - 1.0) <= TOL["clm_mesh_accum_rel"]
            and e["denom_equal"] and e["visible_equal"] and e["n_isects_equal"])


def clm_mesh_cli_run(torch, work, scene, clm_run):
    """Phase 9c: `main` under --clm_offload with FULL_TRAIN_ARGS on the
    scene and decoded images of phase 7 in `work`, in a process group of one
    started by the --dist_* flags, --mesh_shape 1x1 (launch counts over the
    run; the densification's gathers of the whole state, card and host,
    timed); then `python -m clm_gs_tpu_torch.train --clm_offload` resuming
    its checkpoint on one card, without a process group, to iteration 120;
    checked against phase 9's `clm_run`."""
    from pathlib import Path

    import torch.distributed as dist

    from clm_gs_tpu_torch import _build
    from clm_gs_tpu_torch.models import gaussians as G
    from clm_gs_tpu_torch.strategies import clm_offload as clm
    from clm_gs_tpu_torch.train import main as train_main
    from clm_gs_tpu_torch.utils.synthetic_colmap import FULL_TRAIN_ARGS

    root = Path(__file__).resolve().parent
    base = [a for a in FULL_TRAIN_ARGS if a != "--no_offload"] + ["--clm_offload"]
    args = base + ["--mesh_shape", "1x1", "--dist_coordinator",
                   f"127.0.0.1:{_free_port()}", "--dist_num_processes", "1",
                   "--dist_process_id", "0"]
    out = f"{work}/clm_mesh"
    argv = ["-s", scene, "-m", out, "--decode_dataset_path", f"{work}/decoded",
            "--quiet"] + args
    last_ctx = []
    real = clm.train_one_batch

    def spy(*a, **k):
        res = real(*a, **k)
        last_ctx[:] = [res[2]]
        return res

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    clm.train_one_batch = spy
    t0 = time.perf_counter()
    try:
        state, opt = train_main(argv)
    finally:
        clm.train_one_batch = real
    run_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    group_left = dist.is_initialized()
    text = Path(out, "python.log").read_text()
    log = _parse_log(text)
    mesh_line = [ln for ln in text.splitlines() if ln.startswith("multi-chip mesh")]
    overlap = [ln for ln in text.splitlines() if ln.startswith("clm overlap: ")]

    ply = Path(out, "point_cloud", "iteration_200", "point_cloud.ply")
    back = G.load_ply(str(ply), device=state.alive.device)
    # the run returns its SH field as the host buffer (`materialize_host`)
    ply_equal = all(torch.equal(getattr(back.params, f)[back.alive],
                                getattr(state.params, f).cuda()[state.alive])
                    for f in GROUPS)
    ply_rows, n_end, cap_end = back.n_alive, state.n_alive, state.capacity
    placeholder = [tuple(opt.mu.sh.shape), tuple(opt.nu.sh.shape)]
    del back, state, opt
    torch.cuda.empty_cache()

    ckpt = Path(out, "checkpoints", "101")
    out2 = f"{work}/clm_mesh_resume"
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "clm_gs_tpu_torch.train", "-s", scene, "-m", out2,
         "--decode_dataset_path", f"{work}/decoded", "--quiet", "--start_checkpoint",
         str(ckpt), "--do_not_save"]
        + [a for a in base if a != "--enable_timer"] + ["--iterations", "120"],
        cwd=root, capture_output=True, text=True, check=False, timeout=600)
    resume_s = time.perf_counter() - t0
    log2_text = (Path(out2, "python.log").read_text()
                 if Path(out2, "python.log").exists() else "")
    log2 = _parse_log(log2_text)

    e2e_s, it_s = log["end2end"] or (float("nan"), float("nan"))
    psnr_gap = (log["test_psnr"] or [float("nan")])[-1] - clm_run["test_psnr"][-1]
    timers = {k: v for k, v in log["timers"].items()}
    gather = {k: timers.get(k, (0.0, 0)) for k in ("mesh.gather", "clm.host_gather",
                                                     "clm.host_shard", "densify")}
    result = {
        "phase": "clm_mesh", "args": args, "run_s": run_s, "mesh_line": mesh_line,
        "gaussians_start": log.get("initialized"), "gaussians_end": n_end,
        "clm_gaussians_end": clm_run["gaussians_end"], "capacity_end": cap_end,
        "capacity_growths": log["capacity"], "densify_counts": log["densify"],
        "clm_densify_counts": clm_run["densify_counts"], "resets": log["resets"],
        "test_psnr": log["test_psnr"], "final_test_psnr_minus_clm": psnr_gap,
        "losses": log["losses"], "end2end_s": e2e_s, "it_per_s": it_s,
        "clm_it_per_s": clm_run["it_per_s"],
        "timer_mean_ms": {k: v[0] / max(v[1], 1) for k, v in timers.items()},
        "densify_gather_ms_calls": gather,
        "host_gather_bytes": last_ctx[0].host_gather_bytes,
        "overlap_line": overlap[-1] if overlap else None,
        "peak_device_bytes": peak, "clm_peak_device_bytes": clm_run["peak_device_bytes"],
        "launches": launches, "ply_rows": ply_rows, "ply_equal": ply_equal,
        "sh_placeholder_moments": placeholder, "process_group_left": group_left,
        "resume": {"rc": res.returncode, "s": resume_s, "resumed": "Resumed from" in log2_text,
                   "mesh_line": "multi-chip mesh" in log2_text,
                   "end2end": log2["end2end"], "test_psnr": log2["test_psnr"]},
    }
    if res.returncode != 0:
        print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
    finite = all(v == v and abs(v) != float("inf") for v in log["losses"])
    check(finite and log["losses"], f"clm_mesh: losses {log['losses']}")
    check(mesh_line == ["multi-chip mesh (clm gauss sharding): {'data': 1, 'gauss': 1}"]
          and not group_left, f"clm_mesh: mesh line {mesh_line}, group left {group_left}")
    check(all(launches.get(k, 0) > 0 for k in KERNELS),
          f"clm_mesh: a kernel of the path never launched: {launches}")
    check(log["capacity"] and log["resets"] >= 1 and gather["clm.host_gather"][1] >= 1,
          f"clm_mesh: growths {log['capacity']}, resets {log['resets']}, gathers {gather}")
    check(len(log["test_psnr"]) >= 2 and log["test_psnr"][-1] > log["test_psnr"][0]
          and abs(psnr_gap) <= TOL["mesh_psnr_db"],
          f"clm_mesh: test PSNR {log['test_psnr']}, {psnr_gap} dB from the clm run's")
    check(ply_rows == n_end and ply_equal and placeholder == [(1, SH_COLS)] * 2,
          f"clm_mesh: PLY rows {ply_rows} vs {n_end}, equal {ply_equal}, "
          f"placeholder {placeholder}")
    last = (log2_text.rstrip().splitlines() or [""])[-1]
    check(res.returncode == 0 and result["resume"]["resumed"]
          and not result["resume"]["mesh_line"] and last.startswith("end2end total_time:"),
          f"clm_mesh: the single-card resume failed (rc {res.returncode}): {last}")
    return result


def mesh_cli_run(torch, work, scene, cli):
    """Phase 9b: `main` with FULL_TRAIN_ARGS on the scene and decoded images
    of phase 7 in `work`, in a process group of one started by the --dist_*
    flags, --mesh_shape 1x1 (launch counts over the run); then `python -m
    clm_gs_tpu_torch.train` resuming its checkpoint on one card, without a
    process group, to iteration 120; checked against phase 7's `cli`."""
    from pathlib import Path

    import torch.distributed as dist

    from clm_gs_tpu_torch import _build
    from clm_gs_tpu_torch.models import gaussians as G
    from clm_gs_tpu_torch.train import main as train_main
    from clm_gs_tpu_torch.utils.synthetic_colmap import FULL_TRAIN_ARGS

    root = Path(__file__).resolve().parent
    args = FULL_TRAIN_ARGS + ["--mesh_shape", "1x1", "--dist_coordinator",
                              f"127.0.0.1:{_free_port()}", "--dist_num_processes", "1",
                              "--dist_process_id", "0"]
    out = f"{work}/mesh"
    argv = ["-s", scene, "-m", out, "--decode_dataset_path", f"{work}/decoded",
            "--quiet"] + args
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    state, _ = train_main(argv)
    run_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    group_left = dist.is_initialized()
    text = Path(out, "python.log").read_text()
    log = _parse_log(text)
    mesh_line = [ln for ln in text.splitlines() if ln.startswith("multi-chip mesh:")]

    ply = Path(out, "point_cloud", "iteration_200", "point_cloud.ply")
    back = G.load_ply(str(ply), device=state.alive.device)
    ply_equal = all(torch.equal(getattr(back.params, f)[back.alive],
                                getattr(state.params, f)[state.alive]) for f in GROUPS)
    ply_rows, n_end = back.n_alive, state.n_alive
    del back, state
    torch.cuda.empty_cache()

    ckpt = Path(out, "checkpoints", "101")
    out2 = f"{work}/mesh_resume"
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "clm_gs_tpu_torch.train", "-s", scene, "-m", out2,
         "--decode_dataset_path", f"{work}/decoded", "--quiet", "--start_checkpoint",
         str(ckpt), "--do_not_save"]
        + [a for a in FULL_TRAIN_ARGS if a != "--enable_timer"] + ["--iterations", "120"],
        cwd=root, capture_output=True, text=True, check=False, timeout=600)
    resume_s = time.perf_counter() - t0
    log2_text = (Path(out2, "python.log").read_text()
                 if Path(out2, "python.log").exists() else "")
    log2 = _parse_log(log2_text)

    e2e_s, it_s = log["end2end"] or (float("nan"), float("nan"))
    psnr_gap = (log["test_psnr"] or [float("nan")])[-1] - cli["test_psnr"][-1]
    result = {
        "phase": "mesh", "args": args, "run_s": run_s, "mesh_line": mesh_line, "gaussians_start": log.get("initialized"),
        "gaussians_end": n_end, "cli_gaussians_end": cli["gaussians_end"],
        "capacity_growths": log["capacity"], "densify_counts": log["densify"],
        "cli_densify_counts": cli["densify_counts"], "resets": log["resets"],
        "test_psnr": log["test_psnr"], "final_test_psnr_minus_cli": psnr_gap,
        "losses": log["losses"], "end2end_s": e2e_s, "it_per_s": it_s,
        "cli_it_per_s": cli["it_per_s"],
        "timer_mean_ms": {k: v[0] / max(v[1], 1) for k, v in log["timers"].items()},
        "peak_device_bytes": peak, "cli_peak_device_bytes": cli["peak_device_bytes"],
        "launches": launches, "ply_rows": ply_rows, "ply_equal": ply_equal,
        "process_group_left": group_left,
        "resume": {"rc": res.returncode, "s": resume_s, "resumed": "Resumed from" in log2_text,
                   "mesh_line": "multi-chip mesh:" in log2_text,
                   "end2end": log2["end2end"], "test_psnr": log2["test_psnr"]},
    }
    if res.returncode != 0:
        print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
    finite = all(v == v and abs(v) != float("inf") for v in log["losses"])
    check(finite and log["losses"], f"mesh: losses {log['losses']}")
    check(mesh_line == ["multi-chip mesh: {'data': 1, 'gauss': 1}"] and not group_left,
          f"mesh: mesh line {mesh_line}, process group left {group_left}")
    check(all(launches.get(k, 0) > 0 for k in KERNELS),
          f"mesh: a kernel of the path never launched: {launches}")
    check(log["capacity"] and log["resets"] >= 1,
          f"mesh: growths {log['capacity']}, resets {log['resets']}")
    check(len(log["test_psnr"]) >= 2 and log["test_psnr"][-1] > log["test_psnr"][0]
          and abs(psnr_gap) <= TOL["mesh_psnr_db"],
          f"mesh: test PSNR {log['test_psnr']}, {psnr_gap} dB from the cli run's")
    check(ply_rows == n_end and ply_equal, f"mesh: PLY rows {ply_rows} vs {n_end}, "
          f"equal {ply_equal}")
    last = (log2_text.rstrip().splitlines() or [""])[-1]
    check(res.returncode == 0 and result["resume"]["resumed"]
          and not result["resume"]["mesh_line"] and last.startswith("end2end total_time:"),
          f"mesh: the single-card resume failed (rc {res.returncode}): {last}")
    return result


# the trajectory phase: frames a run and the renderer's flags besides the
# model, the scene, the output and the strategy (the default 1280x720)
TRAJ_FRAMES = 8
TRAJ_STRATEGIES = ("--no_offload", "--clm_offload")
# frame 0's float images of the two strategies in one process
# (tests/test_torch_clm.py::test_eval_one_cam_matches_the_full_render)
TRAJ_RTOL, TRAJ_ATOL = 1e-5, 1e-6


def trajectory_run(torch, work, scene):
    """`python -m clm_gs_tpu_torch.render_trajectory` on the clm run's final
    PLY in `work`, with the scene's training cameras, under --no_offload and
    --clm_offload: 8 frames each with structure, the same within one level
    between the two, frame 0's float images of the two in this process
    within TRAJ_RTOL/TRAJ_ATOL, and the kernels each run launched."""
    from pathlib import Path

    import numpy as np
    from PIL import Image

    from clm_gs_tpu_torch import render_trajectory as RT

    root = Path(__file__).resolve().parent
    ply = f"{work}/clm/point_cloud/iteration_200/point_cloud.ply"
    common = ["--load_ply_path", ply, "--source_path", scene,
              "--num_frames", str(TRAJ_FRAMES)]
    runs, frames = {}, {}
    for flag in TRAJ_STRATEGIES:
        out = f"{work}/traj{flag}"
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-c", RUN_MODULE, "clm_gs_tpu_torch.render_trajectory",
             *common, "--out_dir", out, "--topdown", f"{out}.topdown.png", flag],
            cwd=root, capture_output=True, text=True, check=False, timeout=300)
        run_s = time.perf_counter() - t0
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
        check(res.returncode == 0, f"trajectory {flag}: rc {res.returncode}")
        done = [ln for ln in res.stderr.splitlines() if ln.startswith("rendered ")]
        names = sorted(p.name for p in Path(out).glob("*.png"))
        frames[flag] = [np.asarray(Image.open(Path(out, n))).astype(np.int32)
                        for n in names]
        runs[flag] = {"s": run_s, "frames": len(names), "rendered": done,
                      "frames_per_s": float(done[-1].split("(")[1].split()[0])
                      if done else None,
                      "render_readback_s": float(done[-1].split("read-back ")[1].split()[0])
                      if done else None,
                      "frame_std": [float(f.std()) for f in frames[flag]],
                      "topdown": Path(f"{out}.topdown.png").exists(),
                      # a best-effort output: why it was or was not written
                      "topdown_log": [ln for ln in res.stderr.splitlines()
                                      if ln.startswith(("wrote ", "topdown view"))],
                      **_module_run(res)}
    a, b = (frames[f] for f in TRAJ_STRATEGIES)
    png_diff = max(int(np.abs(x - y).max()) for x, y in zip(a, b)) if a and b else None

    # frame 0 of both strategies in this process, as floats
    imgs = {}
    for flag in TRAJ_STRATEGIES:
        args = RT.parse_args(common + ["--out_dir", f"{work}/traj_frame0", flag])
        state, host_sh = RT.load_model(args, "cuda")
        positions, target = RT.trajectory(args, state)
        vms, c2ws = RT.frame_cameras(positions, target, "cuda")
        render, ctx = RT.make_renderer(args, state, host_sh, "cuda")
        try:
            imgs[flag] = render(vms[0], c2ws[0]).cpu()
        finally:
            if ctx is not None:
                ctx.close()
        del state, host_sh, render, ctx
        torch.cuda.empty_cache()
    full, compact = (imgs[f] for f in TRAJ_STRATEGIES)
    err = (full - compact).abs()
    close = bool((err <= TRAJ_ATOL + TRAJ_RTOL * compact.abs()).all())
    result = {"phase": "trajectory", "ply": ply, "width": 1280, "height": 720,
              "runs": runs, "png_max_level_diff": png_diff,
              "frame0_max_abs_err": err.max().item(), "frame0_close": close,
              "tol": {"png_levels": 1, "rtol": TRAJ_RTOL, "atol": TRAJ_ATOL}}
    for flag, r in runs.items():
        fs = frames[flag]
        check(r["frames"] == TRAJ_FRAMES and all(v > 5 for v in r["frame_std"])
              and all(not np.array_equal(x, y) for x, y in zip(fs, fs[1:])),
              f"trajectory {flag}: {r['frames']} frames, std {r['frame_std']}")
        check(all(r["launches"].get(k, 0) >= TRAJ_FRAMES
                  for k in ("rasterize_fwd", "fill")),
              f"trajectory {flag}: launches {r['launches']}")
    check(png_diff is not None and png_diff <= 1,
          f"trajectory: frames of the two strategies differ by {png_diff} levels")
    check(close, f"trajectory: frame 0 differs by {err.max().item()} between strategies")
    return result


def bench4k_run(torch):
    """The bench scene at 3840x2160 (utils/bench4k.py `bench_step`): a
    warm-up and 3 timed train_steps with each kernel's launches over the
    timed ones, then each kernel against its plain version on camera 0's
    4K shapes, timed and bounded. Gates: finite losses, every kernel
    launched, the kernels within tolerance (kernel_checks)."""
    from clm_gs_tpu_torch.utils.bench4k import bench_step

    t0 = time.perf_counter()
    rec, scene = bench_step(device="cuda")
    step_s = time.perf_counter() - t0
    finite = lambda xs: all(v == v and abs(v) != float("inf") for v in xs)
    check(finite(rec["warm_losses"]) and finite(rec["losses"]),
          f"bench4k: losses {rec['warm_losses']}, {rec['losses']}")
    check(all(rec["launches"].get(k, 0) > 0 for k in KERNELS),
          f"bench4k: a kernel of the path never launched: {rec['launches']}")
    t0 = time.perf_counter()
    kernels = kernel_checks(torch, reps=10, scene=scene)
    kernels_s = time.perf_counter() - t0
    del scene
    return {"phase": "bench4k", **rec, "step_s": step_s, "kernels": kernels,
            "kernels_s": kernels_s, "s": step_s + kernels_s}


# The parity phase: the parity schedule cut to PARITY_ITERS iterations (the
# densification from 500 kept, two evals; the opacity reset at 3,000 runs in
# the full parity run, utils/parity30k.py)
PARITY_ITERS = 2000
PARITY_PSNR_DB = 0.5


def parity_run(torch, iters=PARITY_ITERS):
    """The parity scene (utils/parity30k.py `make`) trained under each
    strategy with `train_argv(strategy, iters, ...)` through
    `parity30k.run_concurrent`: a process a strategy, the three at once.
    Gates: finite losses, each offload strategy's test
    PSNR within PARITY_PSNR_DB of no_offload's at every eval, test PSNR
    rising from the first eval to the last, every kernel launched."""
    import re

    from clm_gs_tpu_torch.utils import parity30k as P

    losses = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parity_") as root:
        P.make(root)
        make_s = time.perf_counter() - t0
        runs = P.run_concurrent(root, P.STRATEGIES, iters, timeout=900)
        for s in P.STRATEGIES:
            with open(f"{P.run_dir(root, s)}/python.log") as f:
                losses[s] = [float(v) for v in
                             re.findall(r"\) loss: ([\d.naife+-]+)", f.read())]
            runs[s]["rss_gb_at_eval"] = P.eval_rss_gb(P.run_dir(root, s))
    psnr = {s: r["test_psnr"] for s, r in runs.items()}
    base = psnr["no_offload"]
    gaps = {s: {m: p[m] - base[m] for m in p if m in base} for s, p in psnr.items()
            if s != "no_offload"}
    result = {
        "phase": "parity", "iterations": iters, "make_s": make_s,
        "test_psnr": psnr, "gap_db": gaps,
        "max_gap_db": max((abs(v) for g in gaps.values() for v in g.values()), default=None),
        "final_n3dgs": {s: r["final_n3dgs"] for s, r in runs.items()},
        "n_densify_events": {s: r["n_densify_events"] for s, r in runs.items()},
        "end2end_s": {s: r["end2end_s"] for s, r in runs.items()},
        "reached_iter": {s: r["reached_iter"] for s, r in runs.items()},
        "rss_gb_at_eval": {s: r["rss_gb_at_eval"] for s, r in runs.items()},
        "peak_device_bytes": {s: r["peak_device_bytes"] for s, r in runs.items()},
        "run_s": {s: r["run_s"] for s, r in runs.items()},
        "concurrent": True,
        "runs": {s: {"launches": r["launches"]} for s, r in runs.items()},
        "tol": {"psnr_db": PARITY_PSNR_DB}, "s": time.perf_counter() - t0,
    }
    for s, ls in losses.items():
        check(ls and all(v == v and abs(v) != float("inf") for v in ls),
              f"parity {s}: losses {ls}")
        p = list(psnr[s].values())
        check(len(p) >= 2 and p[-1] > p[0], f"parity {s}: test PSNR {psnr[s]}")
        check(all(runs[s]["launches"].get(k, 0) > 0 for k in KERNELS),
              f"parity {s}: a kernel of the path never launched: {runs[s]['launches']}")
    for s, g in gaps.items():
        check(len(g) == len(base) and all(abs(v) <= PARITY_PSNR_DB for v in g.values()),
              f"parity {s}: test PSNR {psnr[s]} against no_offload's {base}")
    return result


# The bigcity phase: the reference's BigCity-25M size (SURVEY.md:525), 64
# cameras of 640x400, BIGCITY_ARGS for 2 batches of 64
BIGCITY_N = 25_000_000
BIGCITY_ITERS = 128
# each run's extra flags: the spans, and no final PLY (6 GB of disk and
# time; the 102M run outside the script saves one)
BIGCITY_EXTRA = ["--enable_timer", "--do_not_save"]
# clm's peak device bytes at most BIGCITY_ROW_BYTES a row of the capacity
# and BIGCITY_WORKING_SET: the resident state (the four card groups, their
# two moments, alive and the three statistics: 145 bytes a row) and a
# batch's accumulators (53), and a bounded working set (the filters' and
# the tail's row chunks, a camera's compact set, the ground truth)
BIGCITY_ROW_BYTES = 198
BIGCITY_WORKING_SET = 1.5 * 2**30
# rows of the 25M state the in-place tail is held to `adam_step` on (more
# than one chunk of `optim.ADAM_CHUNK_ROWS`)
BIGCITY_TAIL_ROWS = 6_000_000
# the load's host peak over the host buffers it builds (the streaming loader
# holds one chunk of rows beside them)
BIGCITY_LOAD_SLACK = 2 * 2**30


def bigcity_start():
    """`bigcity make` of the BIGCITY_N scene started in a process of its own,
    its output in files of a new work directory; `bigcity_run` waits for it
    and `bigcity_stop` ends it and removes the directory."""
    from pathlib import Path

    work = tempfile.TemporaryDirectory(prefix="chip_smoke_bigcity_")
    out = open(f"{work.name}/make.out", "w")
    err = open(f"{work.name}/make.err", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "clm_gs_tpu_torch.utils.bigcity", "make",
         f"{work.name}/scene", "--n", str(BIGCITY_N)],
        cwd=Path(__file__).resolve().parent, stdout=out, stderr=err)
    return {"work": work, "proc": proc, "files": (out, err), "t0": time.perf_counter(),
            "disk_free_bytes": shutil.disk_usage(work.name).free}


def bigcity_stop(city):
    if city["proc"].poll() is None:
        city["proc"].kill()
        city["proc"].wait()
    for f in city["files"]:
        f.close()
    city["work"].cleanup()


def _bigcity_make_wait(city, timeout):
    """The started make's JSON line, with `s` its own seconds and `wait_s`
    the seconds the caller waited for it; a failure or more than `timeout`
    seconds from its start is a failed check."""
    t0 = time.perf_counter()
    try:
        rc = city["proc"].wait(timeout=max(1.0, timeout - (t0 - city["t0"])))
    except subprocess.TimeoutExpired:
        rc = None
    wait_s = time.perf_counter() - t0
    for f in city["files"]:
        f.flush()
    out, err = (open(f.name).read() for f in city["files"])
    if rc != 0:
        print(out[-4000:], err[-4000:], file=sys.stderr)
    check(rc == 0, f"bigcity make: rc {rc}")
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    rec = json.loads(lines[-1])
    return rec | {"s": rec["total_s"], "wait_s": wait_s}


def _bigcity_cli(root, args, timeout):
    """`python -m clm_gs_tpu_torch.utils.bigcity ARGS`: its JSON line and
    its seconds; a failure is a failed check."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "clm_gs_tpu_torch.utils.bigcity", *args],
                         cwd=root, capture_output=True, text=True, check=False,
                         timeout=timeout)
    s = time.perf_counter() - t0
    if res.returncode != 0:
        print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
    check(res.returncode == 0, f"bigcity {args[0]}: rc {res.returncode}")
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    return json.loads(lines[-1]) | {"s": s}


def _tail_check(torch, p, rows):
    """`optim.adam_update_` (in place, in row chunks) against `adam_step` on
    a cloned slice of `rows` rows of the card groups `p`, with seeded
    moments and gradients, half the rows masked and the bigcity run's
    betas: parameters, both moments and the step count bit-equal, the
    storage kept; each one's time on the slice."""
    from clm_gs_tpu_torch.models.gaussians import GaussianParams
    from clm_gs_tpu_torch.optim import (ADAM_CHUNK_ROWS, AdamConfig, AdamState,
                                        adam_step, adam_update_)

    gen = torch.Generator(device="cuda").manual_seed(7)

    def group(make):
        return GaussianParams(*(make(getattr(p, f)[:rows]) for f in GROUPS[:4]),
                              torch.zeros((1, SH_COLS), device="cuda"))

    params = group(torch.clone)
    grads = group(lambda t: 1e-3 * torch.randn(t.shape, generator=gen, device="cuda"))
    opt = AdamState(group(lambda t: 1e-3 * torch.randn(t.shape, generator=gen,
                                                       device="cuda")),
                    group(lambda t: 1e-2 * torch.rand(t.shape, generator=gen,
                                                      device="cuda")),
                    torch.tensor(10.0, device="cuda"))
    mask = torch.rand(rows, generator=gen, device="cuda") < 0.5
    lrs = {f: torch.tensor(lr, device="cuda") for f, lr in (
        ("xyz", 1.6e-6), ("opacity", 0.05), ("log_scale", 0.005), ("quat", 0.001))}
    cfg = AdamConfig().scaled(64, "sqrt")
    adam_update_(_clone(torch, params), grads, _clone(torch, opt), lrs, cfg, mask)  # warm
    for _ in range(2):  # a warm-up, then the timed call
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref_p, ref_o = adam_step(params, grads, opt, lrs, cfg, mask)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    got_p, got_o = _clone(torch, params), _clone(torch, opt)
    ptrs = [t.data_ptr() for t in got_p.astuple() + got_o.mu.astuple() + got_o.nu.astuple()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_p, out_o = adam_update_(got_p, grads, got_o, lrs, cfg, mask)
    torch.cuda.synchronize()
    update_ms = (time.perf_counter() - t0) * 1e3
    equal = {f: all(torch.equal(getattr(a, f), getattr(b, f)) for a, b in (
        (out_p, ref_p), (out_o.mu, ref_o.mu), (out_o.nu, ref_o.nu))) for f in GROUPS[:4]}
    equal["steps"] = torch.equal(out_o.steps, ref_o.steps)
    equal["storage_kept"] = (out_p is got_p and out_o is got_o and ptrs == [
        t.data_ptr() for t in out_p.astuple() + out_o.mu.astuple() + out_o.nu.astuple()])
    return {"rows": rows, "chunk_rows": ADAM_CHUNK_ROWS, "equal": equal,
            "masked_rows": int(mask.sum()), "adam_step_ms": step_ms,
            "adam_update_ms": update_ms}


def _filter_check(torch, state, cb):
    """`offload_common.calculate_filters` (row chunks of FILTER_CHUNK_ROWS,
    the covariance once a chunk) against the unchunked pass it replaced
    (`fully_fused_projection` over every row, a camera at a time) for each
    camera of `cb`: ids, counts and the TSP sample equal; each one's time
    (the second of two calls)."""
    from clm_gs_tpu_torch.ops.projection import fully_fused_projection
    from clm_gs_tpu_torch.strategies import offload_common as oc

    p = state.params
    w, h = cb.width, cb.height

    def unchunked():
        scales = torch.exp(p.log_scale)
        ids, samples = [], []
        for b in range(cb.viewmats.shape[0]):
            vis = fully_fused_projection(p.xyz, p.quat, scales, cb.viewmats[b:b + 1],
                                         cb.Ks[b:b + 1], w, h, radius_clip=0.0,
                                         alive=state.alive).radii[0] > 0
            ids.append(torch.nonzero(vis).flatten().to(torch.int32))
            samples.append(vis[::oc.SAMPLE_STRIDE])
        return ids, samples

    ms = {}
    for _ in range(2):
        for name, fn in (("chunked", lambda: oc.calculate_filters(
                p.xyz, p.quat, p.log_scale, state.alive, cb.viewmats, cb.Ks, w, h, 0.0)),
                         ("unchunked", unchunked)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t0) * 1e3
            if name == "chunked":
                F = out
            else:
                ids, samples = out
    return {"cameras": len(ids), "chunk_rows": oc.FILTER_CHUNK_ROWS,
            "counts": F.counts.tolist(),
            "equal": {"ids": all(torch.equal(a, b) for a, b in zip(F.ids, ids)),
                      "counts": F.counts.tolist() == [len(i) for i in ids],
                      "sample": torch.equal(F.sample, torch.stack(samples))},
            "chunked_ms": ms["chunked"], "unchunked_ms": ms["unchunked"]}


def _bigcity_kernels(torch, scene, cap):
    """On the init PLY's state: the in-place tail against `adam_step` on a
    slice of it (`_tail_check`), the chunked filters against the unchunked
    pass for the first two training cameras (`_filter_check`), then each
    kernel against its plain version at the shapes the clm path gives it:
    the visible rows of the first training camera against its ground
    truth."""
    from clm_gs_tpu_torch.models import gaussians as G
    from clm_gs_tpu_torch.strategies import offload_common as oc
    from clm_gs_tpu_torch.utils import hostmem
    from clm_gs_tpu_torch.utils.bigcity import INIT_PLY, _batch

    state = G.load_ply(f"{scene}/{INIT_PLY}", capacity=cap, device="cuda")
    tail = _tail_check(torch, state.params, BIGCITY_TAIL_ROWS)
    torch.cuda.empty_cache()
    filters = _filter_check(torch, state, _batch(scene, 2, 8, "cuda")[0])
    torch.cuda.empty_cache()
    cb, gt, names = _batch(scene, 1, 8, "cuda")
    p = state.params
    F = oc.calculate_filters(p.xyz, p.quat, p.log_scale, state.alive, cb.viewmats,
                             cb.Ks, cb.width, cb.height, 0.0)
    idx = F.ids[0].long()
    k = len(idx)
    compact = G.GaussianParams(*(t[idx] for t in p.astuple()))
    z = torch.zeros(k, device="cuda")
    cstate = G.GaussianState(params=compact, alive=torch.ones(k, dtype=torch.bool,
                                                            device="cuda"),
                             n_alive=k, xyz_grad_accum=z, denom=z, max_radii2d=z)
    del state, p
    out = kernel_checks(torch, scene=(cstate, cb, gt, torch.zeros(3, device="cuda")),
                        timed=False)
    out["shape"]["camera"] = names[0]
    # the gradient scatter into a pinned table of the whole capacity, at
    # the camera's rows (its flush)
    del cstate, compact
    torch.cuda.empty_cache()
    table = hostmem.pinned_zeros((cap, SH_COLS))
    out[SCATTER] = scatter_kernel_check(torch, table, F.ids[0], reps=5)
    del table
    return out, tail, filters


def bigcity_run(torch, city):
    """The BigCity regime at BIGCITY_N Gaussians: `bigcity make` (started
    by `bigcity_start`, handle `city`), then
    `bigcity run` under --clm_offload with --device_loop and under
    --no_offload (each a process of its own, so that its peak RSS is its
    own), then each kernel against its plain version at the clm path's
    shapes. Gates: finite losses; clm's final test PSNR above the degraded
    init's and within BIGCITY_PSNR_DB of no_offload's; clm's peak device
    memory below no_offload's and at most BIGCITY_ROW_BYTES a row of the
    capacity and BIGCITY_WORKING_SET; the clm host state 768 bytes a row of
    the capacity; the load's host peak (the run's RSS sampled through its
    set-up less its RSS before the run) within the host state plus
    BIGCITY_LOAD_SLACK; the replay's last loss equal to the in-situ
    batch's to the bit (the same forward kernels on the same rows in the
    same order); every kernel of the path launched; the in-place tail and
    the chunked filters equal to the forms they replaced."""
    from pathlib import Path

    from clm_gs_tpu_torch.utils.bigcity import capacity_for

    root = Path(__file__).resolve().parent
    cap = capacity_for(BIGCITY_N)
    work = city["work"].name
    scene = f"{work}/scene"
    free = city["disk_free_bytes"]
    make = _bigcity_make_wait(city, 900)
    runs = {}
    for name, flags in (("clm", ["--device_loop", "--pinned_ab"]),
                        ("no_offload", ["--no_offload"])):
        runs[name] = _bigcity_cli(
            root, ["run", scene, f"{work}/{name}", "--iters", str(BIGCITY_ITERS),
                   *flags, "--", *BIGCITY_EXTRA], 900)
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kernels, tail, filters = _bigcity_kernels(torch, scene, cap)
    kernels["s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    clm, no = runs["clm"], runs["no_offload"]
    loop = clm["device_loop"]
    ab = loop.pop("pinned_ab")
    psnr = {k: [e["psnr"] for e in r["final_eval"] if e["split"] == "test"]
            for k, r in runs.items()}
    batches = BIGCITY_ITERS // 64
    spans = {k: v[0] / v[1] for k, v in clm["spans_ms"].items() if k.startswith("clm.")}
    result = {
        "phase": "bigcity", "n": BIGCITY_N, "capacity": cap, "iterations": BIGCITY_ITERS,
        "disk_free_bytes": free,
        "make": {k: make[k] for k in ("s", "wait_s", "gaussians_s", "render_s", "ply_s",
                                      "init_test_psnr", "gt_isects", "gt_launches")},
        "init_test_psnr": make["init_test_psnr"], "final_test_psnr": psnr,
        "it_per_s": {k: (r["end2end"] or {}).get("it_per_s") for k, r in runs.items()},
        "s_per_batch": {k: (r["end2end"] or {}).get("total_s", float("nan")) / batches
                        for k, r in runs.items()},
        "losses": {k: [v["loss"] for v in r["losses"]] for k, r in runs.items()},
        "peak_device_bytes": {k: r["peak_device_bytes"] for k, r in runs.items()},
        "clm_peak_limit_bytes": BIGCITY_ROW_BYTES * cap + BIGCITY_WORKING_SET,
        "peak_by_stage": {k: r["peak_by_stage"] for k, r in runs.items()},
        "log_device_peak_gb": {k: r["device_peak_gb_max"] for k, r in runs.items()},
        # RSS sampled through each run (the kernel's peak of a process that
        # this large one starts begins at this one's: `peak_rss_bytes`)
        "sampled_peak_rss_bytes": {k: r["sampled_peak_rss_bytes"] for k, r in runs.items()},
        "setup_rss_bytes": {k: r["setup_rss_bytes"] for k, r in runs.items()},
        "rss_before_bytes": {k: r["rss_before_bytes"] for k, r in runs.items()},
        "peak_rss_bytes": {k: r["peak_rss_bytes"] for k, r in runs.items()},
        "clm_host_state_bytes": clm["clm_host_state_bytes"],
        # the load's host peak (the run's RSS sampled through its set-up,
        # less its RSS before the run) over the host state
        "load_rss_over_host_state_bytes": (clm["setup_rss_bytes"] - clm["rss_before_bytes"]
                                           - clm["clm_host_state_bytes"]),
        "clm_spans_ms_per_call": spans, "clm_overlap": clm["overlap_last"],
        "run_s": {k: r["s"] for k, r in runs.items()},
        "device_loop": loop, "in_place_tail": tail, "chunked_filters": filters,
        # one batch of the final state on the host path against one with
        # --pinned_host, from one start
        "pinned_ab": {"equal": ab["equal"], "runs": {k: {
            "batch_s": r["batch_s"], "trailing_s": r["trailing_s"],
            "h2d_bytes": r["h2d_bytes"], "d2h_bytes": r["d2h_bytes"],
            "scatter_rows": r["scatter_rows"], "stored_rows": r["stored_rows"],
            "launches": r["launches"], "spans_ms": {
                s: r["spans_ms"].get(s) for s in CLM_SPANS}} for k, r in ab["runs"].items()},
            # the rows the card's scatter wrote that were first departures
            # of the batch, stored into zero slots without a read
            "first_departure_share": ab["runs"]["pinned"]["stored_rows"]
            / max(1, ab["runs"]["pinned"]["scatter_rows"])},
        "launches": {"make": make["gt_launches"], "clm": clm["launches"],
                     "no_offload": no["launches"]},
        "kernels": kernels,
        "tol": {"psnr_db": TOL["bigcity_psnr_db"], "replay": "bit-equal",
                "load_slack_bytes": BIGCITY_LOAD_SLACK},
    }
    finite = lambda xs: xs and all(v == v and abs(v) != float("inf") for v in xs)
    for k, ls in result["losses"].items():
        check(finite(ls), f"bigcity {k}: losses {ls}")
    check(psnr["clm"] and psnr["no_offload"], f"bigcity: no test eval {psnr}")
    check(psnr["clm"][-1] > make["init_test_psnr"],
          f"bigcity: clm's test PSNR {psnr['clm']} not above the init's "
          f"{make['init_test_psnr']}")
    check(abs(psnr["clm"][-1] - psnr["no_offload"][-1]) <= TOL["bigcity_psnr_db"],
          f"bigcity: test PSNR clm {psnr['clm']} against no_offload {psnr['no_offload']}")
    check(clm["peak_device_bytes"] < no["peak_device_bytes"],
          f"bigcity: clm's peak {clm['peak_device_bytes']} not below no_offload's "
          f"{no['peak_device_bytes']}")
    check(clm["peak_device_bytes"] <= result["clm_peak_limit_bytes"],
          f"bigcity: clm's peak {clm['peak_device_bytes']} above {BIGCITY_ROW_BYTES} "
          f"bytes a row of {cap} and {BIGCITY_WORKING_SET} (by stage: "
          f"{clm['peak_by_stage']})")
    check(all(tail["equal"].values()),
          f"bigcity: the in-place tail against adam_step: {tail['equal']}")
    check(all(filters["equal"].values()),
          f"bigcity: the chunked filters against the unchunked pass: {filters['equal']}")
    check(clm["capacity"] == cap and clm["clm_host_state_bytes"] == 768 * cap,
          f"bigcity: host state {clm['clm_host_state_bytes']} at capacity {clm['capacity']}")
    check(result["load_rss_over_host_state_bytes"] <= BIGCITY_LOAD_SLACK,
          f"bigcity: the load's host peak {clm['setup_rss_bytes']} bytes (from "
          f"{clm['rss_before_bytes']}) over the host state {clm['clm_host_state_bytes']}")
    check(loop["replay_equal_to_in_situ"],
          f"bigcity: replay losses {loop['replay_losses']} against the in-situ "
          f"{loop['in_situ_last_loss']}")
    for k in ("clm", "no_offload"):
        check(all(runs[k]["launches"].get(name, 0) > 0 for name in KERNELS),
              f"bigcity {k}: a kernel of the path never launched: {runs[k]['launches']}")
    check(all(ab["equal"].values()),
          f"bigcity: the --pinned_host batch differs from the host path's: {ab['equal']}")
    pl, hl = ab["runs"]["pinned"]["launches"], ab["runs"]["host"]["launches"]
    check(all(pl.get(name, 0) > 0 for name in (*KERNELS, GATHER, SCATTER))
          and not hl.get(GATHER, 0) and not hl.get(SCATTER, 0),
          f"bigcity: --pinned_host batch launches {pl}, host path's {hl}")
    pr = ab["runs"]["pinned"]
    check(0 < pr["stored_rows"] <= pr["scatter_rows"] and not ab["runs"]["host"]["stored_rows"],
          f"bigcity: the --pinned_host batch's scatter stored {pr['stored_rows']} of "
          f"{pr['scatter_rows']} rows")
    return result


def _module_run(res):
    """The JSON line RUN_MODULE prints last (empty counts when the run
    failed)."""
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    return json.loads(lines[-1]) if res.returncode == 0 and lines else {
        "launches": {}, "peak_device_bytes": None}


if __name__ == "__main__":
    sys.exit(main())
