#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (clm_gs_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--out DIR]

Phases, one JSON line each:
  1. device: the card's name and power limit (nvidia-smi), then an nvcc build
     of the four kernels from csrc/, one process per source.
  2. kernels_mid: each kernel against its plain PyTorch version at a mid
     size (20,000 Gaussians, one 640x480 camera), and the kernel-path
     rasterizer against the dense oracle on a small scene.
  3. train_step_mid: one no_offload train_step on the card (kernel path)
     against the same step on the CPU (plain path).
  4. full: the bench scene, 1,000,000 Gaussians in a capacity of 1,048,576
     (SH degree 3), 4 cameras at 1237x822: one warm-up step and 3 timed
     train_steps, with each kernel's launch count over the timed steps.
  5. kernels: each kernel against its plain version at the full-width
     shapes of camera 0, with times, bounds and (segment reduce) the time of
     one PyTorch call computing the same function; the backward and segment
     reduce are also held to identical output over two launches, and each
     compositing kernel reports the (instance, pixel) slots its block shapes
     walk. At the mid size, fill is also held exactly to its plain version
     on channels whose only valid slot is the first, with n % 4 == 3.
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
     camera order of csrc/host/fast_tsp.cpp) with retention and without,
     against one no_offload.train_step: losses (sorted, as the TSP reorders
     the cameras), parameter moves and first moments, retention against the
     full re-gather, the bytes of the clm state and card moments against
     no_offload's (at least the SH parameters' and their two moments'
     less), and for each: a first batch, a warm one (batch time, bytes each
     way, the overlap meter) and one under --enable_timer's spans.
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
     clm_gs_tpu_torch.train --clm_offload`, which restores the host SH rows
     and moments from strategy_extra.npz. The kernels line follows it.
Any failed check exits 1. The last line is the device summary. Without CUDA,
or without the package beside it, the script exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import csv
import json
import subprocess
import sys
import tempfile
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 FLOP/s outside
# the tensor cores; both at the full 700 W power limit.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
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

    # 2. kernels against plain versions at a mid size, and against the oracle
    mid = kernel_checks(torch, n=20_000, w=640, h=480, reps=5)
    mid["oracle"] = oracle_check(torch)
    report["kernels_mid"] = mid
    emit({"phase": "kernels_mid", **mid})

    # 3. train_step: kernel path on the card against plain path on the CPU
    report["train_step_mid"] = train_step_check(torch)
    emit(report["train_step_mid"])

    # 4. full width
    scene, report["full"], step_args = full_width(torch)
    emit(report["full"])

    # 5. kernels at the full-width shapes
    full = kernel_checks(torch, reps=10, scene=scene)
    report["kernels_full"] = full

    # 6. naive_offload's batch on the same scene, which it takes over
    box = [scene]
    del scene
    report["naive_step"] = naive_step(torch, box, *step_args)
    emit(report["naive_step"])
    torch.cuda.empty_cache()
    report["clm_step"] = clm_step(torch, box, *step_args)
    emit(report["clm_step"])
    torch.cuda.empty_cache()

    # 7. and 8. the training CLI under no_offload and naive_offload on one
    # synthetic COLMAP scene at full width, written and decoded once
    from clm_gs_tpu_torch.utils.synthetic_colmap import make_dataset

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as work:
        t0 = time.perf_counter()
        colmap = make_dataset(f"{work}/scene", full=True)
        scene_s = time.perf_counter() - t0
        report["cli"] = cli_run(torch, work, colmap)
        report["cli"]["scene_s"] = scene_s
        emit(report["cli"])
        torch.cuda.empty_cache()
        report["naive"] = naive_cli_run(torch, work, colmap, report["cli"])
        emit(report["naive"])
        torch.cuda.empty_cache()
        report["clm"] = clm_cli_run(torch, work, colmap, report["cli"], report["naive"])
        emit(report["clm"])

    launches = report["full"]["launches"]
    emit({"kernels": [
        {"name": k, "status": "ported", "route": "cuda", "source": KERNELS[k][0],
         "replaces": KERNELS[k][1], "launches": launches.get(k, 0),
         "cli_launches": report["cli"]["launches"].get(k, 0),
         "naive_step_launches": report["naive_step"]["launches"].get(k, 0),
         "naive_launches": report["naive"]["launches"].get(k, 0),
         "clm_step_launches": report["clm_step"]["launches"].get(k, 0),
         "clm_launches": report["clm"]["launches"].get(k, 0),
         "max_abs_err": full[k]["max_abs_err"], "ms": full[k]["ms"],
         "plain_ms": full[k]["plain_ms"], "bound_ms": full[k]["bound_ms"],
         "bound_by": full[k]["bound_by"], "library_ms": full[k]["library_ms"]}
        for k in KERNELS
    ]})


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
    T = torch.ones_like(px)
    done = ~inside
    n = {d: dict.fromkeys(KINDS, 0) for d in ("fwd", "bwd")}
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
    return n, depth


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
    and clm_offload.train_one_batch with and without retention, all from
    the same seeded moments (the SH ones on the host for clm). For each
    retention setting three batches from that start on one context: the
    first (staging buffers allocated), a warm one (times, bytes, overlap
    meter) and one with --enable_timer's spans."""
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

    def batch(cfg, ctx, timed):
        """One batch from the seeded start, the context reset to it."""
        ctx.sh_host.copy_(p0["sh"])
        ctx.sh_grad_host.zero_()
        ctx.adam.exp_avg, ctx.adam.exp_avg_sq = mu0["sh"].clone(), sh_nu0.clone()
        ctx.adam.step_count = int(opt.steps)
        ctx.trailing_s = ctx.scatter_work_s = ctx.adam_work_s = 0.0
        ctx.n_batches = ctx.h2d_bytes = ctx.d2h_bytes = 0
        timers = Timer(enabled=timed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        s2, o2, ctx, out = clm.train_one_batch(s, o, ctx, cb, gts, 3, host_lrs,
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
            "launches": dict(_build.LAUNCHES),
        }
        if timed:
            run["span_ms"] = {k: timers.sums[k] * 1e3 for k in CLM_SPANS if k in timers.sums}
            run["span_calls"] = {k: timers.counts[k] for k in CLM_SPANS
                                 if k in timers.counts}
        return run, params

    runs, finals = {}, {}
    for retention in (True, False):
        cfg = Config()
        cfg.aux.clm_offload = True
        cfg.tpu.retention = retention
        init_config(cfg)
        ctx = clm.make_context(cfg, state, adam_cfg)
        try:
            out = [batch(cfg, ctx, timed) for timed in (False, False, True)]
        finally:
            ctx.close()
        key = "retention" if retention else "full_regather"
        runs[key] = dict(zip(("first", "warm", "timed"), (r for r, _ in out)))
        finals[key] = out[0][1]
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
    check(runs["retention"]["warm"]["h2d_bytes"] < runs["full_regather"]["warm"]["h2d_bytes"],
          "clm_step: retention moved no fewer bytes up than the full re-gather")
    check(no_bytes - clm_bytes >= 3 * (C - 1) * SH_COLS * 4,
          f"clm_step: the clm state and moments take {clm_bytes} bytes, "
          f"no_offload's {no_bytes}")
    return result


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
    ply_equal = all(torch.equal(getattr(back.params, f)[back.alive],
                                getattr(state.params, f)[state.alive])
                    for f in GROUPS)
    ply_rows, n_end, cap_end = back.n_alive, state.n_alive, state.capacity
    placeholder = [tuple(opt.mu.sh.shape), tuple(opt.nu.sh.shape)]
    del back, state, opt
    torch.cuda.empty_cache()

    ckpt = Path(out, "checkpoints", "101")
    extra_saved = Path(ckpt, "strategy_extra.npz").exists()
    out2 = f"{work}/clm_resume"
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
                   "densify_counts": log2["densify"]},
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
    return result


if __name__ == "__main__":
    sys.exit(main())
