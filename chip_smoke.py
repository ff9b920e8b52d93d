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
Any failed check exits 1. The last line is the device summary. Without CUDA,
or without the package beside it, the script exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
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
    regs = {k: [ln.strip() for ln in v.splitlines() if "Used" in ln]
            for k, v in ptxas.items()}
    report["device"] = {"phase": "device", "nvidia_smi": smi,
                        "name": torch.cuda.get_device_name(0),
                        "build_s": build_s, "ptxas": regs}
    emit({"phase": "device", "build_s": round(build_s, 3),
          "built": sorted(ptxas)})

    # 2. kernels against plain versions at a mid size, and against the oracle
    mid = kernel_checks(torch, n=20_000, w=640, h=480, reps=5)
    mid["oracle"] = oracle_check(torch)
    report["kernels_mid"] = mid
    emit({"phase": "kernels_mid", **mid})

    # 3. train_step: kernel path on the card against plain path on the CPU
    report["train_step_mid"] = train_step_check(torch)
    emit(report["train_step_mid"])

    # 4. full width
    scene, report["full"] = full_width(torch)
    emit(report["full"])

    # 5. kernels at the full-width shapes
    full = kernel_checks(torch, reps=10, scene=scene)
    report["kernels_full"] = full
    launches = report["full"]["launches"]
    emit({"kernels": [
        {"name": k, "status": "ported", "route": "cuda", "source": KERNELS[k][0],
         "replaces": KERNELS[k][1], "launches": launches.get(k, 0),
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


def kernel_checks(torch, n=None, w=None, h=None, reps=10, scene=None):
    """Each kernel against its plain version on the inputs the main path
    gives it for one camera; times, errors and bounds."""
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
    nbytes = 2 * ch.numel() * 4
    b, by = _bound(nbytes, 0)
    out["fill"] = {"max_abs_err": 0.0, "tol": 0, "n": n_isects,
                   "ms": time_ms(torch, lambda: fill.forward_fill_cuda(ch), reps),
                   "plain_ms": time_ms(torch, lambda: fill.forward_fill_plain(ch), 3, 1),
                   "bound_ms": b, "bound_by": by, "library_ms": None}
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
    pairs, depth = pair_counts(torch, table, isect.gauss_ids, isect.tile_offsets,
                               kf[3], w, h)
    walked = walks(depth)
    m = isect.n_isects
    fwd_bytes = table.numel() * 4 + m * 4 + (tx * ty + 1) * 4 + 12 + 6 * w * h * 4
    b, by = _bound(fwd_bytes, _pair_ops(pairs, "fwd"))
    out["rasterize_fwd"] = {
        "max_abs_err": max(err_img, err_alpha), "tol": TOL["image"],
        "pixels_over_1e-5": int(((kf[0] - pf[0]).abs() > 1e-5).sum()),
        "pairs": pairs["fwd"], "walk": walked["fwd"],
        "ms": time_ms(torch, lambda: R.rasterize_fwd_cuda(*fargs), reps),
        "plain_ms": time_ms(torch, lambda: R.rasterize_fwd_plain(*fargs), 2, 1),
        "bound_ms": b, "bound_by": by, "library_ms": None,
    }

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
    bwd_bytes = (table.numel() * 4 + m * 4 + (tx * ty + 1) * 4 + 9 * w * h * 4
                 + m * 9 * 4)
    b, by = _bound(bwd_bytes, _pair_ops(pairs, "bwd"))
    out["rasterize_bwd"] = {
        "max_abs_err": err_rows, "rel_err": rel_rows, "tol": TOL["rows_rel"],
        "deterministic": True,
        "pairs": pairs["bwd"], "walk": walked["bwd"],
        "ms": time_ms(torch, lambda: R.rasterize_bwd_cuda(*bargs), reps),
        "plain_ms": time_ms(torch, lambda: R.rasterize_bwd_plain(*bargs), 2, 1),
        "bound_ms": b, "bound_by": by, "library_ms": None,
    }

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
    ids_long = ids_sorted.long()
    b, by = _bound(m * 4 + m * 36 + ng * 36, 0)
    out["segreduce"] = {
        "max_abs_err": err_seg, "rel_err": rel_seg, "tol": TOL["segreduce_rel"],
        "deterministic": True,
        "ms": time_ms(torch, seg, reps),
        "plain_ms": time_ms(torch, lambda: segreduce.segment_reduce_plain(
            ids_sorted, rows_sorted, ng), reps),
        "library_ms": time_ms(torch, lambda: torch.zeros(
            ng, 9, device=rows_sorted.device).index_add_(0, ids_long, rows_sorted),
            reps),
        "bound_ms": b, "bound_by": by,
        # the main path's gather of the rows into sorted order, in torch
        "gather_ms": time_ms(torch, lambda: rk[perm].contiguous(), reps),
    }
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
    }


if __name__ == "__main__":
    sys.exit(main())
