"""Time other builds of a compositing kernel against the package's own, in
one process on one card, at the main path's full-width shapes.

    python3 -m clm_gs_tpu_torch.utils.kernel_ab --kernel rasterize_bwd \
        --variant old=path/to/rasterize_bwd.cu [--variant ...] [--reps 10]

Each variant is a source with the same C entry as ``csrc/<kernel>.cu``
(``clmgs_rasterize_fwd`` or ``clmgs_rasterize_bwd``); its own directory is
searched for headers before ``csrc/``. The inputs are those of the bench scene
(utils/bench_scene.py, 1M Gaussians, 1237x822) for camera 0 before any step,
with the backward fed the package kernel's forward and the loss gradient of
the main path. Every build is checked against the plain version (the
tolerances of chip_smoke.py) and, for the backward, against itself over two
launches; then all builds are timed in turns (package, variants, variants
reversed, package), CUDA events over ``--reps`` launches each. Prints one JSON
line with the card, each build's registers (ptxas) and its times.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time
from pathlib import Path

import torch

from clm_gs_tpu_torch import _build
from clm_gs_tpu_torch.ops import rasterize as R

ENTRY = {"rasterize_fwd": ("clmgs_rasterize_fwd", R._FWD_ARGTYPES),
         "rasterize_bwd": ("clmgs_rasterize_bwd", R._BWD_ARGTYPES)}
TOL_IMAGE = 5e-4
TOL_ROWS_REL = 1e-3


def _compile(kernel: str, srcs: dict) -> dict:
    """nvcc each {name: source} into its own library, all in parallel;
    returns {name: (path, ptxas lines)}."""
    _build.BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in srcs.items():
        so = _build.BUILD / f"ab_{kernel}_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src.parent), "-I",
               str(_build.CSRC), "-o", str(so), str(src)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {srcs[name]}:\n{log}")
        out[name] = (so, [ln.strip() for ln in log.splitlines() if "Used" in ln])
    return out


def _install(kernel: str, so: Path):
    """Make the package's wrapper launch the library at `so`."""
    fn, argtypes = ENTRY[kernel]
    lib = ctypes.CDLL(str(so))
    f = getattr(lib, fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    _build._libs[kernel] = lib


def _time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _inputs():
    from clm_gs_tpu_torch.ops import tiles
    from clm_gs_tpu_torch.strategies.base import photometric_loss, rasterize_inputs
    from clm_gs_tpu_torch.utils.bench_scene import make_scene

    state, _, cb, gts, _, _, bg = make_scene()
    w, h = cb.width, cb.height
    with torch.no_grad():
        m2d, conics, colors, opac, depths, radii = (
            t.contiguous() for t in rasterize_inputs(
                state.params, state.alive, cb.viewmats[0], cb.Ks[0],
                cb.camtoworlds[0, :3, 3], 3, w, h))
    tx, ty = R.tile_grid(w, h)
    ext = tiles.tight_extents(conics, opac, radii)
    isect = tiles.isect_tiles(m2d, radii, depths, (R.TILE_W, R.TILE_H), tx, ty,
                              extents=ext)
    table = torch.cat([m2d, conics, opac[:, None], colors], 1).contiguous()
    fargs = (table, isect.gauss_ids, isect.tile_offsets, bg.contiguous(), w, h)
    kf = R.rasterize_fwd_cuda(*fargs)
    img = kf[0].clone().requires_grad_(True)
    photometric_loss(img, gts[0]).backward()
    bargs = (table, isect.gauss_ids, isect.tile_offsets, kf[0], kf[1], kf[3],
             img.grad.contiguous(), torch.zeros_like(kf[1]), w, h)
    return fargs, bargs, isect.n_isects


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=sorted(ENTRY), required=True)
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=path/to/source.cu")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.strip()
    t0 = time.perf_counter()
    srcs = {"package": _build.CSRC / f"{args.kernel}.cu"}
    for spec in args.variant:
        name, path = spec.split("=", 1)
        srcs[name] = Path(path)
    builds = _compile(args.kernel, srcs)
    build_s = time.perf_counter() - t0
    fargs, bargs, m = _inputs()
    fwd = args.kernel == "rasterize_fwd"
    if fwd:
        plain = R.rasterize_fwd_plain(*fargs)
        run = lambda: R.rasterize_fwd_cuda(*fargs)
    else:
        plain = R.rasterize_bwd_plain(*bargs)
        run = lambda: R.rasterize_bwd_cuda(*bargs)
    result = {"card": smi, "kernel": args.kernel, "n_isects": m,
              "width": fargs[4], "height": fargs[5], "build_s": build_s,
              "builds": {}}
    ref = None
    for name, (so, regs) in builds.items():
        _install(args.kernel, so)
        out, again = run(), run()
        torch.cuda.synchronize()
        if fwd:
            err = max((out[i] - plain[i]).abs().max().item() for i in (0, 1))
            ok = err <= TOL_IMAGE
        else:
            scale = plain.abs().amax(0).clamp_min(1e-30)
            err = ((out - plain).abs() / scale).max().item()
            ok = err <= TOL_ROWS_REL and bool(torch.isfinite(out).all())
            out, again = (out,), (again,)
        ref = out if ref is None else ref
        result["builds"][name] = {
            "ptxas": regs, "err": err, "ok": ok,
            "deterministic": all(torch.equal(a, b) for a, b in zip(out, again)),
            "equal_to_package": all(torch.equal(a, b) for a, b in zip(out, ref)),
            "ms": []}
    order = list(builds) + list(builds)[::-1]
    for name in order:
        _install(args.kernel, builds[name][0])
        result["builds"][name]["ms"].append(_time_ms(run, args.reps))
    _build._libs.pop(args.kernel, None)
    print(json.dumps(result), flush=True)
    return 0 if all(b["ok"] for b in result["builds"].values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
