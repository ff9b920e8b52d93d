"""Time other builds of a kernel against the package's own, in one process on
one card, at the main path's full-width shapes.

    python3 -m clm_gs_tpu_torch.utils.kernel_ab --kernel segreduce \
        --variant old=path/to/segreduce.cu [--variant parent=path/to/checkout] \
        [--reps 10]

``--kernel`` is one of rasterize_fwd, rasterize_bwd, segreduce, fill. A
variant is either a source with the same C entry and arguments as
``csrc/<kernel>.cu`` (its own directory is searched for headers before
``csrc/``), or the root of another checkout of the repo: then that checkout's
``clm_gs_tpu_torch/csrc/<kernel>.cu`` is built and launched through that
checkout's own wrapper (``clm_gs_tpu_torch/ops/<module>.py``), so a build
whose C entry takes other arguments is timed too.

The inputs are those of the bench scene (utils/bench_scene.py, 1M Gaussians,
1237x822) for camera 0 before any step: the forward gets the binned
instances; the backward the package kernel's forward and the loss gradient
of the main path; segment reduce the id-sorted rows of the package's
backward; fill the expansion channels of the binning. Every build is checked
against the plain version (the tolerances of chip_smoke.py: fill exact,
segment reduce 1e-5 of its largest output) and against itself over two
launches; then all builds are timed in turns (package, variants, variants
reversed, package), CUDA events over ``--reps`` launches each, and each
build's device time is split among its kernels and memsets with
torch.profiler. For segment reduce each build also times the main path's
work after its sort (``path_ms``: the gather of the rows into sorted order
and the reduction, or the reduction gathering them itself where the wrapper
takes the permutation). Prints one JSON line with the card, the inputs' statistics
(segment reduce: instances per Gaussian; fill: the longest run of invalid
slots), the time of a copy of the inputs (a yardstick of the rate the card
reaches at these sizes), each build's registers (ptxas), its launch split
and its times.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import inspect
import json
import subprocess
import time
from pathlib import Path

import torch

from clm_gs_tpu_torch import _build

# kernel -> (ops module, C entry, argtypes attribute, wrapper, plain version)
ENTRY = {
    "rasterize_fwd": ("rasterize", "clmgs_rasterize_fwd", "_FWD_ARGTYPES",
                      "rasterize_fwd_cuda", "rasterize_fwd_plain"),
    "rasterize_bwd": ("rasterize", "clmgs_rasterize_bwd", "_BWD_ARGTYPES",
                      "rasterize_bwd_cuda", "rasterize_bwd_plain"),
    "segreduce": ("segreduce", "clmgs_segment_reduce", "_ARGTYPES",
                  "segment_reduce_cuda", "segment_reduce_plain"),
    "fill": ("fill", "clmgs_forward_fill", "_ARGTYPES", "forward_fill_cuda",
             "forward_fill_plain"),
}
TOL_IMAGE = 5e-4
TOL_ROWS_REL = 1e-3
TOL_SEGREDUCE_REL = 1e-5
SLEEP_CYCLES = 2_000_000  # about 1 ms of the card's clock


def _package_module(kernel: str):
    return importlib.import_module(f"clm_gs_tpu_torch.ops.{ENTRY[kernel][0]}")


def _variant(kernel: str, name: str, path: Path):
    """(source, wrapper module) of a variant: a source file, launched through
    the package's wrapper, or another checkout's source and wrapper."""
    if not path.is_dir():
        return path, _package_module(kernel)
    pkg = path / "clm_gs_tpu_torch"
    modfile = pkg / "ops" / f"{ENTRY[kernel][0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"_kernel_ab_{name}_{ENTRY[kernel][0]}", modfile)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return pkg / "csrc" / f"{kernel}.cu", mod


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


def _install(kernel: str, so: Path, module):
    """Make the wrappers launch the library at `so`, with the C arguments
    that `module` declares."""
    _, fn, argtypes, _, _ = ENTRY[kernel]
    lib = ctypes.CDLL(str(so))
    f = getattr(lib, fn)
    f.argtypes = getattr(module, argtypes)
    f.restype = ctypes.c_int
    _build._libs[kernel] = lib


def _time_ms(fn, reps):
    """Device time per call, the launches queued behind a busy wait of the
    card (as chip_smoke.time_ms) so that the host's launch pace is not timed."""
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


def _launch_split(fn, reps):
    """Device time per call of each kernel and memset that `fn` runs:
    {name: {"per_call": count, "us": microseconds per call}}."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        split[ev.key[:100]] = {"per_call": ev.count / reps, "us": us / reps}
    return split


def _inputs():
    from clm_gs_tpu_torch.ops import rasterize as R
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
    ch, _ = tiles.expansion_channels(m2d, radii, depths, (R.TILE_W, R.TILE_H),
                                     tx, ty, extents=ext)
    isect = tiles.isect_tiles(m2d, radii, depths, (R.TILE_W, R.TILE_H), tx, ty,
                              extents=ext)
    table = torch.cat([m2d, conics, opac[:, None], colors], 1).contiguous()
    fargs = (table, isect.gauss_ids, isect.tile_offsets, bg.contiguous(), w, h)
    kf = R.rasterize_fwd_cuda(*fargs)
    img = kf[0].clone().requires_grad_(True)
    photometric_loss(img, gts[0]).backward()
    bargs = (table, isect.gauss_ids, isect.tile_offsets, kf[0], kf[1], kf[3],
             img.grad.contiguous(), torch.zeros_like(kf[1]), w, h)
    ids_sorted, perm = torch.sort(isect.gauss_ids, stable=True)
    rows = R.rasterize_bwd_cuda(*bargs)
    return {"rasterize_fwd": fargs, "rasterize_bwd": bargs,
            "segreduce": (ids_sorted, rows[perm].contiguous(), table.shape[0]),
            "segreduce_path": (ids_sorted, perm, rows, table.shape[0]), "fill": (ch,),
            "n_isects": isect.n_isects, "width": w, "height": h}


def _segreduce_path(wrapper, path_inputs):
    """What the main path runs after its sort of the ids: the reduction of
    the rows in sorted order, gathered by a wrapper that takes the sort's
    permutation, else by rows[perm] before the call."""
    ids, perm, rows, n = path_inputs
    if "perm" in inspect.signature(wrapper).parameters:
        return lambda: wrapper(ids, rows, n, perm=perm)
    return lambda: wrapper(ids, rows[perm].contiguous(), n)


def _input_stats(kernel: str, args) -> dict:
    """Segment reduce: instances per Gaussian over the Gaussians with at
    least one. Fill: the longest run of invalid slots (before the first valid
    slot, between two, or after the last)."""
    if kernel == "segreduce":
        ids, _, n = args
        keep = (ids >= 0) & (ids < n)
        counts = torch.bincount(ids[keep].long(), minlength=n)
        runs = counts[counts > 0].double()
        return {"gaussians": n, "with_instances": runs.numel(),
                "run_max": int(runs.max()), "run_mean": float(runs.mean()),
                "run_p99": float(torch.quantile(runs, 0.99)),
                "run_p50": float(torch.quantile(runs, 0.5))}
    if kernel == "fill":
        (ch,) = args
        n = ch.shape[1]
        v = torch.nonzero(ch[0] != 0).flatten()
        if v.numel() == 0:
            return {"slots": n, "valid": 0, "longest_invalid_run": n}
        edges = torch.cat([v[:1], torch.diff(v) - 1, (n - 1 - v[-1:])])
        return {"slots": n, "valid": v.numel(),
                "longest_invalid_run": int(edges.max())}
    return {}


def _check(kernel: str, out, plain):
    """(error, ok) of one build's output against the plain version."""
    if kernel == "rasterize_fwd":
        err = max((out[i] - plain[i]).abs().max().item() for i in (0, 1))
        return err, err <= TOL_IMAGE
    if kernel == "rasterize_bwd":
        scale = plain.abs().amax(0).clamp_min(1e-30)
        err = ((out - plain).abs() / scale).max().item()
        return err, err <= TOL_ROWS_REL and bool(torch.isfinite(out).all())
    if kernel == "segreduce":
        err = (out - plain).abs().max().item() / max(plain.abs().max().item(), 1e-30)
        return err, err <= TOL_SEGREDUCE_REL and bool(torch.isfinite(out).all())
    return float((out != plain).sum().item()), torch.equal(out, plain)


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=sorted(ENTRY), required=True)
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=path/to/source.cu or NAME=path/to/checkout")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.strip()
    t0 = time.perf_counter()
    srcs = {"package": _build.CSRC / f"{args.kernel}.cu"}
    modules = {"package": _package_module(args.kernel)}
    for spec in args.variant:
        name, path = spec.split("=", 1)
        srcs[name], modules[name] = _variant(args.kernel, name, Path(path))
    builds = _compile(args.kernel, srcs)
    build_s = time.perf_counter() - t0
    inputs = _inputs()
    kargs = inputs[args.kernel]
    _, _, _, wrapper, plain_name = ENTRY[args.kernel]
    plain = getattr(modules["package"], plain_name)(*kargs)
    runs = {name: (lambda f=getattr(mod, wrapper): f(*kargs))
            for name, mod in modules.items()}
    paths = {name: _segreduce_path(getattr(mod, wrapper), inputs["segreduce_path"])
             for name, mod in modules.items()} if args.kernel == "segreduce" else {}
    result = {"card": smi, "kernel": args.kernel, "n_isects": inputs["n_isects"],
              "width": inputs["width"], "height": inputs["height"],
              "inputs": _input_stats(args.kernel, kargs), "build_s": build_s,
              "builds": {}}
    # yardstick of the rate this card reaches at these sizes: a copy of the
    # kernel's tensor inputs (each byte read once and written once)
    tensors = [a for a in kargs if torch.is_tensor(a)]
    result["copy"] = {
        "bytes": 2 * sum(t.numel() * t.element_size() for t in tensors),
        "ms": _time_ms(lambda: [t.clone() for t in tensors], args.reps)}
    ref = None
    for name, (so, regs) in builds.items():
        _install(args.kernel, so, modules[name])
        out, again = runs[name](), runs[name]()
        torch.cuda.synchronize()
        err, ok = _check(args.kernel, out, plain)
        out, again = _as_tuple(out), _as_tuple(again)
        ref = out if ref is None else ref
        result["builds"][name] = {
            "ptxas": regs, "err": err, "ok": ok,
            "deterministic": all(torch.equal(a, b) for a, b in zip(out, again)),
            "equal_to_package": all(torch.equal(a, b) for a, b in zip(out, ref)),
            "launch_split": _launch_split(runs[name], args.reps),
            "ms": []}
        if paths:
            result["builds"][name].update(
                path_equal=torch.equal(paths[name](), out[0]), path_ms=[],
                path_split=_launch_split(paths[name], args.reps))
    order = list(builds) + list(builds)[::-1]
    for name in order:
        _install(args.kernel, builds[name][0], modules[name])
        result["builds"][name]["ms"].append(_time_ms(runs[name], args.reps))
        if paths:
            result["builds"][name]["path_ms"].append(_time_ms(paths[name], args.reps))
    _build._libs.pop(args.kernel, None)
    print(json.dumps(result), flush=True)
    ok = all(b["ok"] for b in result["builds"].values())
    if args.kernel in ("rasterize_bwd", "segreduce"):
        ok = ok and all(b["deterministic"] for b in result["builds"].values())
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
