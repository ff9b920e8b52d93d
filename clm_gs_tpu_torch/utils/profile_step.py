"""Where a no_offload training step spends its time on the card.

    python3 -m clm_gs_tpu_torch.utils.profile_step [--out DIR]

Builds the bench scene (utils/bench_scene.py: 1M Gaussians, 4 cameras of
1237x822), runs one warm-up step, times WALL_STEPS steps one by one without
the profiler, then traces STEPS more with torch.profiler (CPU and CUDA
activities). Prints one JSON line: the card, wall seconds per step with the
profiler and without it (each timed step, their mean and median), the
peak device memory over the untraced steps, device-busy seconds per step
(the sum of kernel, memcpy and memset times on the card, from the trace),
the idle share of each wall time (the unprofiled one assumes the traced
steps keep the card as busy as the untraced ones), device time per category
of kernel, and the top kernels by device time. ``--out`` also writes the Chrome trace there.

The script imports only the package's public step API, so it also times
another checkout of the package: run it by path from that checkout's root
with ``PYTHONPATH=.``, or run this script by path with ``PYTHONPATH`` set to
the other checkout.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import time

import torch

STEPS = 3
WALL_STEPS = 10  # single steps on the card's host vary by several percent
# kernel name -> category, first match wins
CATEGORIES = (
    ("compositing bwd (kernel 2)", r"rasterize_bwd_kernel"),
    ("compositing fwd (kernel 1)", r"rasterize_fwd_kernel"),
    # with the names of the earlier three-launch kernels 3 and 4, so that
    # this script also profiles a checkout from before their redesign
    ("segment reduce (kernel 3)", r"segment_sums|run_sums|run_bounds"),
    ("forward fill (kernel 4)", r"fill_tile|block_last_valid|scan_carries|fill_apply"),
    ("sort", r"[Ss]ort|radix|Radix"),
    ("scan (cumsum)", r"[Ss]can"),
    ("gather/scatter/index", r"index|[Ss]catter|[Gg]ather"),
    ("reduction", r"reduce_kernel|[Rr]educe"),
    ("matmul", r"gemm|Gemm|sm90_xmma|cutlass"),
    ("copy/cat", r"[Cc]opy|[Cc]at(Array)?|memcpy|Memcpy|memset|Memset"),
    ("elementwise", r"elementwise|Elementwise"),
)


def _category(name: str) -> str:
    for cat, pat in CATEGORIES:
        if re.search(pat, name):
            return cat
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="directory for the Chrome trace")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: CUDA is not available")
    from torch.profiler import ProfilerActivity, profile

    from clm_gs_tpu_torch.strategies.no_offload import train_step
    from clm_gs_tpu_torch.utils.bench_scene import make_scene

    state, opt, cb, gts, lrs, cfg, bg = make_scene()
    w, h = cb.width, cb.height

    def step(state, opt):
        s, o, _ = train_step(state, opt, cb, gts, 3, lrs, cfg, bg, w, h)
        return s, o

    state, opt = step(state, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wall_steps = []
    for _ in range(WALL_STEPS):
        t0 = time.perf_counter()
        state, opt = step(state, opt)
        torch.cuda.synchronize()
        wall_steps.append(time.perf_counter() - t0)
    wall_plain = sum(wall_steps) / WALL_STEPS
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            state, opt = step(state, opt)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / STEPS

    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        k = kernels.setdefault(ev.key, [0, 0.0])
        k[0] += ev.count
        k[1] += dev_us
    busy = sum(v[1] for v in kernels.values()) / 1e6 / STEPS
    cats = {}
    for name, (_, us) in kernels.items():
        c = _category(name)
        cats[c] = cats.get(c, 0.0) + us / 1e3 / STEPS
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:25]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    ).stdout.strip()
    if args.out:
        from pathlib import Path

        Path(args.out).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(args.out) / "profile_step.json"))
    print(json.dumps({
        "card": smi, "steps": STEPS, "wall_s_per_step": wall,
        "device_busy_s_per_step": busy, "idle_share": 1.0 - busy / wall,
        "wall_s_per_step_unprofiled": wall_plain,
        "wall_s_unprofiled_median": sorted(wall_steps)[WALL_STEPS // 2],
        "wall_s_unprofiled_steps": wall_steps,
        "idle_share_unprofiled": 1.0 - busy / wall_plain,
        "max_memory_allocated": peak,
        "ms_per_step_by_category": dict(sorted(cats.items(), key=lambda kv: -kv[1])),
        "top_kernels": [
            {"name": n[:120], "calls_per_step": c / STEPS,
             "ms_per_step": us / 1e3 / STEPS, "category": _category(n)}
            for n, (c, us) in top
        ],
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
