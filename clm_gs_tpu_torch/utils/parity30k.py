"""The full-schedule strategy parity on the port: the JAX repo's
tools/parity30k.py (one strategy's run on the parity scene) and
tools/collect_parity.py (the record of several runs), the port's own copies.

The reference's validation bar is test PSNR agreeing across the three
strategies on a full 30k schedule (its release_scripts/mip360_README.md).
The parity scene is the 48-camera 320x240 synthetic COLMAP scene of seed 3
(`synthetic_colmap.make_dataset(n_points=1500, n_cams=48, width=320,
height=240, seed=3)`, whose draws follow tests/make_synthetic_colmap.py);
the schedule is the tool's: 30,000 iterations at bsz 4, densification from
500 to 15,000 every 100, an opacity reset every 3,000, gradient threshold
2e-4, an eval every 1,000 (test_iterations are intervals, so the evals are
logged at 997, 1997, ...).

    python -m clm_gs_tpu_torch.utils.parity30k make ROOT
    python -m clm_gs_tpu_torch.utils.parity30k run ROOT STRATEGY... [--iters N]
        [--seed S...]
    python -m clm_gs_tpu_torch.utils.parity30k collect OUT.json DIR_OR_RECORD...

`make` writes the scene to ROOT/scene; `run` trains one strategy
(no_offload, naive_offload or clm_offload) into ROOT/run_STRATEGY through
`clm_gs_tpu_torch.train.main` (making the scene first if it is missing, as
the tool does), writes RUN_INFO there (the card, its power limit, peak
device bytes, the kernels' launches, the run's seconds) and prints one JSON
line; with several strategies, each runs in a process of its own, all at
once (they share the card), and the line lists their lines. `--seed S`
passes the training seed (the camera shuffle and the split noise; the
scene stays seed 3's) and trains into ROOT/run_STRATEGY_sS; with several
seeds every (strategy, seed) pair runs in a process of its own, all at
once. `collect`
writes the record: the tool's keys (the test PSNR at each
milestone, final Gaussians, densifications, end2end, the last iteration,
the spread at the highest common milestone and each pair's), and the port's
own: RUN_INFO's fields, the process's RSS at every eval (events.jsonl) and
each pair's spread at every common milestone. A `.json` argument merges the
runs of an earlier record. Every entry point runs on the card unless the
caller passes device="cpu".
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

import torch

STRATEGIES = ("no_offload", "naive_offload", "clm_offload")
RUN_INFO = "parity_run.json"
# the reference's bar for the pairwise test PSNR spread (dB), and the
# milestone from which it is held
SPREAD_BAR_DB = 0.3
SPREAD_FROM_ITER = 5000


def scene_dir(root) -> str:
    return os.path.join(root, "scene")


def run_dir(root, strategy, seed=None) -> str:
    return os.path.join(root, f"run_{strategy}" + ("" if seed is None else f"_s{seed}"))


def make(root, device="cuda") -> str:
    """The parity scene under ROOT/scene; returns its path."""
    from clm_gs_tpu_torch.utils.synthetic_colmap import make_dataset

    return make_dataset(scene_dir(root), n_points=1500, n_cams=48, width=320, height=240,
                        seed=3, device=device)


def train_argv(strategy, iters: int, scene, out) -> list:
    """The training command of tools/parity30k.py (its --isect_cap is
    accepted and ignored by the port)."""
    return [
        "-s", scene, "-m", out, f"--{strategy}", "--eval",
        "--llffhold", "8", "--bsz", "4", "--iterations", str(iters),
        "--test_iterations", *[str(i) for i in range(1000, iters + 1, 1000)],
        "--save_iterations", str(iters),
        "--densify_from_iter", "500",
        "--densification_interval", "100",
        "--densify_until_iter", "15000",
        "--opacity_reset_interval", "3000",
        "--densify_grad_threshold", "0.0002",
        "--isect_cap", "262144", "--log_interval", "500",
        "--quiet",
    ]


def train_run(argv, out, info_name, device) -> dict:
    """`train.main(argv)` with the run's facts beside its log: the card and
    its power limit, peak device bytes, the kernels' launches, the run's
    seconds and the process's peak RSS, written to out/info_name and
    returned."""
    from clm_gs_tpu_torch import _build
    from clm_gs_tpu_torch.train import main as train_main
    from clm_gs_tpu_torch.utils.general import check_device, nvidia_smi, peak_rss_bytes

    device = check_device(device)
    if device.type == "cuda":
        torch.empty(1, device=device)
        torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    train_main(argv, device=device)
    info = {"argv": argv, "run_s": time.perf_counter() - t0,
            "card": nvidia_smi() if device.type == "cuda" else None,
            "device": str(device),
            "peak_device_bytes": (torch.cuda.max_memory_allocated()
                                  if device.type == "cuda" else None),
            "peak_rss_bytes": peak_rss_bytes(), "launches": dict(_build.LAUNCHES)}
    with open(os.path.join(out, info_name), "w") as f:
        json.dump(info, f, indent=1)
    return info


def run(root, strategy, iters: int = 30000, device="cuda", seed=None) -> dict:
    """Train `strategy` on the parity scene into `run_dir(root, strategy,
    seed)`, with --seed `seed` when given; returns RUN_INFO's fields and
    `parse_run` of the log."""
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy {strategy!r} is not one of {STRATEGIES}")
    scene = scene_dir(root)
    if not os.path.exists(os.path.join(scene, "sparse")):
        make(root, device=device)
    out = run_dir(root, strategy, seed)
    argv = train_argv(strategy, iters, scene, out)
    if seed is not None:
        argv += ["--seed", str(seed)]
    info = train_run(argv, out, RUN_INFO, device)
    return {"strategy": strategy, "seed": seed, **info, **parse_run(out)}


def run_concurrent(root, strategies, iters: int = 30000, timeout=None, seeds=(None,)) -> dict:
    """`run` of each strategy at each seed in a process of its own
    (`python -m clm_gs_tpu_torch.utils.parity30k run`), all at once, after
    `make` in this one if the scene is missing; returns {strategy (with
    `_sS` at seed S): its JSON line}. A process that fails raises, and
    every process is stopped first."""
    import subprocess

    if not os.path.exists(os.path.join(scene_dir(root), "sparse")):
        make(root)
    # the directory that holds the package
    top = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    procs = {s if seed is None else f"{s}_s{seed}": subprocess.Popen(
        [sys.executable, "-m", "clm_gs_tpu_torch.utils.parity30k", "run", root, s,
         "--iters", str(iters)] + ([] if seed is None else ["--seed", str(seed)]),
        cwd=top, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for s in strategies for seed in seeds}
    out = {}
    try:
        for s, p in procs.items():
            stdout, stderr = p.communicate(timeout=timeout)
            lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
            if p.returncode != 0 or not lines:
                raise RuntimeError(f"parity30k run {s}: rc {p.returncode}\n{stderr[-4000:]}")
            out[s] = json.loads(lines[-1])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def eval_rss_gb(run_dir_) -> dict:
    """{iteration: the process's RSS in GiB} at each test eval (events.jsonl)."""
    path = os.path.join(run_dir_, "events.jsonl")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        events = [json.loads(ln) for ln in f if ln.strip()]
    return {str(e["iteration"]): e.get("host_gb") for e in events
            if e.get("kind") == "eval" and e.get("split") == "test"}


def parse_run(d):
    """The tool's record of one run directory (None without a python.log)."""
    log_path = os.path.join(d, "python.log")
    if not os.path.exists(log_path):
        return None
    with open(log_path) as f:
        log = f.read()
    evals = re.findall(r"\[ITER (\d+)\] Evaluating (test|train): L1 ([\d.]+) PSNR ([\d.]+)",
                       log)
    tests = {int(i): float(p) for i, s, _, p in evals if s == "test"}
    n3dgs = re.findall(r"Now num of 3dgs: (\d+)", log)
    end2end = re.findall(r"end2end total_time: ([\d.]+) s", log)
    last_iter = re.findall(r"iteration\[(\d+),(\d+)\)", log)
    return {
        "test_psnr": {str(k): tests[k] for k in sorted(tests)},
        "final_n3dgs": int(n3dgs[-1]) if n3dgs else None,
        "n_densify_events": len(n3dgs),
        "end2end_s": float(end2end[-1]) if end2end else None,
        "reached_iter": int(last_iter[-1][1]) - 1 if last_iter else None,
    }


def _port_fields(d) -> dict:
    """The port's fields of a run directory: RUN_INFO's and the RSS at
    each test eval."""
    rec = {"rss_gb_at_eval": eval_rss_gb(d)}
    path = os.path.join(d, RUN_INFO)
    if os.path.exists(path):
        with open(path) as f:
            info = json.load(f)
        rec |= {k: info.get(k) for k in ("card", "peak_device_bytes", "peak_rss_bytes",
                                         "run_s", "launches")}
    return rec


def _milestones(rec):
    return set(int(k) for k in rec["test_psnr"])


def collect(out, sources) -> dict:
    """Write the record of the run directories (and earlier records) in
    `sources` to `out`; returns it."""
    runs = {}
    for d in sources:
        if d.endswith(".json"):
            # the strategies of an earlier record
            with open(d) as f:
                prev = json.load(f)
            for name, rec in prev.get("runs", {}).items():
                if name not in runs:
                    runs[name] = dict(rec, source=os.path.basename(d))
            continue
        name = os.path.basename(d.rstrip("/")).replace("run_", "")
        rec = parse_run(d)
        if rec:
            runs[name] = rec | _port_fields(d)
    # the spread at the highest milestone every strategy reached
    common = None
    for rec in runs.values():
        common = _milestones(rec) if common is None else common & _milestones(rec)
    spread = at_iter = None
    if common:
        at_iter = max(common)
        vals = [rec["test_psnr"][str(at_iter)] for rec in runs.values()]
        spread = round(max(vals) - min(vals), 3)
    # each pair at its own highest common milestone (a run stopped early is
    # compared as deep as it went), and at every common milestone
    pairwise, per_milestone = {}, {}
    names = sorted(runs)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            com = sorted(_milestones(runs[a]) & _milestones(runs[b]))
            if not com:
                continue
            diff = {m: round(abs(runs[a]["test_psnr"][str(m)] - runs[b]["test_psnr"][str(m)]),
                             3) for m in com}
            pairwise[f"{a}|{b}"] = {"at_iter": com[-1], "spread_db": diff[com[-1]]}
            per_milestone[f"{a}|{b}"] = {str(m): v for m, v in diff.items()}
    held = [v for p in per_milestone.values() for m, v in p.items()
            if int(m) >= SPREAD_FROM_ITER]
    cards = sorted({r["card"] for r in runs.values() if r.get("card")})
    record = {
        "schedule": {
            "iterations": 30000, "bsz": 4, "densify": "500..15000/100",
            "opacity_reset_interval": 3000, "densify_grad_threshold": 2e-4,
            "scene": "48-cam 320x240 synthetic COLMAP (seed 3)",
        },
        "runs": runs,
        "iso_iter_spread_db": spread,
        "spread_at_iter": at_iter,
        "pairwise": pairwise,
        "card": cards[0] if len(cards) == 1 else cards or None,
        "pairwise_at_milestones": per_milestone,
        "max_spread_from_5000_db": max(held, default=None),
        "spread_bar_db": SPREAD_BAR_DB,
    }
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
    return record


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    mk = sub.add_parser("make", help="write the parity scene to ROOT/scene")
    mk.add_argument("root")
    rn = sub.add_parser("run", help="train one strategy into ROOT/run_STRATEGY")
    rn.add_argument("root")
    rn.add_argument("strategy", choices=STRATEGIES, nargs="+")
    rn.add_argument("--iters", type=int, default=30000)
    rn.add_argument("--seed", type=int, nargs="+", default=[None],
                    help="training seeds (default: the CLI's, 0)")
    co = sub.add_parser("collect", help="write the record of run directories")
    co.add_argument("out")
    co.add_argument("sources", nargs="+")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if args.cmd == "make":
        res = {"scene": make(args.root, device=device)}
    elif args.cmd == "run" and len(args.strategy) == 1 and len(args.seed) == 1:
        res = run(args.root, args.strategy[0], args.iters, device=device, seed=args.seed[0])
    elif args.cmd == "run":
        res = run_concurrent(args.root, args.strategy, args.iters, seeds=args.seed)
    else:
        res = collect(args.out, args.sources)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
