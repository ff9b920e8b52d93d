"""Time the training CLI of several checkouts, or of one with other flags, in
turns in one call on one card.

    python3 -m clm_gs_tpu_torch.utils.cli_ab --variant parent=path/to/checkout \
        --variant change=. --variant pinned=.,--pinned_host \
        [--strategy --clm_offload] [--rounds 2] [--out DIR]

A variant is ``NAME=ROOT`` with, after commas, flags added to its command
line; ROOT is the root of a checkout of the repo. The full synthetic COLMAP
scene (utils/synthetic_colmap.py ``make_dataset(full=True)``: 1M Gaussians,
32 cameras of 1237x822) is written once; an untimed 4-iteration run of
each variant builds the kernels and host libraries its checkout and flags
use (a build inside a timed run would fall in its end2end); then every
variant runs
``python -m clm_gs_tpu_torch.train`` from its own root with FULL_TRAIN_ARGS
(chip_smoke.py's `cli` phase) under ``--strategy``, each run a fresh process,
in turns: the variants, then the variants reversed, ``--rounds`` times.
Each run's python.log gives its end2end seconds and it/s, the mean of each
``--enable_timer`` span a call and, under clm, the last ``clm overlap:``
line. Prints one JSON line: the card and its power limit, every run in
order, and for each variant the median of its it/s, of its ``train_step``
ms and of each span. The logs are kept under ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from clm_gs_tpu_torch.utils.synthetic_colmap import FULL_TRAIN_ARGS, make_dataset

STRATEGIES = ("--no_offload", "--naive_offload", "--clm_offload")


def parse_log(text: str) -> dict:
    """end2end (s, it/s), the mean ms a call of each timer span, and the
    numbers of the last `clm overlap:` line of a python.log."""
    out = {"end2end_s": None, "it_per_s": None, "span_ms": {}, "overlap_ms": None}
    for ln in text.splitlines():
        if ln.startswith("end2end total_time:"):
            out["end2end_s"] = float(ln.split("total_time: ")[1].split(" s")[0])
            out["it_per_s"] = float(ln.split("throughput ")[1].split(" it/s")[0])
        elif " ms over " in ln and ": sum " in ln:
            key, rest = ln.split(": sum ")
            ms, calls = rest.split(" ms over ")
            out["span_ms"][key] = float(ms) / max(int(calls.split()[0]), 1)
        elif ln.startswith("clm overlap: "):
            work = float(ln.split("host work ")[1].split(" ms")[0])
            trail = float(ln.split("trailing ")[1].split(" ms")[0])
            out["overlap_ms"] = {"host_work": work, "trailing": trail}
    return out


def run_variant(root: str, extra: list, strategy: str, scene: str, decoded: str,
                out: str, argv_tail: list) -> dict:
    args = [a for a in FULL_TRAIN_ARGS if a not in STRATEGIES] + [strategy]
    cmd = [sys.executable, "-m", "clm_gs_tpu_torch.train", "-s", scene, "-m", out,
           "--decode_dataset_path", decoded, "--quiet", *args, *extra, *argv_tail]
    env = dict(os.environ, PYTHONPATH=str(Path(root).resolve()))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True,
                         check=False, timeout=900)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
        raise RuntimeError(f"{root} {extra}: rc {res.returncode}")
    return {"wall_s": wall, **parse_log(Path(out, "python.log").read_text())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", required=True,
                    help="NAME=ROOT[,FLAG...]")
    ap.add_argument("--strategy", default="--clm_offload", choices=STRATEGIES)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default="chiprun_out/cli_ab")
    args = ap.parse_args(argv)
    variants = {}
    for spec in args.variant:
        name, rest = spec.split("=", 1)
        root, *extra = rest.split(",")
        variants[name] = (root, extra)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.strip()
    print(smi, flush=True)
    Path(args.out).mkdir(parents=True, exist_ok=True)
    order = list(variants) + list(reversed(variants))
    runs = []
    with tempfile.TemporaryDirectory(prefix="cli_ab_") as work:
        scene, decoded = make_dataset(f"{work}/scene", full=True), f"{work}/decoded"
        for name, (root, extra) in variants.items():
            run_variant(root, extra, args.strategy, scene, decoded, f"{work}/warm_{name}",
                        ["--iterations", "4", "--test_iterations", "1000000",
                         "--checkpoint_iterations", "1000000", "--do_not_save"])
        for r in range(args.rounds):
            for i, name in enumerate(order):
                root, extra = variants[name]
                out = f"{work}/run_{r}_{i}_{name}"
                res = run_variant(root, extra, args.strategy, scene, decoded, out, [])
                Path(args.out, f"python_{r}_{i}_{name}.log").write_text(
                    Path(out, "python.log").read_text())
                runs.append({"variant": name, **res})
                print(json.dumps(runs[-1]), file=sys.stderr, flush=True)

    def med(name, get):
        vals = [v for v in (get(x) for x in runs if x["variant"] == name) if v is not None]
        return statistics.median(vals) if vals else None

    spans = sorted({k for x in runs for k in x["span_ms"]})
    summary = {name: {"it_per_s": med(name, lambda x: x["it_per_s"]),
                      "end2end_s": med(name, lambda x: x["end2end_s"]),
                      "span_ms": {k: med(name, lambda x, k=k: x["span_ms"].get(k))
                                  for k in spans}}
               for name in variants}
    print(json.dumps({"card": smi, "strategy": args.strategy, "order": order,
                      "rounds": args.rounds, "runs": runs, "median": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
