"""The training CLI on one card and under torchrun on (data x gauss) meshes,
in one call, on the full synthetic scene.

    python -m clm_gs_tpu_torch.utils.mesh_cli [--strategy clm_offload]
        [--shapes 2x2 ...] [--iterations 200] [--out DIR]

Writes `synthetic_colmap.make_dataset(full=True)` (1M Gaussians, 32 cameras
of 1237x822) to a temporary directory, then runs `python -m
clm_gs_tpu_torch.train` with FULL_TRAIN_ARGS under the strategy on one card,
and under `torch.distributed.run` with one process a card for each
--mesh_shape in --shapes (the host needs as many cards as the largest mesh
holds). Prints one JSON line a run: the exit code, seconds, the log's mesh
lines, it/s, the final test PSNR, the Gaussian count, the last `clm overlap:`
and `clm data sum:` lines and the --enable_timer spans (mean ms a call).
With --out, each run's python.log and the tail of its output are kept there.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from clm_gs_tpu_torch.utils.synthetic_colmap import FULL_TRAIN_ARGS, make_dataset

STRATEGIES = ("no_offload", "naive_offload", "clm_offload")


def parse_log(text: str) -> dict:
    """What a reader compares across runs, from a python.log."""
    out = {"mesh_lines": [], "test_psnr": None, "gaussians": None, "it_per_s": None,
           "overlap": None, "data_sum": None, "spans_ms": {}}
    for ln in text.splitlines():
        if ln.startswith(("multi-chip mesh", "clm data-parallel", "mesh data axis")):
            out["mesh_lines"].append(ln)
        elif "Evaluating test:" in ln:
            out["test_psnr"] = float(ln.split("PSNR ")[1])
        elif " loss: " in ln:
            out["gaussians"] = int(ln.split("n3dgs: ")[1])
        elif ln.startswith("end2end total_time:"):
            out["it_per_s"] = float(ln.split("throughput ")[1].split(" it/s")[0])
        elif ln.startswith("clm overlap: "):
            out["overlap"] = ln
        elif ln.startswith("clm data sum: "):
            out["data_sum"] = ln
        elif ": sum " in ln and " ms over " in ln:
            key, rest = ln.split(": sum ")
            ms, calls = rest.split(" ms over ")
            out["spans_ms"][key] = float(ms) / max(int(calls.split()[0]), 1)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--strategy", choices=STRATEGIES, default="clm_offload")
    ap.add_argument("--shapes", nargs="*", default=["2x2"])
    ap.add_argument("--iterations", type=int, default=200)
    ap.add_argument("--out", help="directory for each run's python.log and output")
    args = ap.parse_args(argv)
    train = [a for a in FULL_TRAIN_ARGS if not a.endswith("_offload")]
    train += [f"--{args.strategy}", "--iterations", str(args.iterations)]
    runs = {"single": [sys.executable, "-m", "clm_gs_tpu_torch.train"]}
    for shape in args.shapes:
        a, b = (int(x) for x in shape.split("x"))
        runs[f"torchrun_{shape}"] = [sys.executable, "-m", "torch.distributed.run",
                                     "--nproc_per_node", str(a * b), "-m",
                                     "clm_gs_tpu_torch.train", "--mesh_shape", shape]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    failed = False
    with tempfile.TemporaryDirectory(prefix="mesh_cli_") as work:
        scene = make_dataset(os.path.join(work, "scene"), full=True)
        for name, cmd in runs.items():
            model = os.path.join(work, name)
            t0 = time.perf_counter()
            res = subprocess.run(
                cmd + ["-s", scene, "-m", model, "--decode_dataset_path",
                       os.path.join(work, "decoded"), "--quiet"] + train,
                capture_output=True, text=True, check=False)
            seconds = time.perf_counter() - t0
            log = os.path.join(model, "python.log")
            text = open(log).read() if os.path.exists(log) else ""
            if args.out:
                if text:
                    shutil.copy(log, os.path.join(args.out, f"python_{name}.log"))
                with open(os.path.join(args.out, f"{name}.out"), "w") as f:
                    f.write(res.stdout[-20000:] + "\n----\n" + res.stderr[-20000:])
            failed |= res.returncode != 0
            print(json.dumps({"run": name, "strategy": args.strategy, "rc": res.returncode,
                              "s": seconds, **parse_log(text)}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
