"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the port (`clm_gs_tpu_torch`): the
cell's scene and targets are drawn on the card from the seed, the port
trains through its first steps and warm batches (set-up), then for
`--seconds` seconds of whole batches (`--trace 0`: the end-to-end metrics)
or through a bounded number of profiled batches (`--trace 1`: the
per-layer metrics, the card's busy time and the breakdown); the plain
reference then follows the first steps and decides `correct`. The last
line of standard output is the result as one JSON object; the numbers
compared, each beside its limit, are the last lines of standard error.
Exits non-zero, printing no result, without enough cards, without the
port, or if a JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # build and kernel caches at fixed paths inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".cache" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / ".cache" / "torch_extensions"))
    sys.path.insert(0, str(ROOT))
    import torch

    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from perfbench import harness

    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              "cuda", t_start=T_START, bench=bench)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
