"""The check's readings over seeds, for setting a cell's limits
(limits/<cell>.json) on the chip, at the cell's own size:

    python3 perfbench/calibrate.py --workload <name> --seeds 1 2 ... \\
        [--control 3] [--faults 3]

For each seed, one JSON line: the program's readings against the float32
reference (`program`), and for the first `--control` seeds the reference in
bfloat16 put in the program's place (`control`), for the first `--faults`
seeds the program with each fault of faults.py planted (`half`, `alter`;
`unchanged` reads 1 on grad_gap and change_gap by construction and needs no
run). Each reading runs the check's steps alone, with no measured window.
The last line sums up: the largest program reading and the smallest of
each other kind, per number.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--faults", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import check, faults, harness

    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    _, config, traffic = harness.load_cell(args.workload)
    n = traffic["check_steps"]
    summary = {}

    def note(kind, values):
        pick = max if kind == "program" else min
        for k, v in values.items():
            summary.setdefault(kind, {})[k] = pick(v, summary.get(kind, {}).get(k, v))

    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        scene = harness.Scene(config, seed, dev)
        line = {"seed": seed}
        runs = ["program"] + (["half", "alter"] if i < args.faults else [])
        seen = {}
        for kind in runs:
            if scene.first is None:
                scene.first, _ = scene.gaussians()
            prog, feed, step = harness.start(scene, traffic, seed, dev)
            if kind != "program":
                faults.plant(kind, prog)
            seen[kind] = harness.check_steps(prog, step, scene.first, n)
            bsz = feed.bsz
            prog.close()
            del prog, step
            scene.first = None
            harness.free(dev)
        ref = harness.reference(scene, seen["program"], bsz, traffic, dev)
        for kind, s in seen.items():
            line[kind] = check.readings(s.result(), ref)
            note(kind, line[kind])
        if i < args.control:
            low = harness.reference(scene, seen["program"], bsz, traffic, dev,
                                    torch.bfloat16)
            line["control"] = check.readings(low, ref)
            note("control", line["control"])
        line["losses"] = {"program": seen["program"].losses, "reference": ref["losses"]}
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del scene
        harness.free(dev)
    print(json.dumps({"summary": summary, "workload": args.workload,
                      "device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
