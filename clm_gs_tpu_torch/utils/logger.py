"""Run logging (clm_gs_tpu/utils/logger.py; the port's own copy).

`python.log` carries the reference's line grammar, which
release_scripts/log2csv.py scrapes, so the line formats are an interface;
`events.jsonl` carries the same results as structured records.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class RunLogger:
    def __init__(self, folder: str, append: bool = False, quiet: bool = False):
        os.makedirs(folder, exist_ok=True)
        mode = "a" if append else "w"
        self.log = open(os.path.join(folder, "python.log"), mode)
        self.jsonl = open(os.path.join(folder, "events.jsonl"), mode)
        self.quiet = quiet

    def write(self, line: str):
        if not line.endswith("\n"):
            line += "\n"
        self.log.write(line)
        self.log.flush()
        if not self.quiet:
            print(line, end="", flush=True)

    def event(self, kind: str, **fields):
        self.jsonl.write(json.dumps({"t": time.time(), "kind": kind, **fields}) + "\n")
        self.jsonl.flush()

    # -- log2csv-compatible lines (release_scripts/log2csv.py:28-108) --

    def eval_result(self, iteration: int, name: str, l1: float, psnr: float):
        self.write(f"[ITER {iteration}] Evaluating {name}: L1 {l1} PSNR {psnr}")
        self.event("eval", iteration=iteration, split=name, l1=l1, psnr=psnr)

    def densify_report(
        self, it_lo: int, it_hi: int, num_3dgs: int, hbm_gb: float, host_gb: float
    ):
        self.write(
            f"iteration[{it_lo},{it_hi}) densify_and_prune. "
            f"Now num of 3dgs: {num_3dgs}. "
            f"Max Memory usage: {hbm_gb} GB. "
            f"Now Pinned Memory: {host_gb} GB"
        )
        self.event(
            "densify", iteration=it_lo, num_3dgs=num_3dgs, hbm_gb=hbm_gb,
            host_gb=host_gb,
        )

    def end2end(self, total_time_s: float, iterations: int):
        thpt = iterations / max(total_time_s, 1e-9)
        self.write(
            f"end2end total_time: {total_time_s:.3f} s, "
            f"iterations: {iterations}, throughput {thpt:.2f} it/s"
        )
        self.event(
            "end2end", total_time_s=total_time_s, iterations=iterations,
            throughput=thpt,
        )

    def close(self):
        self.log.close()
        self.jsonl.close()
