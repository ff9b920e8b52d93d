"""Small sizes of the benchmark's cells for the CPU tests: a few thousand
Gaussians, 96x64 views, two cameras a batch."""

import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def config(name: str) -> dict:
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    cfg = copy.deepcopy(cfg)
    n = 3000
    scene = cfg["scene"]
    if scene["kind"] == "surface":
        scene["splat_scale"] *= (scene["n"] / n) ** 0.5
    else:
        scene["extent"], cfg["cameras"]["extent"] = 8.0, 8.0
        scene["buildings"] = 12
        cfg["cameras"]["elevation"] = 4.0
    scene["n"] = n
    cfg["cameras"].update(count=16, width=96, height=64)
    cfg["capacity_granule"] = 1024
    return cfg


def traffic(name: str) -> dict:
    t = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    flags = list(t["flags"])
    flags[flags.index("--bsz") + 1] = "2"
    t["flags"] = flags
    t["warm_batches"] = 1
    t["trace_batches"] = 1
    return t


CELLS = {
    "bicycle-6m.clm": ("bicycle-6m", "clm-bsz4"),
    "bigcity-25m.clm": ("bigcity-25m", "clm-bsz64-sparse"),
    "bicycle-6m.no_offload": ("bicycle-6m", "no_offload-bsz4"),
}


def cell(name: str):
    c, t = CELLS[name]
    return config(c), traffic(t)
