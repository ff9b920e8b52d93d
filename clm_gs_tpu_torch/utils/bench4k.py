"""The 4K training step on the port: the JAX repo's tools/bench4k.py over
bench.py's `run_child("no_offload")`, the port's own copy.

The bench scene (`bench_scene.make_scene`: 1,000,000 Gaussians in a
capacity of 1,048,576, 4 cameras on a circle of radius 6) at 3840x2160, the
reference's Rubble-4K resolution class: 60x68 tiles of 64x32 pixels, inside
the binning's limit of GEO_AXIS_LIMIT tiles per axis. One warm-up
`no_offload.train_step` with accumulate_stats=False, then 3 timed batches
behind a sync.

    python -m clm_gs_tpu_torch.utils.bench4k --out RECORD.json \\
        [--width 3840 --height 2160 --n 1000000 --cap 1048576]

The record uses bench.py's names where they mean the same thing: `mpix_s`
(3 batches x 4 cameras x W x H pixels over the timed seconds), `sec_per_batch`,
`n_gaussians`; and adds the card and its power limit, the peak device bytes
(torch.cuda.max_memory_allocated), the process's peak RSS, each camera's
instance count, the losses, the kernels' launches over the timed batches and
the tile grid against GEO_AXIS_LIMIT. `main(argv, device="cpu")` runs on the
CPU (with a smaller canvas and scene); otherwise on the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

WIDTH, HEIGHT = 3840, 2160
TIMED = 3


def bench_step(width=WIDTH, height=HEIGHT, n=None, cap=None, device="cuda"):
    """The bench scene at width x height, one warm-up step and TIMED timed
    steps; returns (record, (state, cam_batch, gts, bg)): the last state,
    for a caller that checks the kernels on its shapes."""
    from clm_gs_tpu_torch import _build
    from clm_gs_tpu_torch.ops.rasterize import TILE_H, TILE_W, tile_grid
    from clm_gs_tpu_torch.ops.tiles import GEO_AXIS_LIMIT
    from clm_gs_tpu_torch.strategies.no_offload import train_step
    from clm_gs_tpu_torch.utils import bench_scene
    from clm_gs_tpu_torch.utils.general import check_device, nvidia_smi, peak_rss_bytes

    device = check_device(device)
    tw, th = tile_grid(width, height)
    if tw >= GEO_AXIS_LIMIT or th >= GEO_AXIS_LIMIT:
        raise ValueError(f"{width}x{height} is {tw}x{th} tiles; the binning takes fewer "
                         f"than {GEO_AXIS_LIMIT} a side")
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    state, opt, cb, gts, lrs, adam_cfg, bg = bench_scene.make_scene(
        n=n or bench_scene.N, cap=cap or bench_scene.CAP, w=width, h=height, device=device)
    sync()
    scene_s = time.perf_counter() - t0
    bsz = gts.shape[0]

    def step(s, o):
        return train_step(s, o, cb, gts, 3, lrs, adam_cfg, bg, width, height,
                          accumulate_stats=False)

    t0 = time.perf_counter()
    state, opt, out = step(state, opt)
    sync()
    warm_s = time.perf_counter() - t0
    warm_losses = out.losses.tolist()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    for _ in range(TIMED):
        state, opt, out = step(state, opt)
    losses = out.losses.tolist()  # reads the last batch back: the sync
    sync()
    dt = time.perf_counter() - t0
    rec = {
        "strategy": "no_offload",
        "resolution": f"{width}x{height}",
        "tiles": f"{tw}x{th} ({TILE_W}x{TILE_H} px)",
        "tiles_per_axis_limit": GEO_AXIS_LIMIT,
        "tile_grid": [tw, th],
        "card": nvidia_smi() if cuda else None,
        "device": str(device),
        "mpix_s": TIMED * bsz * width * height / dt / 1e6,
        "sec_per_batch": dt / TIMED,
        "n_gaussians": int(state.n_alive),
        "capacity": state.capacity,
        "cameras": bsz,
        "timed_batches": TIMED,
        "warmup_s": warm_s,
        "scene_s": scene_s,
        "peak_device_bytes": torch.cuda.max_memory_allocated() if cuda else None,
        "host_peak_bytes": peak_rss_bytes(),
        "n_isects": list(out.n_isects),
        "warm_losses": warm_losses,
        "losses": losses,
        "launches": dict(_build.LAUNCHES),
    }
    return rec, (state, cb, gts, bg)


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="the record's path")
    ap.add_argument("--width", type=int, default=WIDTH)
    ap.add_argument("--height", type=int, default=HEIGHT)
    ap.add_argument("--n", type=int, default=None, help="Gaussians (the bench scene's)")
    ap.add_argument("--cap", type=int, default=None, help="capacity (the bench scene's)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    rec, _ = bench_step(args.width, args.height, args.n, args.cap, device)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
