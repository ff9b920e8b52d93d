"""The flagship-scale quality run on the port: the JAX repo's
tools/make_flagship_scene.py (the scene), tools/flagship_run.py (its
training command) and tools/collect_quality.py (the record), the port's own
copies.

The scene is the repo's stand-in for Mip-NeRF 360's bicycle at images_4
(about 1 Mpix a camera): 600,000 Gaussians with trained-scene statistics
(`bench_scene._surface_gaussians`) whose colours are a smooth two-scale
positional palette with a little per-Gaussian noise, so that held-out views
are predictable; 64 cameras of 1237x822 on three rings; ground truth
rendered on the card by `render_one_cam`; a COLMAP sparse init from a noised
subsample of the true centres. The run is no_offload for 15,000 iterations
at bsz 4 with densification from 500 every 100 until min(9000, 0.6 iters).

    python -m clm_gs_tpu_torch.utils.flagship make SCENE [--n 600000] \\
        [--cams 64] [--width 1237] [--height 822] [--n_init 150000]
    python -m clm_gs_tpu_torch.utils.flagship run SCENE OUT [--iters 15000]
    python -m clm_gs_tpu_torch.utils.flagship collect OUT RECORD.json [--label L]

`make` draws everything from one numpy RandomState(7) in the tool's order
(the Gaussians, the palette's two matrices and phases, the DC noise, the
init subsample, its noise) and writes the same cameras.bin, images.bin and
points3D.bin. The JAX repo's record (QUALITY_r05.json) was made from 150,000
init points, which is `--n_init`'s default here; the tool's own default,
FLAGSHIP_INIT_POINTS, is 300,000. `run` writes RUN_INFO beside the log (the
card, its power limit, peak device bytes, launches); `collect` reads
events.jsonl, python.log and args.json into the tool's record, with its
densification analysis, and adds RUN_INFO's fields and the RSS at each
eval. Every entry point runs on the card unless the caller passes
device="cpu".
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

import numpy as np
import torch

SEED = 7
N_GAUSS = 600_000
N_CAMS = 64
WIDTH, HEIGHT = 1237, 822
N_INIT = 150_000
GRANULE = 65_536
RUN_INFO = "flagship_run.json"
INFO = "flagship.json"


def flagship_cameras(n_cams, width, height):
    """Three rings around the 8x8 surface scene: orbit, elevated, high."""
    from clm_gs_tpu_torch.utils.bigcity import lookat_camera

    cams = []
    n1 = n_cams // 2
    n2 = n_cams - n1 - n_cams // 8
    n3 = n_cams - n1 - n2
    uid = 1
    for i in range(n1):
        a = 2 * np.pi * i / n1
        pos = np.array([6.0 * np.sin(a), 0.3, -6.0 * np.cos(a)])
        cams.append(lookat_camera(uid, pos, np.zeros(3), width, height))
        uid += 1
    for i in range(n2):
        a = 2 * np.pi * (i + 0.5) / n2
        pos = np.array([4.5 * np.sin(a), 1.8, -4.5 * np.cos(a)])
        cams.append(lookat_camera(uid, pos, np.array([0.0, -0.5, 0.0]), width, height))
        uid += 1
    for i in range(n3):
        a = 2 * np.pi * (i + 0.25) / max(n3, 1)
        pos = np.array([3.0 * np.sin(a), 4.0, -3.0 * np.cos(a)])
        cams.append(lookat_camera(uid, pos, np.array([0.0, -1.0, 0.0]), width, height))
        uid += 1
    return cams


def flagship_gaussians(n, rng):
    """The surface Gaussians with the palette colours and damped high-order
    SH: (xyz, log_scale, quat, opacity, sh), float32, drawn from `rng` in
    the tool's order."""
    from clm_gs_tpu_torch.utils.bench_scene import _surface_gaussians

    xyz, log_scale, quat, opacity, sh = _surface_gaussians(n, rng)
    Wmix = rng.uniform(0.5, 1.4, (3, 3)) * rng.choice([-1.0, 1.0], (3, 3))
    Wfine = rng.uniform(3.0, 7.0, (3, 3)) * rng.choice([-1.0, 1.0], (3, 3))
    phase = rng.uniform(0, 2 * np.pi, 3)
    phase2 = rng.uniform(0, 2 * np.pi, 3)
    rgb = (0.5 + 0.22 * np.sin(xyz @ Wmix.T.astype(np.float32) + phase)
           + 0.20 * np.sin(xyz @ Wfine.T.astype(np.float32) + phase2))
    sh[:, 0:3] = (rgb - 0.5) / 0.28209479 + 0.03 * rng.normal(size=(n, 3)).astype(np.float32)
    sh[:, 3:] *= 0.2
    return xyz, log_scale, quat, opacity, sh


def make(root, n=N_GAUSS, n_cams=N_CAMS, width=WIDTH, height=HEIGHT, n_init=N_INIT,
         device="cuda") -> dict:
    """Write the scene under `root` (images/, sparse/0/, INFO); returns INFO's
    dict."""
    from PIL import Image

    from clm_gs_tpu_torch import _build
    from clm_gs_tpu_torch.data import colmap
    from clm_gs_tpu_torch.data.cameras import stack_cameras
    from clm_gs_tpu_torch.models.gaussians import GaussianParams
    from clm_gs_tpu_torch.strategies.base import render_one_cam
    from clm_gs_tpu_torch.utils.general import check_device

    device = check_device(device)
    t0 = time.perf_counter()
    rng = np.random.RandomState(SEED)
    xyz, log_scale, quat, opacity, sh = flagship_gaussians(n, rng)
    cap = -(-n // GRANULE) * GRANULE

    def pad(x):
        return torch.from_numpy(np.pad(x, [(0, cap - n)] + [(0, 0)] * (x.ndim - 1))).to(device)

    params = GaussianParams(xyz=pad(xyz), opacity=pad(opacity), log_scale=pad(log_scale),
                            quat=pad(quat), sh=pad(sh))
    alive = torch.arange(cap, device=device) < n
    cams = flagship_cameras(n_cams, width, height)
    cb = stack_cameras(cams, device=device)
    bg = torch.zeros(3, device=device)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    names = [f"img_{i:03d}.png" for i in range(n_cams)]
    _build.reset_launches()
    t1 = time.perf_counter()
    isects = []
    with torch.no_grad():
        for i, name in enumerate(names):
            out = render_one_cam(params, alive, cb.viewmats[i], cb.Ks[i],
                                 cb.camera_centers[i], 3, width, height, bg)
            isects.append(int(out.n_isects))
            # truncation to a level, as the tool's astype(uint8)
            arr = (torch.clamp(out.image, 0, 1) * 255).to(torch.uint8).cpu().numpy()
            Image.fromarray(arr.transpose(1, 2, 0)).save(os.path.join(img_dir, name),
                                                         compress_level=1)
    render_s = time.perf_counter() - t1
    launches = dict(_build.LAUNCHES)
    del params, alive

    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    K = cams[0].K
    colmap.write_cameras_binary(os.path.join(sparse, "cameras.bin"), {
        1: colmap.ColmapCamera(1, "PINHOLE", width, height,
                               np.array([K[0, 0], K[1, 1], width / 2, height / 2]))})
    colmap.write_images_binary(os.path.join(sparse, "images.bin"), {
        i + 1: colmap.ColmapImage(i + 1, colmap.rotmat2qvec(cam.R.T),
                                  cam.T.astype(np.float64), 1, names[i])
        for i, cam in enumerate(cams)})
    # SfM-like init: a noised subsample of the true centres
    sel = rng.choice(n, size=min(n_init, n), replace=False)
    pts = xyz[sel] + 0.02 * rng.normal(size=(len(sel), 3)).astype(np.float32)
    dc_rgb = np.clip(sh[sel, :3] * 0.28209479 + 0.5, 0, 1)
    colmap.write_points3d_binary(os.path.join(sparse, "points3D.bin"),
                                 pts.astype(np.float64), (dc_rgb * 255).astype(np.uint8))
    info = {"n": n, "capacity": cap, "cams": n_cams, "width": width, "height": height,
            "n_init": int(len(sel)), "render_s": render_s,
            "total_s": time.perf_counter() - t0, "gt_isects": [min(isects), max(isects)],
            "gt_launches": launches}
    with open(os.path.join(root, INFO), "w") as f:
        json.dump(info, f, indent=1)
    return info


def train_argv(iters: int, scene, out) -> list:
    """The training command of tools/flagship_run.py (its --isect_cap is
    accepted and ignored by the port)."""
    return [
        "-s", scene, "-m", out, "--no_offload", "--eval",
        "--llffhold", "8", "--bsz", "4", "--iterations", str(iters),
        "--test_iterations", *[str(i) for i in range(1000, iters + 1, 1000)],
        "--save_iterations", "0",
        "--densify_from_iter", "500",
        "--densification_interval", "100",
        "--densify_until_iter", str(min(9000, int(iters * 0.6))),
        "--opacity_reset_interval", "3000",
        "--isect_cap", str(6 * 2**20),
        "--log_interval", "500", "--quiet",
    ]


def run(scene, out, iters: int = 15000, device="cuda") -> dict:
    """Train the scene into `out`; returns RUN_INFO's fields and the test
    PSNR curve."""
    from clm_gs_tpu_torch.utils.parity30k import parse_run, train_run

    info = train_run(train_argv(iters, scene, out), out, RUN_INFO, device)
    return info | parse_run(out)


def _scene_label(info) -> str:
    if info is None:
        return "synthetic COLMAP (no flagship.json beside the scene)"
    return (f"{info['cams']}-cam {info['width']}x{info['height']} "
            f"({info['width'] * info['height'] / 1e6:.2f} Mpix) synthetic COLMAP, "
            "trained-3DGS statistics + smooth two-scale positional palette (the JAX "
            f"repo's tools/make_flagship_scene.py draws), {info['n'] // 1000}k-gaussian "
            f"GT, {info['n_init'] // 1000}k init points")


def collect(run_dir, out_path, label=None) -> dict:
    """The tool's record of a run directory, written to `out_path`: the test
    PSNR against wall time, the train PSNR, the Gaussian counts, the host
    memory at the last densification, end2end and the densification
    analysis; with RUN_INFO's fields, the RSS at each test eval and the
    scene's INFO."""
    from clm_gs_tpu_torch.utils.parity30k import eval_rss_gb

    label = label or os.path.basename(run_dir.rstrip("/"))
    with open(os.path.join(run_dir, "events.jsonl")) as f:
        events = [json.loads(ln) for ln in f if ln.strip()]
    t0 = events[0]["t"] if events else 0.0
    curve = [{"iteration": e["iteration"], "wall_s": round(e["t"] - t0, 1),
              "test_psnr": round(e["psnr"], 3)}
             for e in events if e.get("kind") == "eval" and e.get("split") == "test"]
    train_curve = {e["iteration"]: round(e["psnr"], 3) for e in events
                   if e.get("kind") == "eval" and e.get("split") == "train"}
    dens = [e for e in events if e.get("kind") == "densify"]
    with open(os.path.join(run_dir, "python.log")) as f:
        log = f.read()
    e2e = re.findall(r"end2end total_time: ([\d.]+) s", log)
    with open(os.path.join(run_dir, "args.json")) as f:
        args = json.load(f)
    scene = args.get("model", {}).get("source_path")
    info = None
    if scene and os.path.exists(os.path.join(scene, INFO)):
        with open(os.path.join(scene, INFO)) as f:
            info = json.load(f)
    rec = {
        "label": label,
        "scene": _scene_label(info),
        "strategy": next(k for k in ("no_offload", "naive_offload", "clm_offload")
                         if args.get("aux", {}).get(k)),
        "iterations": args.get("opt", {}).get("iterations"),
        "bsz": args.get("opt", {}).get("bsz"),
        "test_psnr_vs_wall": curve,
        "train_psnr": train_curve,
        "final_n3dgs": dens[-1]["num_3dgs"] if dens else None,
        "max_n3dgs": max((d["num_3dgs"] for d in dens), default=None),
        "host_gb_final": round(dens[-1]["host_gb"], 2) if dens else None,
        "end2end_s": float(e2e[-1]) if e2e else None,
    }
    # where the Gaussians go: each densification's change, and the large
    # prunes, which land about 100 iterations after each opacity reset
    resets = [int(m) for m in re.findall(r"iteration\[(\d+),\d+\) reset_opacity", log)]
    deltas = [{"iter": dens[i]["iteration"],
               "delta": dens[i]["num_3dgs"] - dens[i - 1]["num_3dgs"]}
              for i in range(1, len(dens))]
    rec["densification"] = {
        "init_n3dgs": dens[0]["num_3dgs"] if dens else None,
        "opacity_reset_iters": resets,
        "big_prune_events": [d for d in deltas if d["delta"] < -1000],
        "note": ("large prunes land ~100 iters after each opacity reset "
                 "(redundant splats from the dense init decay under "
                 "min_opacity); clone/split subcritical because the init "
                 "already resolves the palette's spatial detail"),
    }
    rec["rss_gb_at_eval"] = eval_rss_gb(run_dir)
    rec["scene_info"] = info
    path = os.path.join(run_dir, RUN_INFO)
    if os.path.exists(path):
        with open(path) as f:
            run_info = json.load(f)
        rec |= {k: run_info.get(k) for k in ("card", "peak_device_bytes",
                                             "peak_rss_bytes", "run_s", "launches")}
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    mk = sub.add_parser("make", help="write the scene")
    mk.add_argument("scene")
    mk.add_argument("--n", type=int, default=N_GAUSS)
    mk.add_argument("--cams", type=int, default=N_CAMS)
    mk.add_argument("--width", type=int, default=WIDTH)
    mk.add_argument("--height", type=int, default=HEIGHT)
    mk.add_argument("--n_init", type=int, default=N_INIT,
                    help="init points (the JAX record's 150,000; its tool's default "
                         "FLAGSHIP_INIT_POINTS is 300,000)")
    rn = sub.add_parser("run", help="train the scene")
    rn.add_argument("scene")
    rn.add_argument("out")
    rn.add_argument("--iters", type=int, default=15000)
    co = sub.add_parser("collect", help="write a run's record")
    co.add_argument("out")
    co.add_argument("record")
    co.add_argument("--label", default=None)
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if args.cmd == "make":
        res = make(args.scene, args.n, args.cams, args.width, args.height, args.n_init,
                   device=device)
    elif args.cmd == "run":
        res = run(args.scene, args.out, args.iters, device=device)
    else:
        res = collect(args.out, args.record, args.label)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
