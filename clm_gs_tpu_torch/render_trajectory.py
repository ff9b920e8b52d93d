"""Trajectory/inference renderer (clm_gs_tpu/render_trajectory.py).

Loads a trained model (PLY or tensor file) under a strategy's memory
placement, generates a smooth camera path through the scene and renders its
frames to PNG, with an optional MP4 and top-down view. The path follows the
JAX package's: waypoints on a shrunk convex hull (or bounding ellipse) of the
training-camera positions at a blended height, joined by a closed
Catmull-Rom spline, each frame looking at the centroid.

    python -m clm_gs_tpu_torch.render_trajectory --load_ply_path model.ply
        --out_dir frames/ [--num_frames 120] [--width 1280 --height 720]
        [--source_path scene/ (a trajectory from its training cameras)]
        [--model_dir run/] [--mp4 out.mp4] [--topdown top.png]
        [--no_offload | --naive_offload | --clm_offload]

The same flags and defaults as the JAX package's renderer. Under
--clm_offload the SH rows load into host memory (pinned) and each frame
gathers its visible rows (`clm_offload.eval_one_cam`); every other strategy
renders the full state on the device (`no_offload.eval_one_cam`), as in the
JAX package. `main(argv, device="cuda")` renders on the card; `device="cpu"`
runs the kernels' plain versions. The MP4 and the top-down view are
best-effort outputs: without imageio or matplotlib they are skipped with a
message.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch

from clm_gs_tpu_torch.utils.general import check_device


def catmull_rom_closed(points: np.ndarray, samples: int) -> np.ndarray:
    """Closed Catmull-Rom spline through (K, 3) waypoints -> (samples, 3)."""
    k = len(points)
    out = np.zeros((samples, 3), np.float64)
    for s in range(samples):
        t = s / samples * k
        i = int(math.floor(t)) % k
        f = t - math.floor(t)
        p0, p1, p2, p3 = (points[(i + j - 1) % k] for j in range(4))
        out[s] = 0.5 * (
            (2 * p1)
            + (-p0 + p2) * f
            + (2 * p0 - 5 * p1 + 4 * p2 - p3) * f * f
            + (-p0 + 3 * p1 - 3 * p2 + p3) * f * f * f
        )
    return out


def generate_orbit_trajectory(
    centers: np.ndarray, num_frames: int, shrink: float = 0.7,
    height_blend: float = 0.5, n_waypoints: int = 8,
) -> np.ndarray:
    """(num_frames, 3) camera positions around the scene from the (M, 3)
    training camera centres: the convex hull of their x-z footprint, or a
    bounding ellipse where scipy finds no hull (too few or collinear
    points), resampled to n_waypoints and shrunk toward the centroid."""
    centroid = centers.mean(axis=0)
    try:
        from scipy.spatial import ConvexHull

        xy = centers[:, [0, 2]]
        hull_pts = xy[ConvexHull(xy).vertices]
    except (ImportError, RuntimeError, ValueError):  # QhullError is a RuntimeError
        ang = np.linspace(0, 2 * np.pi, n_waypoints, endpoint=False)
        r = np.ptp(centers[:, [0, 2]], axis=0) / 2
        hull_pts = np.stack(
            [centroid[0] + r[0] * np.cos(ang), centroid[2] + r[1] * np.sin(ang)], 1
        )
    idx = np.linspace(0, len(hull_pts), n_waypoints, endpoint=False).astype(int)
    wp_xy = centroid[[0, 2]] + shrink * (hull_pts[idx] - centroid[[0, 2]])
    h = np.quantile(centers[:, 1], height_blend)
    waypoints = np.stack([wp_xy[:, 0], np.full(len(wp_xy), h), wp_xy[:, 1]], axis=1)
    return catmull_rom_closed(waypoints, num_frames)


def look_at_camera(pos, target, up=(0.0, -1.0, 0.0)):
    """viewmat (4, 4) world->view, COLMAP convention (y down, z forward)."""
    pos = np.asarray(pos, np.float64)
    fwd = np.asarray(target, np.float64) - pos
    fwd /= np.linalg.norm(fwd)
    up = np.asarray(up, np.float64)
    right = np.cross(up, fwd)
    if np.linalg.norm(right) < 1e-6:
        right = np.array([1.0, 0, 0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=0)  # world->view rotation
    vm = np.eye(4)
    vm[:3, :3] = R
    vm[:3, 3] = -R @ pos
    return vm.astype(np.float32)


def save_topdown_view(state, path, camera_centers=None, max_points=200_000, seed=0):
    """Top-down scatter of the live centres (x-z, coloured by y) with the
    trajectory drawn over it."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts = state.params.xyz[state.alive].cpu().numpy()
    if len(pts) > max_points:
        pts = pts[np.random.RandomState(seed).choice(len(pts), max_points)]
    fig, ax = plt.subplots(figsize=(10, 10))
    ax.scatter(pts[:, 0], pts[:, 2], s=0.2, c=pts[:, 1], cmap="viridis",
               alpha=0.5, linewidths=0)
    if camera_centers is not None:
        cc = np.asarray(camera_centers)
        ax.plot(cc[:, 0], cc[:, 2], "r.-", markersize=3, linewidth=0.5,
                label="trajectory")
        ax.legend()
    ax.set_aspect("equal")
    ax.set_xlabel("x")
    ax.set_ylabel("z")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def parse_args(argv=None) -> argparse.Namespace:
    """The renderer's flags, with --model_dir's args.json merged in and the
    newest PLY of its run chosen."""
    ap = argparse.ArgumentParser("clm_gs_tpu_torch trajectory renderer")
    ap.add_argument(
        "--model_dir", default="",
        help="trained run dir: reads args.json and the newest point_cloud "
             "(the reference's get_combined_args/cfg_args merge)",
    )
    ap.add_argument("--load_ply_path", default="")
    ap.add_argument("--load_pt_path", default="")
    ap.add_argument("--source_path", "-s", default="")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--num_frames", type=int, default=120)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--fov_deg", type=float, default=60.0)
    ap.add_argument("--sh_degree", type=int, default=3)
    ap.add_argument("--isect_cap", type=int, default=4 << 20,
                    help="accepted and ignored: the port sizes its instance "
                         "buffers to each frame's true count")
    ap.add_argument("--mp4", default="")
    ap.add_argument("--fps", type=int, default=30)
    ap.add_argument(
        "--topdown", default="",
        help="also write a top-down point-cloud + trajectory PNG here",
    )
    ap.add_argument("--no_offload", action="store_true")
    ap.add_argument("--naive_offload", action="store_true")
    ap.add_argument("--clm_offload", action="store_true")
    ap.add_argument("--white_background", action="store_true")
    args = ap.parse_args(argv)

    if args.model_dir:
        cfg_path = os.path.join(args.model_dir, "args.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                run_cfg = json.load(f)
            args.source_path = args.source_path or run_cfg["model"]["source_path"]
            args.sh_degree = run_cfg["model"]["sh_degree"]
            if run_cfg["model"].get("white_background"):
                args.white_background = True
        pc_root = os.path.join(args.model_dir, "point_cloud")
        iters = sorted(
            (d for d in os.listdir(pc_root) if d.startswith("iteration_")),
            key=lambda d: int(d.split("_")[1]),
        )
        args.load_ply_path = os.path.join(pc_root, iters[-1], "point_cloud.ply")
        print(f"using {args.load_ply_path}", file=sys.stderr)
    if not (args.load_pt_path or args.load_ply_path):
        ap.error("need --model_dir, --load_ply_path or --load_pt_path")
    return args


def load_model(args, device):
    """(state, host_sh): under --clm_offload the SH rows go to host memory
    (pinned on a card) and the state carries the (1, 48) placeholder, else
    host_sh is None."""
    from clm_gs_tpu_torch.models import gaussians as G

    load = G.load_tensors if args.load_pt_path else G.load_ply
    path = args.load_pt_path or args.load_ply_path
    if args.clm_offload:
        state, host_sh = load(path, device=device, host_sh=True)
    else:
        state, host_sh = load(path, device=device), None
    print(f"loaded {int(state.n_alive)} gaussians", file=sys.stderr)
    return state, host_sh


def trajectory(args, state):
    """(positions (F, 3), look-at target (3,)): around the training cameras
    of --source_path, else around a sample of the live centres."""
    if args.source_path:
        from clm_gs_tpu_torch.data import readers

        scene_type = readers.detect_scene_type(args.source_path)
        if scene_type == "city":
            info = readers.read_city_scene(args.source_path)
        elif scene_type == "blender":
            info = readers.read_blender_scene(args.source_path)
        else:
            info = readers.read_colmap_scene(args.source_path)
        centers = np.stack([c.camera_center for c in info.train_cameras])
    else:
        pts = state.params.xyz[state.alive].cpu().numpy()
        centers = pts[np.random.RandomState(0).choice(len(pts), min(4096, len(pts)))]
    return generate_orbit_trajectory(centers, args.num_frames), centers.mean(axis=0)


def frame_cameras(positions, target, device):
    """Every frame's (viewmat, camtoworld) as (F, 4, 4) float32 tensors on
    `device`, uploaded once."""
    vms = np.stack([look_at_camera(p, target) for p in positions])
    c2ws = np.linalg.inv(vms).astype(np.float32)
    return torch.from_numpy(vms).to(device), torch.from_numpy(c2ws).to(device)


def make_renderer(args, state, host_sh, device):
    """(render(viewmat, camtoworld) -> (3, H, W) image, clm context or
    None). The caller closes the context."""
    from clm_gs_tpu_torch.config import Config
    from clm_gs_tpu_torch.data.cameras import intrinsics_from_fov
    from clm_gs_tpu_torch.strategies import clm_offload, no_offload

    W, H = args.width, args.height
    fov = math.radians(args.fov_deg)
    fovy = 2 * math.atan(math.tan(fov / 2) * H / W)
    K = torch.from_numpy(intrinsics_from_fov(fov, fovy, W, H)).to(device)
    bg = torch.tensor([1.0, 1.0, 1.0] if args.white_background else [0.0, 0.0, 0.0],
                      dtype=torch.float32, device=device)
    if not args.clm_offload:
        return (lambda vm, c2w: no_offload.eval_one_cam(
            state, vm, K, c2w, args.sh_degree, bg, W, H)[0]), None
    # the compact path: only each frame's visible SH rows reach the device;
    # the context holds no gradients and no moments (adam_cfg None)
    if host_sh is not None:
        ctx = clm_offload.make_context_from_host(Config(), host_sh, None, device)
        state_r = state  # it carries the (1, 48) placeholder already
    else:
        ctx = clm_offload.make_context(Config(), state, None)
        state_r = clm_offload.strip_device_sh(state)
    return (lambda vm, c2w: clm_offload.eval_one_cam(
        (state_r, ctx), vm, K, c2w, args.sh_degree, bg, W, H)[0]), ctx


def main(argv=None, device="cuda"):
    args = parse_args(argv)
    device = check_device(device)
    state, host_sh = load_model(args, device)
    positions, target = trajectory(args, state)

    if args.topdown:
        try:
            save_topdown_view(state, args.topdown, camera_centers=positions)
            print(f"wrote {args.topdown}", file=sys.stderr)
        except ImportError as e:
            print(f"topdown view unavailable: {e}", file=sys.stderr)

    from PIL import Image

    os.makedirs(args.out_dir, exist_ok=True)
    vms, c2ws = frame_cameras(positions, target, device)
    render, ctx = make_renderer(args, state, host_sh, device)
    frames = []
    render_s = 0.0  # each frame's render and read-back, apart from its PNG
    t0 = time.perf_counter()
    try:
        for i in range(len(positions)):
            t1 = time.perf_counter()
            img = (torch.clamp(render(vms[i], c2ws[i]), 0, 1) * 255).to(torch.uint8)
            img = img.cpu().numpy().transpose(1, 2, 0)
            render_s += time.perf_counter() - t1
            Image.fromarray(img).save(os.path.join(args.out_dir, f"frame_{i:05d}.png"))
            if args.mp4:
                frames.append(img)
            if i % 10 == 0:
                print(f"frame {i}/{len(positions)}", file=sys.stderr)
    finally:
        if ctx is not None:
            ctx.close()
    dt = time.perf_counter() - t0
    print(f"rendered {len(positions)} frames in {dt:.3f} s "
          f"({len(positions) / max(dt, 1e-9):.3f} frames/s; render and read-back "
          f"{render_s:.3f} s)", file=sys.stderr)

    if args.mp4:
        try:
            import imageio.v2 as imageio

            imageio.mimwrite(args.mp4, frames, fps=args.fps)
            print(f"wrote {args.mp4}", file=sys.stderr)
        except (ImportError, OSError, RuntimeError, ValueError) as e:
            print(f"mp4 writing unavailable: {e}", file=sys.stderr)


if __name__ == "__main__":
    main()
