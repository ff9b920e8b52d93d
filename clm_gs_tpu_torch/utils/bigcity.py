"""The BigCity regime on the port: a city scene generator, its training
command and a log collector (the port's own copies of the JAX repo's
tools/make_bigcity_scene.py, degrade_ply.py, bigcity_run.py and
collect_bigcity.py).

The reference trains its BigCity scene with release_scripts/bigcity.sh: 102M
Gaussians, bsz 64, --sparse_adam, densification off. The scene here is tens
of millions of Gaussians over a 100x100-unit city (ground and the shells of
2,500 box buildings) seen by a serpentine street-level camera path, so that
each camera sees a local neighbourhood: the sparse visibility that
clm_offload's working sets exist for.

    python -m clm_gs_tpu_torch.utils.bigcity make ROOT --n N \
        [--cams 64 --width 640 --height 400 --degrade 0.3,0.15]
    python -m clm_gs_tpu_torch.utils.bigcity run ROOT OUT --iters I \
        [--no_offload | --naive_offload] [--device_loop [--pinned_ab]]
        [-- TRAIN FLAGS]
    python -m clm_gs_tpu_torch.utils.bigcity collect OUT

`make` draws the Gaussians and cameras from numpy's RandomState(11) (the
JAX tool's draws, in its order), renders the ground truth on the card from
the true model (`offload_common.eval_visible`: the visible rows of each
camera through `render_one_cam`), writes PNGs and COLMAP binaries
(`data/colmap.py`) and the model PLY `init_model.ply` that training
starts from: the true model with its SH damped and noised (`degrade_ply`'s
arithmetic, RandomState(0)), so that the test PSNR has room to rise. It
writes `bigcity.json` beside them, with the degraded init's test PSNR as
the CLI's eval would log it at iteration 0. `run` trains the scene with
`train_args` (BIGCITY_ARGS: the flags of bigcity.sh) through
`clm_gs_tpu_torch.train.main`; with --device_loop it then times one batch
of the final state in situ against `clm_offload.prepare_device_loop`'s
replay of the same batch (the card's share), and with --pinned_ab one more
batch on the host path against the same batch with --pinned_host, from one
start, to the bit. Both print one JSON line.
`collect` reads a run's python.log. Every entry point runs on the card
unless the caller passes device="cpu".
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import re
import sys
import threading
import time

import numpy as np
import torch

SEED = 11
DEGRADE_SEED = 0
GRANULE = 65_536
# the flags of the reference's bigcity.sh (the JAX repo's
# tools/bigcity_run.py): clm_offload, bsz 64, sparse Adam, densification
# off, no PLY saves, memory reports at each loss line
BIGCITY_ARGS = [
    "--clm_offload", "--eval", "--llffhold", "8", "--bsz", "64", "--sparse_adam",
    "--densify_until_iter", "0", "--save_iterations", "0",
    "--check_gpu_memory", "--check_cpu_memory",
]
INIT_PLY = "init_model.ply"
INFO = "bigcity.json"
# how often `run` samples the process's RSS
RSS_SAMPLE_S = 0.05
# the SH columns of the model PLY: f_dc_0..2, then f_rest_0..44
SH_LO, SH_HI = 6, 54


def lookat_camera(uid, pos, target, width, height, fov=0.8):
    """A camera at `pos` looking at `target`, y up (the JAX repo's
    tools/make_flagship_scene.py lookat_camera)."""
    from clm_gs_tpu_torch.data.cameras import Camera

    pos = np.asarray(pos, np.float64)
    forward = target - pos
    forward /= np.linalg.norm(forward)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, forward)
    nr = np.linalg.norm(right)
    if nr < 1e-6:  # looking straight down or up
        right = np.array([1.0, 0.0, 0.0])
    else:
        right /= nr
    up2 = np.cross(forward, right)
    R = np.stack([right, up2, forward], axis=1)
    T = -R.T @ pos
    return Camera(uid=uid, image_name=f"cam{uid}", width=width, height=height,
                  R=R, T=T, fovx=fov, fovy=fov * height / width)


def city_gaussians(n, rng, extent=50.0, chunk_rows=1 << 22):
    """Ground and building-shell Gaussians with trained-scene statistics:
    (xyz, log_scale, quat, opacity, sh), float32. The draws of `rng` are the
    JAX tool's, in its order; its (n, k) normal draws are taken
    `chunk_rows` rows at a time, which draws the same stream."""
    n_ground = int(n * 0.35)
    n_bld = n - n_ground

    def row_chunks(a, b):
        return ((i, min(i + chunk_rows, b)) for i in range(a, b, chunk_rows))

    gx = rng.uniform(-extent, extent, n_ground).astype(np.float32)
    gz = rng.uniform(-extent, extent, n_ground).astype(np.float32)
    xyz = np.empty((n, 3), np.float32)
    xyz[:n_ground] = np.stack([gx, np.zeros(n_ground, np.float32), gz], axis=1)
    del gx, gz

    n_boxes = 2500
    bc = np.stack(
        [rng.uniform(-extent * 0.95, extent * 0.95, n_boxes), np.zeros(n_boxes),
         rng.uniform(-extent * 0.95, extent * 0.95, n_boxes)], axis=1,
    ).astype(np.float32)
    bsz = np.stack(
        [rng.uniform(1.0, 4.0, n_boxes), rng.uniform(2.0, 12.0, n_boxes),
         rng.uniform(1.0, 4.0, n_boxes)], axis=1,
    ).astype(np.float32)
    which = rng.randint(0, n_boxes, n_bld)
    # points on box surfaces: a face (4 walls and the roof), uniform on it
    face = rng.randint(0, 5, n_bld)
    u = rng.uniform(-1, 1, n_bld).astype(np.float32)
    v = rng.uniform(0, 1, n_bld).astype(np.float32)
    s = bsz[which]
    local = np.zeros((n_bld, 3), np.float32)
    walls = face < 4
    sgn = np.where(face % 2 == 0, 1.0, -1.0).astype(np.float32)
    xw = face < 2  # faces 0, 1: the +-x walls; 2, 3: the +-z walls
    local[walls & xw, 0] = (sgn * s[:, 0])[walls & xw]
    local[walls & xw, 2] = (u * s[:, 2])[walls & xw]
    local[walls & ~xw, 2] = (sgn * s[:, 2])[walls & ~xw]
    local[walls & ~xw, 0] = (u * s[:, 0])[walls & ~xw]
    local[walls, 1] = (v * s[:, 1])[walls]
    roof = ~walls
    local[roof, 0] = (u * s[:, 0])[roof]
    local[roof, 2] = (rng.uniform(-1, 1, n_bld).astype(np.float32) * s[:, 2])[roof]
    local[roof, 1] = s[roof, 1]
    xyz[n_ground:] = bc[which] + local
    del face, u, v, s, local, walls, sgn, xw, roof

    # scales about the local spacing; opacity bimodal (surfaces and haze)
    spacing = extent * 2 / np.sqrt(n / 4.0)
    log_scale = np.empty((n, 3), np.float32)
    for i, j in row_chunks(0, n):
        log_scale[i:j] = np.log(spacing) + 0.4 * rng.normal(size=(j - i, 3))
    quat = np.empty((n, 4), np.float32)
    for i, j in row_chunks(0, n):
        q = rng.normal(size=(j - i, 4)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        quat[i:j] = q
    opaque = rng.rand(n) < 0.7
    opacity = np.where(opaque, rng.uniform(1.5, 5.0, n),
                       rng.uniform(-3.0, -0.5, n)).astype(np.float32)
    del opaque
    sh = np.zeros((n, 48), np.float32)
    # per-building base colours, the ground grey-green
    bld_col = rng.uniform(-0.8, 0.8, (n_boxes, 3)).astype(np.float32)
    for i, j in row_chunks(0, n_ground):
        sh[i:j, :3] = np.array([0.1, 0.2, 0.1]) + 0.1 * rng.normal(size=(j - i, 3))
    for i, j in row_chunks(n_ground, n):
        sh[i:j, :3] = (bld_col[which[i - n_ground:j - n_ground]]
                       + 0.05 * rng.normal(size=(j - i, 3)))
    for i, j in row_chunks(0, n):
        sh[i:j, 3:] = 0.02 * rng.normal(size=(j - i, 45)).astype(np.float32)
    return xyz, log_scale, quat, opacity, sh


def serpentine_cameras(n_cams, width, height, extent=50.0):
    """Street-level cameras on a serpentine over a side x side grid, each
    looking ahead and down at its neighbourhood."""
    side = int(np.ceil(np.sqrt(n_cams)))
    cams = []
    uid = 1
    step = 2 * extent * 0.8 / side
    for r in range(side):
        cols = range(side) if r % 2 == 0 else range(side - 1, -1, -1)
        for c in cols:
            if uid > n_cams:
                break
            x = -extent * 0.8 + (c + 0.5) * step
            z = -extent * 0.8 + (r + 0.5) * step
            pos = np.array([x, 10.0, z])
            tgt = np.array([x + step * 0.8, 0.0, z + step * 0.4])
            cams.append(lookat_camera(uid, pos, tgt, width, height))
            uid += 1
    return cams


def _ply_header(n: int) -> bytes:
    from clm_gs_tpu_torch.models.gaussians import PLY_PROPS

    return ("ply\nformat binary_little_endian 1.0\n"
            f"element vertex {n}\n"
            + "".join(f"property float {p}\n" for p in PLY_PROPS)
            + "end_header\n").encode("ascii")


def write_model_ply(path, xyz, log_scale, quat, opacity, sh, chunk_rows=1 << 20,
                    degrade=None, on_chunk=None):
    """The model PLY of the arrays, written `chunk_rows` rows at a time
    (byte-equal to the JAX tool's). `degrade`: (keep, noise, noise_rows)
    damps and noises the SH columns as `degrade_ply` does, noise_rows(m)
    giving the next m rows of its float32 normal draws. `on_chunk(i, sh)` is
    called with each chunk's written SH rows (f_rest back in (15, 3)
    order)."""
    n = len(xyz)
    with open(path, "wb") as f:
        f.write(_ply_header(n))
        for i in range(0, n, chunk_rows):
            j = min(i + chunk_rows, n)
            rest = sh[i:j, 3:].reshape(j - i, 15, 3).transpose(0, 2, 1).reshape(j - i, 45)
            cols = np.concatenate(
                [xyz[i:j], np.zeros((j - i, 3), np.float32), sh[i:j, 0:3], rest,
                 opacity[i:j, None], log_scale[i:j], quat[i:j]], axis=1,
            ).astype("<f4")
            if degrade is not None:
                keep, noise, noise_rows = degrade
                cols[:, SH_LO:SH_HI] = keep * cols[:, SH_LO:SH_HI] + noise * noise_rows(j - i)
            if on_chunk is not None:
                m = j - i
                out = np.empty((m, 48), np.float32)
                out[:, :3] = cols[:, SH_LO:SH_LO + 3]
                out[:, 3:] = cols[:, SH_LO + 3:SH_HI].reshape(m, 3, 15).transpose(
                    0, 2, 1).reshape(m, 45)
                on_chunk(i, out)
            f.write(cols.tobytes())


class NoiseRows:
    """The float32 normal draws of `degrade_ply`, (m, 48) rows at a time in
    the order it takes them, drawn ahead on a thread (numpy's generator
    releases the interpreter lock), so that they come while the city is
    drawn."""

    def __init__(self, n: int, seed: int = DEGRADE_SEED, chunk_rows: int = 1 << 20):
        self.rows = np.empty((n, 48), np.float32)
        self.done = 0
        self.taken = 0
        self.cond = threading.Condition()
        self.thread = threading.Thread(target=self._draw, args=(n, seed, chunk_rows),
                                       daemon=True)
        self.thread.start()

    def _draw(self, n, seed, chunk_rows):
        rng = np.random.RandomState(seed)
        for i in range(0, n, chunk_rows):
            j = min(i + chunk_rows, n)
            self.rows[i:j] = rng.normal(size=(j - i, 48)).astype(np.float32)
            with self.cond:
                self.done = j
                self.cond.notify_all()

    def __call__(self, m: int) -> np.ndarray:
        i, j = self.taken, self.taken + m
        with self.cond:
            self.cond.wait_for(lambda: self.done >= j)
        self.taken = j
        return self.rows[i:j]


def degrade_ply(src, dst, keep=0.3, noise=0.15, chunk_rows=4_000_000):
    """Damp and noise a model PLY's SH columns, keeping its geometry: each
    row's f_dc/f_rest becomes keep * value + noise * N(0, 1) from
    RandomState(0), drawn (m, 48) per chunk of m rows (byte-equal to the
    JAX repo's tools/degrade_ply.py). Streams: the host holds one chunk."""
    with open(src, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            line = f.readline()
            if not line:
                raise ValueError(f"{src}: no end_header")
            header += line
        lines = header.decode("ascii").splitlines()
        n = next(int(ln.split()[-1]) for ln in lines if ln.startswith("element vertex"))
        props = [ln.split()[-1] for ln in lines if ln.startswith("property float")]
        ncol = len(props)
        sh_cols = [i for i, p in enumerate(props)
                   if p.startswith("f_dc_") or p.startswith("f_rest_")]
        lo, hi = min(sh_cols), max(sh_cols) + 1
        if sh_cols != list(range(lo, hi)):
            raise ValueError(f"{src}: the SH columns are not contiguous")
        rng = np.random.RandomState(DEGRADE_SEED)
        with open(dst, "wb") as out:
            out.write(header)
            for done in range(0, n, chunk_rows):
                m = min(chunk_rows, n - done)
                buf = np.frombuffer(f.read(m * ncol * 4), dtype="<f4").reshape(m, ncol).copy()
                buf[:, lo:hi] = keep * buf[:, lo:hi] + noise * rng.normal(
                    size=(m, hi - lo)).astype(np.float32)
                out.write(buf.tobytes())
    return n


def capacity_for(n: int) -> int:
    """n rounded up to the capacity granule: the run's --prealloc_capacity."""
    return -(-n // GRANULE) * GRANULE


@torch.no_grad()
def _render(params, cb, i, width, height, background):
    """Camera i of `cb` rendered from its visible rows, as clm_offload's
    eval renders: (image (3, H, W), n_isects)."""
    from clm_gs_tpu_torch.strategies import offload_common as oc

    F = oc.calculate_filters(params.xyz, params.quat, params.log_scale, None,
                             cb.viewmats[i:i + 1], cb.Ks[i:i + 1], width, height, 0.0)
    ids = F.ids[0]
    return oc.eval_visible(params, ids, params.sh[ids.long()], cb.viewmats[i], cb.Ks[i],
                           cb.camera_centers[i], 3, background, width, height)


def make(root, n, n_cams=64, width=640, height=400, degrade=(0.3, 0.15), device="cuda"):
    """Write the scene under `root` (module docstring); returns the dict
    written to bigcity.json. BIGCITY_SKIP_RENDER=1 writes the PLY alone."""
    from PIL import Image

    from clm_gs_tpu_torch import _build
    from clm_gs_tpu_torch.data import colmap
    from clm_gs_tpu_torch.data.cameras import stack_cameras
    from clm_gs_tpu_torch.data.readers import read_colmap_scene
    from clm_gs_tpu_torch.models.gaussians import GaussianParams
    from clm_gs_tpu_torch.utils.general import check_device, psnr

    device = check_device(device)
    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    times = {}
    noise = NoiseRows(n) if degrade is not None else None
    rng = np.random.RandomState(SEED)
    xyz, log_scale, quat, opacity, sh = city_gaussians(n, rng)
    times["gaussians_s"] = time.perf_counter() - t0
    info = {"n": n, "capacity": capacity_for(n), "cams": n_cams, "width": width,
            "height": height, "degrade": list(degrade) if degrade else None}
    ply = os.path.join(root, INIT_PLY)
    if os.environ.get("BIGCITY_SKIP_RENDER") == "1":
        write_model_ply(ply, xyz, log_scale, quat, opacity, sh,
                        degrade=None if degrade is None else (*degrade, noise))
        times["ply_s"] = time.perf_counter() - t0 - times["gaussians_s"]
        return info | times

    # the ground truth, rendered on the card from the true model
    _build.reset_launches()
    t1 = time.perf_counter()
    params = GaussianParams(*(torch.from_numpy(a).to(device)
                              for a in (xyz, opacity, log_scale, quat, sh)))
    cams = serpentine_cameras(n_cams, width, height)
    cb = stack_cameras(cams, device=device)
    bg = torch.zeros(3, device=device)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    names = [f"img_{i:03d}.png" for i in range(n_cams)]
    gts, isects = [], []
    for i, name in enumerate(names):
        image, n_isects = _render(params, cb, i, width, height, bg)
        gt = (torch.clamp(image, 0, 1) * 255).to(torch.uint8)
        gts.append(gt.cpu())
        isects.append(int(n_isects))
        Image.fromarray(gts[-1].numpy().transpose(1, 2, 0)).save(
            os.path.join(img_dir, name), compress_level=1)
    times["render_s"] = time.perf_counter() - t1
    info["gt_launches"] = dict(_build.LAUNCHES)
    info["gt_isects"] = [min(isects), max(isects)]

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
    # a small points3D for the COLMAP reader (training starts from the PLY)
    k = min(n, 10_000)
    sel = rng.choice(n, size=k, replace=False)
    colmap.write_points3d_binary(os.path.join(sparse, "points3D.bin"),
                                 xyz[sel].astype(np.float64), np.full((k, 3), 128, np.uint8))

    # the init PLY; the model on the card takes its SH rows, for the
    # init's test PSNR
    t1 = time.perf_counter()

    def take(i, rows):
        params.sh[i:i + len(rows)].copy_(torch.from_numpy(rows))

    write_model_ply(ply, xyz, log_scale, quat, opacity, sh,
                    degrade=None if degrade is None else (*degrade, noise), on_chunk=take)
    times["ply_s"] = time.perf_counter() - t1
    del xyz, log_scale, quat, opacity, sh
    test = read_colmap_scene(root, eval_split=True, llffhold=8).test_cameras
    psnrs = []
    for cam in test:
        i = names.index(cam.image_name + ".png")
        image, _ = _render(params, cb, i, width, height, bg)
        gt = gts[i].to(device).float() / 255.0
        psnrs.append(float(psnr(torch.clamp(image, 0, 1), gt)))
    info["init_test_psnr"] = float(np.mean(psnrs))
    info["test_cameras"] = len(test)
    times["total_s"] = time.perf_counter() - t0
    info |= times
    with open(os.path.join(root, INFO), "w") as f:
        json.dump(info, f, indent=1)
    return info


def train_args(root, out, iters: int, n: int, strategy: str = "clm_offload"):
    """The training command of the scene at `root` (n Gaussians) for
    `iters` iterations: BIGCITY_ARGS with `strategy`, the init PLY, the
    capacity `capacity_for(n)`, test evals at every 512 iterations and at
    the end, a loss line a batch."""
    args = [f"--{strategy}" if a == "--clm_offload" else a for a in BIGCITY_ARGS]
    bsz = args[args.index("--bsz") + 1]
    evals = [str(i) for i in range(512, iters + 1, 512)] + [str(iters)]
    return (["-s", root, "-m", out] + args
            + ["--iterations", str(iters), "--load_ply_path", os.path.join(root, INIT_PLY),
               "--prealloc_capacity", str(capacity_for(n)),
               "--test_iterations", *evals,
               "--log_interval", bsz])


def run(root, out, iters: int, strategy: str = "clm_offload", extra=(),
        device_loop: bool = False, device="cuda", pinned_ab: bool = False):
    """Train the scene at `root` (`train_args`, then `extra` flags, which
    override) into `out`. Returns what `collect` reads from the log, and the
    kernels' launches, the peak device bytes (the whole run's) and
    `peak_by_stage` (`general.STAGES`: set-up, the loop, each clm stage,
    eval, the run's end), the process's RSS before the
    run, its peak sampled every RSS_SAMPLE_S within the set-up (the load)
    and over the run, and its peak as the kernel keeps it, and the PLY
    saves' seconds and the RSS sampled within them; with `device_loop`,
    also `device_loop_split` of the final state (with its `pinned_ab`)."""
    from clm_gs_tpu_torch import _build
    from clm_gs_tpu_torch.models import gaussians as G
    from clm_gs_tpu_torch.train import main as train_main
    from clm_gs_tpu_torch.utils.general import (STAGES, check_device, device_peak_bytes,
                                                peak_rss_bytes, rss_bytes)

    device = check_device(device)
    n, _ = G._model_ply_header(os.path.join(root, INIT_PLY))
    argv = train_args(root, out, iters, n, strategy) + list(extra)
    if device.type == "cuda":
        torch.empty(1, device=device)  # the card's context, before the run
        torch.cuda.reset_peak_memory_stats()
    # the process's RSS before the run, then sampled through it: the load's
    # host peak is the sampled peak within the run's set-up
    rss_before = rss_bytes()
    samples = []
    done = threading.Event()

    def sample():
        while not done.wait(RSS_SAMPLE_S):
            samples.append((time.perf_counter(), rss_bytes()))

    sampler = threading.Thread(target=sample, daemon=True)
    saves = []  # (start, end) of each PLY save of the run
    save_ply = G.save_ply

    def timed_save(*args, **kwargs):
        t = time.perf_counter()
        try:
            return save_ply(*args, **kwargs)
        finally:
            saves.append((t, time.perf_counter()))

    _build.reset_launches()
    t0 = time.perf_counter()
    sampler.start()
    if device.type == "cuda":
        STAGES.start("setup")
    G.save_ply = timed_save
    try:
        state, _ = train_main(argv, device=device)
    finally:
        G.save_ply = save_ply
        peak_by_stage = STAGES.stop()
        done.set()
        sampler.join()
    rec = collect(out)
    # the set-up as the log times it, from a little after t0, and half a
    # second more: its last buffers, and no batch's host work yet
    setup_end = t0 + (rec["setup_s"] or 0.0) + 0.5
    result = {"strategy": strategy, "argv": argv, "run_s": time.perf_counter() - t0,
              "launches": dict(_build.LAUNCHES),
              "peak_device_bytes": (device_peak_bytes() if device.type == "cuda"
                                    else None),
              "peak_by_stage": peak_by_stage,
              "rss_before_bytes": rss_before,
              "setup_rss_bytes": max([r for t, r in samples if t <= setup_end],
                                     default=rss_before),
              "sampled_peak_rss_bytes": max([r for _, r in samples], default=rss_before),
              "peak_rss_bytes": peak_rss_bytes(),
              # the PLY saves: their seconds, the last RSS sampled before the
              # first and the peak sampled within them
              "save_s": sum(b - a for a, b in saves),
              "pre_save_rss_bytes": (([rss_before] + [r for t, r in samples
                                                      if t < saves[0][0]])[-1]
                                     if saves else None),
              "save_rss_bytes": max([r for t, r in samples
                                     if any(a <= t <= b for a, b in saves)], default=None),
              **rec}
    if device_loop:
        holder = [state]
        del state
        gc.collect()  # the run's context, before a new one takes its place
        result["device_loop"] = device_loop_split(root, holder, argv, device,
                                                  pinned_ab=pinned_ab)
    return result


def _batch(root, bsz: int, llffhold: int, device):
    """The first `bsz` training cameras of the scene (wrapping around, as a
    batch across an epoch boundary does) and their ground truth."""
    from PIL import Image

    from clm_gs_tpu_torch.data.cameras import stack_cameras
    from clm_gs_tpu_torch.data.readers import read_colmap_scene

    train = read_colmap_scene(root, eval_split=True, llffhold=llffhold).train_cameras
    cams = [train[i % len(train)] for i in range(bsz)]
    gt = np.stack([np.asarray(Image.open(os.path.join(root, "images",
                                                      c.image_name + ".png")))
                   for c in cams])
    gt = torch.from_numpy(gt).to(device).permute(0, 3, 1, 2).float() / 255.0
    return stack_cameras(cams, device=device), gt, [c.image_name for c in cams]


def device_loop_split(root, holder, argv, device, reps: int = 3, pinned_ab: bool = False):
    """The card's share of one batch of the final state: one batch of bsz
    training cameras run in situ by `clm_offload.train_one_batch` with
    --stop_update_param (its last camera's loss is the reference), then
    `prepare_device_loop`'s replay of the same batch timed (`reps` runs
    after one warm-up), then the in-situ batch with updates timed with the
    clm spans; with `pinned_ab`, then `_pinned_ab` from where that batch
    left the state. `holder` is a list holding the state `train.main`
    returns (its SH field the run's host buffer, which a new context takes
    over), popped so that the caller keeps no reference to the state."""
    from clm_gs_tpu_torch.config import parse_config
    from clm_gs_tpu_torch.optim import AdamConfig, init_adam, sh_column_lr
    from clm_gs_tpu_torch.strategies import clm_offload as clm
    from clm_gs_tpu_torch.utils.timer import Timer

    cfg = parse_config(argv)
    bsz = cfg.opt.bsz
    cb, gt, names = _batch(root, bsz, cfg.aux.llffhold, device)
    adam_cfg = AdamConfig().scaled(bsz, cfg.opt.lr_scale_mode)
    state = holder.pop()
    ctx = clm.make_context_from_host(cfg, state.params.sh, adam_cfg, device)
    state = clm.strip_device_sh(state)
    opt = init_adam(state.params)
    W, H = cb.width, cb.height
    bg = torch.zeros(3, device=device)
    # the card groups' rates without the run's schedule and scene extent:
    # they change no work of the batch
    lrs = {k: torch.tensor(v, device=device) for k, v in (
        ("xyz", cfg.opt.position_lr_final), ("opacity", cfg.opt.opacity_lr),
        ("log_scale", cfg.opt.scaling_lr), ("quat", cfg.opt.rotation_lr))}
    lrs["sh"] = sh_column_lr(cfg.opt.feature_lr, device="cpu")
    # the degree the run's last batch used
    sh_degree = min((cfg.opt.iterations - 1) // 1000, cfg.model.sh_degree)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    def frozen_batch():
        cfg.debug.stop_update_param = True
        try:
            return clm.train_one_batch(state, opt, ctx, cb, gt, sh_degree, lrs, adam_cfg,
                                       bg, W, H, cfg)[3]
        finally:
            cfg.debug.stop_update_param = False

    try:
        out = frozen_batch()
        t0 = time.perf_counter()
        out = frozen_batch()
        sync()
        frozen_s = time.perf_counter() - t0
        in_situ = float(out.losses[-1])
        t0 = time.perf_counter()
        run_fn, n_groups = clm.prepare_device_loop(state, ctx, cb, gt, sh_degree, bg, W, H,
                                                   cfg)
        sync()
        prepare_s = time.perf_counter() - t0
        run_fn()
        sync()
        replay = []
        losses = []
        for _ in range(reps):
            t0 = time.perf_counter()
            loss = run_fn()[0]
            sync()
            replay.append(time.perf_counter() - t0)
            losses.append(float(loss))
        del run_fn  # the staged batch
        # one warm batch with updates, then one timed with the clm spans
        t0 = time.perf_counter()
        state, opt, ctx, _ = clm.train_one_batch(state, opt, ctx, cb, gt, sh_degree, lrs,
                                                 adam_cfg, bg, W, H, cfg)
        sync()
        warm_s = time.perf_counter() - t0
        timers = Timer(enabled=True)
        h2d0, d2h0, trail0 = ctx.h2d_bytes, ctx.d2h_bytes, ctx.trailing_s
        t0 = time.perf_counter()
        state, opt, ctx, _ = clm.train_one_batch(state, opt, ctx, cb, gt, sh_degree, lrs,
                                                 adam_cfg, bg, W, H, cfg, timers=timers)
        sync()
        batch_s = time.perf_counter() - t0
        moved = [ctx.h2d_bytes - h2d0, ctx.d2h_bytes - d2h0, ctx.trailing_s - trail0]
        spans = {k: v[0] for k, v in _timer_sums(timers).items()}
        ab = None
        if pinned_ab:
            ab = _pinned_ab(state, opt, ctx, lambda s, o, c, tm: clm.train_one_batch(
                s, o, c, cb, gt, sh_degree, lrs, adam_cfg, bg, W, H, cfg, timers=tm), sync)
    finally:
        ctx.close()
    replay_s = float(np.median(replay))
    return {
        "cameras": names, "n_launch_groups": n_groups, "prepare_s": prepare_s,
        "replay_s": replay, "replay_median_s": replay_s,
        "frozen_batch_s": frozen_s, "warm_batch_s": warm_s, "batch_s": batch_s,
        "card_share_of_batch": replay_s / batch_s,
        "replay_losses": losses, "in_situ_last_loss": in_situ,
        "replay_equal_to_in_situ": all(v == in_situ for v in losses),
        "replay_rel_err": max(abs(v - in_situ) for v in losses) / max(abs(in_situ), 1e-30),
        "batch_spans_ms": spans, "batch_h2d_bytes": moved[0], "batch_d2h_bytes": moved[1],
        "batch_trailing_s": moved[2],
        "unique_cameras": len(set(names)),
        "pinned_ab": ab,
    }


def _clone(obj):
    """A copy of a state or optimizer state, every tensor cloned."""
    import dataclasses

    if torch.is_tensor(obj):
        return obj.clone()
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: _clone(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj)})
    return obj


def _digest(t: torch.Tensor) -> str:
    """blake2b of a contiguous CPU tensor's bytes, its 256 MiB blocks hashed
    on 8 threads and the blocks' digests hashed again."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    buf = memoryview(t.contiguous().numpy()).cast("B")
    step = 1 << 28
    with ThreadPoolExecutor(8) as ex:
        parts = ex.map(lambda i: hashlib.blake2b(buf[i:i + step]).digest(),
                       range(0, len(buf), step))
        return hashlib.blake2b(b"".join(parts)).hexdigest()


def _pinned_ab(state, opt, ctx, batch, sync) -> dict:
    """One batch on the host path (ctx.card_gather off: the host gather and
    upload, the download and host scatter) and one with --pinned_host's
    card-side gather and scatter, each from the same start: a clone of the
    card state and moments, the host SH rows and both moments restored, the
    gradient rows zero (`grad_zero`: the batch before consumed every row
    that the frozen batches left, as it saw the same cameras; the pinned
    run's scatter then stores each row's first departure).
    `batch(state, opt, ctx, timers)` runs one. Returns each run's seconds,
    clm spans, bytes each way, trailing seconds, kernel launches and the
    rows the card's scatter wrote and of them stored, and
    whether the pinned run equals the host run to the bit: losses, the card
    groups, both card moments and the statistics (torch.equal), and the
    host SH rows and both moments (`_digest`)."""
    from clm_gs_tpu_torch import _build
    from clm_gs_tpu_torch.utils.timer import Timer

    host_bufs = lambda: (ctx.sh_host, ctx.adam.exp_avg, ctx.adam.exp_avg_sq)
    start = [t.clone() for t in host_bufs()]
    step0, card0 = ctx.adam.step_count, ctx.card_gather
    runs, outs = {}, {}
    try:
        for name, card in (("host", False), ("pinned", True)):
            if card:  # the host run started from `start` itself
                for buf, t in zip(host_bufs(), start):
                    buf.copy_(t)
            ctx.adam.step_count = step0
            ctx.card_gather = card
            ctx.sh_grad_host.zero_()
            ctx.grad_zero = True
            s, o = _clone(state), _clone(opt)
            timers = Timer(enabled=True)
            h2d0, d2h0, trail0 = ctx.h2d_bytes, ctx.d2h_bytes, ctx.trailing_s
            rows0, stored0 = ctx.scatter_rows, ctx.stored_rows
            sync()
            _build.reset_launches()
            t0 = time.perf_counter()
            s, o, ctx, out = batch(s, o, ctx, timers)
            sync()
            runs[name] = {
                "batch_s": time.perf_counter() - t0,
                "spans_ms": {k: v[0] for k, v in _timer_sums(timers).items()},
                "h2d_bytes": ctx.h2d_bytes - h2d0, "d2h_bytes": ctx.d2h_bytes - d2h0,
                "trailing_s": ctx.trailing_s - trail0, "launches": dict(_build.LAUNCHES),
                "scatter_rows": ctx.scatter_rows - rows0,
                "stored_rows": ctx.stored_rows - stored0}
            outs[name] = (out.losses, s, o, [_digest(t) for t in host_bufs()])
    finally:
        ctx.card_gather = card0
    (lh, sh_, oh, dh), (lp, sp, op, dp) = outs["host"], outs["pinned"]
    equal = {"losses": torch.equal(lh, lp),
             "host_sh_and_moments": dh == dp,
             "statistics": torch.equal(sh_.xyz_grad_accum, sp.xyz_grad_accum)
             and torch.equal(sh_.denom, sp.denom)}
    for f in ("xyz", "opacity", "log_scale", "quat"):
        equal[f] = all(torch.equal(getattr(a, f), getattr(b, f))
                       for a, b in ((sh_.params, sp.params), (oh.mu, op.mu), (oh.nu, op.nu)))
    return {"runs": runs, "equal": equal}


def _timer_sums(timers):
    """{span: (sum ms, calls)} of a Timer's report."""
    out = {}
    for ln in timers.report().splitlines():
        if " ms over " in ln and ": sum " in ln:
            key, rest = ln.split(": sum ")
            ms, calls = rest.split(" ms over ")
            out[key.strip()] = (float(ms), int(calls.split()[0]))
    return out


def collect(run_dir) -> dict:
    """A run's record from its python.log: the losses, the clm overlap
    meter, host and device memory, the evals, end2end, the Gaussians and
    capacity, the clm host state and the spans (the JAX repo's
    tools/collect_bigcity.py, with the port's memory lines)."""
    with open(os.path.join(run_dir, "python.log")) as f:
        log = f.read()
    overlap = re.findall(r"clm overlap: host work ([\d.]+) ms/batch, trailing ([\d.]+) "
                         r"ms/batch, comm-hidden (\d+)%", log)
    transfer = re.findall(r"clm transfer: up (\d+) B/batch, down (\d+) B/batch"
                          r"(?:, scatter stored (\d+) of (\d+) rows)?", log)
    evals = re.findall(r"\[ITER (\d+)\] Evaluating (test|train): L1 ([\d.e-]+) "
                       r"PSNR ([\d.e-]+)", log)
    e2e = re.findall(r"end2end total_time: ([\d.]+) s, iterations: (\d+), "
                     r"throughput ([\d.]+) it/s", log)
    iters = re.findall(r"iteration\[(\d+),(\d+)\) loss: ([\d.naif]+)", log)
    rss = re.findall(r"host peak rss ([\d.]+) GB", log)
    dev_peak = re.findall(r"device peak ([\d.]+) GB", log)
    init = re.findall(r"Initialized (\d+) gaussians \(capacity (\d+)\)", log)
    setup_s = re.findall(r"setup time: ([\d.]+) s", log)
    setup = re.findall(r"memory after setup: (.*)", log)
    host_state = re.findall(r"clm host state: (\d+) bytes", log)
    spans = re.findall(r"^(\S+): sum ([\d.]+) ms over (\d+) calls", log, re.M)
    setup_rss = re.findall(r"host peak rss ([\d.]+) GB", setup[0]) if setup else []
    return {
        "n_gaussians": int(init[-1][0]) if init else None,
        "capacity": int(init[-1][1]) if init else None,
        "setup_s": float(setup_s[-1]) if setup_s else None,
        "losses": [{"iter": int(a), "loss": float(v)} for a, _, v in iters],
        "overlap_last": ({"host_work_ms_per_batch": float(overlap[-1][0]),
                          "trailing_ms_per_batch": float(overlap[-1][1]),
                          "comm_hidden_pct": int(overlap[-1][2])} if overlap else None),
        # the run's bytes each way a batch, and the rows the card's scatter
        # wrote and stored (--pinned_host), over its batches so far
        "transfer_last": ({"h2d_bytes_per_batch": int(transfer[-1][0]),
                           "d2h_bytes_per_batch": int(transfer[-1][1]),
                           "scatter_stored_rows": int(transfer[-1][2] or 0),
                           "scatter_rows": int(transfer[-1][3] or 0)} if transfer else None),
        "host_peak_gb": float(rss[-1]) if rss else None,
        "setup_host_peak_gb": float(setup_rss[0]) if setup_rss else None,
        "device_peak_gb_max": max((float(x) for x in dev_peak), default=None),
        "clm_host_state_bytes": int(host_state[-1]) if host_state else None,
        "final_eval": [{"iter": int(i), "split": s, "psnr": float(p)}
                       for i, s, _, p in evals],
        "end2end": ({"total_s": float(e2e[-1][0]), "iterations": int(e2e[-1][1]),
                     "it_per_s": float(e2e[-1][2])} if e2e else None),
        "spans_ms": {k: [float(ms), int(c)] for k, ms, c in spans},
    }


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    mk = sub.add_parser("make", help="write the scene")
    mk.add_argument("root")
    mk.add_argument("--n", type=int, required=True)
    mk.add_argument("--cams", type=int, default=64)
    mk.add_argument("--width", type=int, default=640)
    mk.add_argument("--height", type=int, default=400)
    mk.add_argument("--degrade", default="0.3,0.15",
                    help="keep,noise of the init's SH, or 'none' for the true model")
    rn = sub.add_parser("run", help="train the scene")
    rn.add_argument("root")
    rn.add_argument("out")
    rn.add_argument("--iters", type=int, required=True)
    which = rn.add_mutually_exclusive_group()
    which.add_argument("--no_offload", action="store_true")
    which.add_argument("--naive_offload", action="store_true")
    rn.add_argument("--device_loop", action="store_true",
                    help="then time one batch in situ against its device-loop replay")
    rn.add_argument("--pinned_ab", action="store_true",
                    help="with --device_loop: then one batch on the host path against "
                         "one with --pinned_host, from one start")
    co = sub.add_parser("collect", help="read a run's python.log")
    co.add_argument("out")
    argv = list(sys.argv[1:] if argv is None else argv)
    extra = []  # run: the training flags after --, which override
    if "--" in argv:
        argv, extra = argv[:argv.index("--")], argv[argv.index("--") + 1:]
    args = ap.parse_args(argv)
    if args.cmd == "make":
        degrade = (None if args.degrade == "none"
                   else tuple(float(v) for v in args.degrade.split(",")))
        res = make(args.root, args.n, args.cams, args.width, args.height, degrade, device)
    elif args.cmd == "run":
        strategy = ("no_offload" if args.no_offload else
                    "naive_offload" if args.naive_offload else "clm_offload")
        res = run(args.root, args.out, args.iters, strategy, extra, args.device_loop,
                  device, args.pinned_ab)
    else:
        res = collect(args.out)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
