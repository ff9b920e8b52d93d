"""Scene set-up (clm_gs_tpu/scene.py).

Reads the scene (COLMAP, MatrixCity or Blender, detected from the source
directory), writes `cameras.json`, shuffles and truncates the camera lists,
pre-decodes every image to the raw disk cache, and initialises the Gaussian
state on the training device from the point cloud, a model PLY or a tensor
file. `cameras_extent` (the nerf++ radius) scales the position LR and the
densification thresholds. Under clm_offload the SH rows load straight into
a host buffer, `host_sh`, which the strategy's context takes over; the
state on the card holds the (1, 48) placeholder.
"""

from __future__ import annotations

import json
import os
import random
from typing import List, Optional

from clm_gs_tpu_torch.config import Config
from clm_gs_tpu_torch.data import dataset as D
from clm_gs_tpu_torch.data import readers
from clm_gs_tpu_torch.data.cameras import Camera, fov2focal
from clm_gs_tpu_torch.models import gaussians as G


class Scene:
    def __init__(self, cfg: Config, logger=None, device="cuda", writer: bool = True):
        """`writer`: this process writes the run's files (`cameras.json`);
        the other ranks of a process group do not."""
        self.cfg = cfg
        src = cfg.model.source_path
        log = logger.write if logger else print

        scene_type = readers.detect_scene_type(src)
        if scene_type == "city":
            info = readers.read_city_scene(
                src, ply_path=cfg.aux.load_ply_path or _find_city_ply(src),
                ocean_mask=cfg.aux.matrixcity_ocean_mask,
            )
        elif scene_type == "blender":
            info = readers.read_blender_scene(
                src, white_background=cfg.model.white_background)
        else:
            info = readers.read_colmap_scene(
                src, images_dir=cfg.model.images, eval_split=cfg.model.eval,
                llffhold=cfg.aux.llffhold, dense_ply_file=cfg.aux.dense_ply_file,
            )
        self.info = info
        self.cameras_extent = info.nerf_normalization["radius"]

        # viewer camera dump: test cameras first, then train
        if cfg.model.model_path and writer:
            os.makedirs(cfg.model.model_path, exist_ok=True)
            with open(os.path.join(cfg.model.model_path, "cameras.json"), "w") as f:
                json.dump([camera_json(i, c) for i, c in enumerate(
                    list(info.test_cameras) + list(info.train_cameras))], f)

        train = list(info.train_cameras)
        random.Random(cfg.debug.seed).shuffle(train)
        if cfg.opt.num_train_cameras > 0:
            train = train[: cfg.opt.num_train_cameras]
        test = list(info.test_cameras)
        if cfg.opt.num_test_cameras > 0:
            test = test[: cfg.opt.num_test_cameras]
        self.train_cameras: List[Camera] = train
        self.test_cameras: List[Camera] = test

        all_cams = train + test
        log(f"Pre-decoding {len(all_cams)} images to {cfg.aux.decode_dataset_path}\n")
        self.width, self.height = D.predecode_dataset_to_disk(
            all_cams, cfg.aux.decode_dataset_path,
            num_workers=None if cfg.aux.multiprocesses_decode_dataset_to_disk else 1,
            white_background=cfg.model.white_background,
        )
        log(f"Image size: {self.width}x{self.height}\n")

        # --prealloc_capacity applies to every init path
        cap = cfg.aux.prealloc_capacity if cfg.aux.prealloc_capacity > 0 else None
        host_sh = cfg.aux.clm_offload
        if cfg.aux.load_pt_path:
            loaded = G.load_tensors(cfg.aux.load_pt_path, capacity=cap,
                                    device=device, host_sh=host_sh)
        elif cfg.aux.load_ply_path.endswith(".ply") and _is_model_ply(
                cfg.aux.load_ply_path):
            loaded = G.load_ply(cfg.aux.load_ply_path, capacity=cap,
                                device=device, host_sh=host_sh)
        else:
            pcd = info.point_cloud
            if pcd is None:
                raise ValueError(f"{src}: no initial point cloud found")
            ratio = cfg.aux.initial_point_cloud_downsampled_ratio
            if cfg.debug.drop_initial_3dgs_p > 0:
                ratio = min(ratio, 1.0 - cfg.debug.drop_initial_3dgs_p)
            loaded = G.create_from_pcd(
                pcd.points, pcd.colors, capacity=cap, downsample_ratio=ratio,
                seed=cfg.debug.seed, device=device, host_sh=host_sh,
            )
        self.gaussians, self.host_sh = loaded if host_sh else (loaded, None)
        log(f"Initialized {self.gaussians.n_alive} gaussians "
            f"(capacity {self.gaussians.capacity})\n")

    def train_dataset(self, bsz: int, skip_load: bool = False) -> D.SceneDataset:
        return D.SceneDataset(
            self.train_cameras, self.cfg.aux.decode_dataset_path,
            self.width, self.height, bsz, seed=self.cfg.debug.seed,
            workers=max(1, self.cfg.aux.num_workers), skip_load=skip_load,
        )

    def save(self, iteration: int, logger=None):
        """PLY export, one file at any size: `save_ply` streams blocks of
        rows, so the host holds one block, not the table (the reference
        splits the file by its available host memory instead)."""
        out_dir = os.path.join(self.cfg.model.model_path, "point_cloud",
                               f"iteration_{iteration}")
        os.makedirs(out_dir, exist_ok=True)
        G.save_ply(self.gaussians, os.path.join(out_dir, "point_cloud.ply"))
        if self.cfg.debug.save_tensors:
            G.save_tensors(self.gaussians, os.path.join(out_dir, "tensors.npz"))


def camera_json(idx: int, cam: Camera) -> dict:
    """Viewer camera record: cam-to-world position and rotation, pixel focal
    lengths."""
    return {
        "id": idx,
        "img_name": cam.image_name,
        "width": int(cam.width),
        "height": int(cam.height),
        "position": cam.camera_center.astype(float).tolist(),
        "rotation": [r.tolist() for r in cam.R.astype(float)],
        "fy": fov2focal(cam.fovy, cam.height),
        "fx": fov2focal(cam.fovx, cam.width),
    }


def _find_city_ply(src: str) -> Optional[str]:
    for cand in ("point_cloud.ply", "points3d.ply", "pcd.ply"):
        p = os.path.join(src, cand)
        if os.path.exists(p):
            return p
    return None


def _is_model_ply(path: str) -> bool:
    """A Gaussian model PLY (59-property schema), not a plain point cloud."""
    try:
        with open(path, "rb") as f:
            header = f.read(4096).decode("ascii", errors="replace")
    except OSError:
        return False
    return "f_rest_44" in header
