"""Scene readers: COLMAP, MatrixCity ("City") and Blender synthetic
(clm_gs_tpu/data/readers.py; the port's own copy).

Each produces a SceneInfo of the port's Camera objects and an initial point
cloud, with the reference's semantics:

  - COLMAP (readColmapSceneInfo :192-252): images sorted by name; eval split is
    idx % llffhold == 0 -> test; R = qvec2rotmat(q).T, T = tvec; FoV from
    PINHOLE/SIMPLE_PINHOLE intrinsics; points from points3D.bin (or .ply).
  - City (readCamerasFromTransformsCity :255-389 + readCityInfo :496-554):
    transforms.json per split with camera-to-world `transform_matrix` in
    OpenGL/Blender axes (flipped to COLMAP via c2w[:, 1:3] *= -1), fov from
    camera_angle_x or per-frame fl_x/fl_y, optional ocean-mask frame filter
    (`<name>_ocean_info.json` with per-frame is_ocean), init points from a PLY.
  - Blender (readNerfSyntheticInfo :451-493): transforms_{train,test}.json,
    white background option, random init points when no PLY.
  - getNerfppNorm (:59-80): scene extent = 1.1 * max distance of camera
    centers from their centroid.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from clm_gs_tpu_torch.data import colmap
from clm_gs_tpu_torch.data.cameras import Camera, focal2fov, fov2focal


@dataclass
class PointCloud:
    points: np.ndarray  # (N, 3) f32
    colors: np.ndarray  # (N, 3) f32 in [0, 1]


@dataclass
class SceneInfo:
    train_cameras: List[Camera]
    test_cameras: List[Camera]
    point_cloud: Optional[PointCloud]
    nerf_normalization: dict  # {"translate": (3,), "radius": float}
    ply_path: Optional[str] = None


def get_nerfpp_norm(cameras: List[Camera]) -> dict:
    centers = np.stack([c.camera_center for c in cameras])
    avg = centers.mean(axis=0)
    dist = np.linalg.norm(centers - avg, axis=1)
    radius = float(dist.max()) * 1.1
    return {"translate": -avg, "radius": radius}


def _load_ply_points(path) -> PointCloud:
    from clm_gs_tpu_torch.utils import plyio

    verts = plyio.read_ply_vertices(path)
    pts = np.stack([verts["x"], verts["y"], verts["z"]], axis=1).astype(np.float32)
    if "red" in verts:
        cols = (
            np.stack([verts["red"], verts["green"], verts["blue"]], axis=1) / 255.0
        ).astype(np.float32)
    else:
        cols = np.full_like(pts, 0.5)
    return PointCloud(pts, cols)


def read_colmap_scene(
    path: str, images_dir: str = "images", eval_split: bool = False, llffhold: int = 8,
    dense_ply_file: str = "",
) -> SceneInfo:
    sparse = os.path.join(path, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(path, "sparse")
    try:
        cams = colmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
        imgs = colmap.read_images_binary(os.path.join(sparse, "images.bin"))
    except FileNotFoundError:
        cams = colmap.read_cameras_text(os.path.join(sparse, "cameras.txt"))
        imgs = colmap.read_images_text(os.path.join(sparse, "images.txt"))

    cam_infos = []
    for img in sorted(imgs.values(), key=lambda im: im.name):
        intr = cams[img.camera_id]
        if intr.model == "SIMPLE_PINHOLE":
            focal_x = focal_y = intr.params[0]
        elif intr.model == "PINHOLE":
            focal_x, focal_y = intr.params[0], intr.params[1]
        else:
            raise ValueError(
                f"unsupported COLMAP camera model {intr.model}; undistort first"
            )
        R = colmap.qvec2rotmat(img.qvec).T
        cam_infos.append(
            Camera(
                uid=img.id,
                image_name=os.path.splitext(img.name)[0],
                width=intr.width, height=intr.height,
                R=R, T=img.tvec.astype(np.float64),
                fovx=focal2fov(focal_x, intr.width),
                fovy=focal2fov(focal_y, intr.height),
                image_path=os.path.join(path, images_dir, img.name),
            )
        )

    if eval_split:
        train = [c for i, c in enumerate(cam_infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(cam_infos) if i % llffhold == 0]
    else:
        train, test = cam_infos, []

    pcd = None
    ply_path = os.path.join(sparse, "points3D.ply")
    bin_path = os.path.join(sparse, "points3D.bin")
    txt_path = os.path.join(sparse, "points3D.txt")
    if dense_ply_file:
        # --dense_ply_file: denser init cloud than the SfM sparse points
        # (readColmapSceneInfo, dataset_readers.py:221-225; the rubble4k
        # release scripts init from a fused MVS PLY this way)
        pcd = _load_ply_points(dense_ply_file)
        ply_path = dense_ply_file
    elif os.path.exists(bin_path):
        xyz, rgb, _ = colmap.read_points3d_binary(bin_path)
        pcd = PointCloud(xyz.astype(np.float32), rgb.astype(np.float32) / 255.0)
    elif os.path.exists(txt_path):
        xyz, rgb, _ = colmap.read_points3d_text(txt_path)
        pcd = PointCloud(xyz.astype(np.float32), rgb.astype(np.float32) / 255.0)
    elif os.path.exists(ply_path):
        pcd = _load_ply_points(ply_path)

    return SceneInfo(
        train_cameras=train, test_cameras=test, point_cloud=pcd,
        nerf_normalization=get_nerfpp_norm(train or cam_infos),
        ply_path=ply_path if dense_ply_file or not os.path.exists(bin_path)
        else bin_path,
    )


def _image_size(path):
    from PIL import Image

    with Image.open(path) as im:
        return im.size  # (w, h)


def _read_transforms_cameras(
    path: str, transformsfile: str, mode: str, uid0: int = 0,
    ocean_mask: bool = False, opengl_axes: bool = True, root_rel: str = "../..",
) -> List[Camera]:
    with open(os.path.join(path, transformsfile)) as f:
        transforms = json.load(f)
    frames = transforms["frames"]

    if ocean_mask:
        ocean_path = os.path.join(
            path, transformsfile.replace(".json", "_ocean_info.json")
        )
        with open(ocean_path) as f:
            ocean = json.load(f)["frames"]
        if len(ocean) != len(frames):
            raise ValueError(f"{ocean_path}: ocean info does not match frames")
        for i, (fr, o) in enumerate(zip(frames, ocean)):
            # the ocean file carries bare names; the transforms file may
            # carry a path — suffix match, exactly as the reference asserts
            # (dataset_readers.py:292-299)
            name = fr.get("file_name") or fr["file_path"]
            if not name.endswith(o["file_name"]):
                raise ValueError(
                    f"ocean info does not match frames at index {i}: "
                    f"{name} vs {o['file_name']}"
                )
        frames = [fr for fr, o in zip(frames, ocean) if not o["is_ocean"]]

    fovx_global = transforms.get("camera_angle_x")
    out = []
    for idx, frame in enumerate(frames):
        name = frame.get("file_name") or frame["file_path"]
        img_path = os.path.join(path, root_rel, mode, name)
        if not os.path.exists(img_path):
            # Blender-style relative path with extension to resolve
            alt = os.path.join(path, name)
            for ext in ("", ".png", ".jpg"):
                if os.path.exists(alt + ext):
                    img_path = alt + ext
                    break
            else:
                continue
        w, h = _image_size(img_path)
        c2w = np.array(frame["transform_matrix"], np.float64)
        if opengl_axes:
            c2w[:3, 1:3] *= -1  # OpenGL/Blender -> COLMAP axes
        w2c = np.linalg.inv(c2w)
        R = w2c[:3, :3].T
        T = w2c[:3, 3]
        if fovx_global is not None:
            fovx = fovx_global
            fovy = focal2fov(fov2focal(fovx, w), h)
        else:
            fovx = focal2fov(frame["fl_x"], w)
            fovy = focal2fov(frame["fl_y"], h)
        out.append(
            Camera(
                uid=uid0 + idx, image_name=os.path.splitext(os.path.basename(name))[0],
                width=w, height=h, R=R, T=T, fovx=fovx, fovy=fovy,
                image_path=img_path,
            )
        )
    return out


def detect_scene_type(src: str) -> str:
    """'city' | 'blender' | 'colmap' (the reference's sceneLoadTypeCallbacks
    dispatch, scene/__init__.py:58-70). City/Blender both keep
    transforms_train.json at the source root; MatrixCity frames use
    'file_name' (images outside the pose dir), Blender 'file_path'."""
    tpath = os.path.join(src, "transforms_train.json")
    if not os.path.exists(tpath):
        return "colmap"
    try:
        with open(tpath) as f:
            d = json.load(f)
        if bool(d.get("frames")) and "file_name" in d["frames"][0]:
            return "city"
    except Exception:
        pass
    return "blender"


def read_city_scene(
    path: str, ply_path: Optional[str] = None, ocean_mask: bool = False
) -> SceneInfo:
    """MatrixCity layout (readCityInfo, dataset_readers.py:496-554):
    {path}/transforms_{split}.json with {path} two levels below the image root
    (e.g. <root>/pose/block_all), images under {path}/../../{split}/."""
    train = _read_transforms_cameras(
        path, "transforms_train.json", "train", ocean_mask=ocean_mask,
        root_rel="../..",
    )
    test = _read_transforms_cameras(
        path, "transforms_test.json", "test", uid0=len(train),
        ocean_mask=ocean_mask, root_rel="../..",
    )
    pcd = _load_ply_points(ply_path) if ply_path else None
    return SceneInfo(
        train_cameras=train, test_cameras=test, point_cloud=pcd,
        nerf_normalization=get_nerfpp_norm(train),
        ply_path=ply_path,
    )


def read_blender_scene(
    path: str, white_background: bool = False, n_random_points: int = 100_000,
    seed: int = 0,
) -> SceneInfo:
    train = _read_transforms_cameras(path, "transforms_train.json", "", root_rel="")
    test = _read_transforms_cameras(
        path, "transforms_test.json", "", uid0=len(train), root_rel=""
    )
    ply_path = os.path.join(path, "points3d.ply")
    if os.path.exists(ply_path):
        pcd = _load_ply_points(ply_path)
    else:
        rng = np.random.RandomState(seed)
        pts = (rng.rand(n_random_points, 3).astype(np.float32) * 2.6) - 1.3
        pcd = PointCloud(pts, rng.rand(n_random_points, 3).astype(np.float32))
    return SceneInfo(
        train_cameras=train, test_cameras=test, point_cloud=pcd,
        nerf_normalization=get_nerfpp_norm(train),
        ply_path=ply_path,
    )

