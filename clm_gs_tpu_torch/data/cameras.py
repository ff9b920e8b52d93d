"""Camera model (clm_gs_tpu/data/cameras.py:24-172).

The numpy helpers are copies of the reference's; a ``CameraBatch`` holds the
stacked matrices as torch tensors on one device. World-to-view matrices are in
column-vector convention (``p_cam = viewmat @ [p; 1]``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from clm_gs_tpu_torch.utils.general import check_device


def get_world2view(R: np.ndarray, t: np.ndarray, translate=None, scale=1.0) -> np.ndarray:
    """World->view 4x4. R is the COLMAP cam-to-world rotation."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    if translate is not None or scale != 1.0:
        translate = np.zeros(3) if translate is None else np.asarray(translate)
        C2W = np.linalg.inv(Rt)
        cam_center = (C2W[:3, 3] + translate) * scale
        C2W[:3, 3] = cam_center
        Rt = np.linalg.inv(C2W)
    return Rt.astype(np.float32)


def get_projection_matrix(znear, zfar, fovx, fovy) -> np.ndarray:
    """OpenGL-style projection with z in [0,1], column-vector convention."""
    tan_half_fovy = math.tan(fovy / 2)
    tan_half_fovx = math.tan(fovx / 2)
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 1.0 / tan_half_fovx
    P[1, 1] = 1.0 / tan_half_fovy
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def fov2focal(fov, pixels):
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal, pixels):
    return 2 * math.atan(pixels / (2 * focal))


def intrinsics_from_fov(fovx, fovy, width, height) -> np.ndarray:
    fx = width / (2 * math.tan(fovx * 0.5))
    fy = height / (2 * math.tan(fovy * 0.5))
    return np.array(
        [[fx, 0, width / 2.0], [0, fy, height / 2.0], [0, 0, 1]], dtype=np.float32
    )


@dataclass(frozen=True)
class Camera:
    """One posed camera (host-side numpy metadata)."""

    uid: int
    image_name: str
    width: int
    height: int
    R: np.ndarray  # (3,3) cam-to-world rotation
    T: np.ndarray  # (3,) world-to-view translation
    fovx: float
    fovy: float
    znear: float = 0.01
    zfar: float = 100.0
    image_path: Optional[str] = None
    trans: np.ndarray = field(default_factory=lambda: np.zeros(3, dtype=np.float32))
    scale: float = 1.0

    @property
    def viewmat(self) -> np.ndarray:
        return get_world2view(self.R, self.T, self.trans, self.scale)

    @property
    def K(self) -> np.ndarray:
        return intrinsics_from_fov(self.fovx, self.fovy, self.width, self.height)

    @property
    def camera_center(self) -> np.ndarray:
        return np.linalg.inv(self.viewmat)[:3, 3].astype(np.float32)


@dataclass(frozen=True)
class CameraBatch:
    """B cameras of one resolution, stacked on one device."""

    viewmats: torch.Tensor  # (B, 4, 4)
    Ks: torch.Tensor  # (B, 3, 3)
    camtoworlds: torch.Tensor  # (B, 4, 4)
    width: int
    height: int

    @property
    def camera_centers(self) -> torch.Tensor:  # (B, 3)
        return self.camtoworlds[:, :3, 3]


def stack_cameras(cams: list[Camera], device="cuda") -> CameraBatch:
    device = check_device(device)
    viewmats = np.stack([c.viewmat for c in cams]).astype(np.float32)
    Ks = np.stack([c.K for c in cams]).astype(np.float32)
    camtoworlds = np.stack([np.linalg.inv(c.viewmat) for c in cams]).astype(np.float32)
    return CameraBatch(
        viewmats=torch.from_numpy(viewmats).to(device),
        Ks=torch.from_numpy(Ks).to(device),
        camtoworlds=torch.from_numpy(camtoworlds).to(device),
        width=cams[0].width,
        height=cams[0].height,
    )
