"""What the scene generators share: draws on a generator, the SH DC of a
colour, splat orientations from surface normals, and the per-camera ray
cast that makes the training targets."""

from __future__ import annotations

import torch

C0 = 0.28209479177387814  # the degree-0 SH basis constant
# pixels a ray-cast pass takes at once
RAY_CHUNK = 1 << 18


def uniform(shape, lo, hi, g, dev):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)


def sh_from_rgb(rgb):
    """The SH DC coefficients whose degree-0 colour is `rgb`."""
    return (rgb - 0.5) / C0


def normal_quats(normal):
    """(n, 4) unit quaternions [w, x, y, z] that turn +z onto each unit
    `normal`: a flat splat's thin axis along the surface normal."""
    z = torch.zeros_like(normal)
    z[:, 2] = 1.0
    axis = torch.cross(z, normal, dim=1)
    s = axis.norm(dim=1)
    c = normal[:, 2]
    w = torch.sqrt(torch.clamp_min(0.5 * (1.0 + c), 1e-12))
    v = axis / torch.clamp_min(s, 1e-12)[:, None] * torch.sqrt(
        torch.clamp_min(0.5 * (1.0 - c), 0.0))[:, None]
    return torch.cat([w[:, None], v], 1)


def pixel_rays(K, c2w, width: int, height: int, dev):
    """(origin (3,), directions (H*W, 3)) of the pixel centres, row-major."""
    ys, xs = torch.meshgrid(torch.arange(height, device=dev, dtype=torch.float32) + 0.5,
                            torch.arange(width, device=dev, dtype=torch.float32) + 0.5,
                            indexing="ij")
    d = torch.stack([(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1],
                     torch.ones_like(xs)], -1).reshape(-1, 3)
    return c2w[:3, 3], d @ c2w[:3, :3].T


def raycast(cams: dict, ids, hit, dev):
    """(len(ids), 3, H, W) uint8 images: `hit(origin, dirs)` gives the RGB
    in [0, 1] of each ray, RAY_CHUNK rays at a time."""
    W, H = cams["width"], cams["height"]
    out = torch.empty((len(ids), 3, H, W), dtype=torch.uint8, device=dev)
    for j, i in enumerate(ids.tolist()):
        o, d = pixel_rays(cams["Ks"][i], cams["camtoworlds"][i], W, H, dev)
        rgb = torch.cat([hit(o, d[s:s + RAY_CHUNK])
                         for s in range(0, d.shape[0], RAY_CHUNK)])
        img = torch.round(torch.clamp(rgb, 0.0, 1.0) * 255.0).to(torch.uint8)
        out[j] = img.T.reshape(3, H, W)
    return out
