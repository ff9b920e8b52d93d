"""A street-level city: splats on a ground square and on the walls and roofs
of box buildings, every number drawn on the device from the run's seed.

The layout is the port's BigCity scene's (`utils/bigcity.py`
`city_gaussians`: 35% ground, the rest on 2,500 boxes over a square of side
2 x extent; scales about the local spacing, random orientations, 70%
opaque and 30% haze; one base colour per building), drawn with torch
instead of numpy. The training targets are the ground and the boxes
ray-cast in their base colours (`targets`); a camera casts only against the
boxes whose bounding spheres meet its view.
"""

from __future__ import annotations

import math

import torch

from perfbench.scenes.common import C0, raycast, uniform

BOX_CHUNK = 64
GROUND_SH = (0.1, 0.2, 0.1)


def gaussians(spec: dict, g: torch.Generator, dev):
    """{"xyz", "opacity", "log_scale", "quat", "sh"} of spec["n"] rows, and
    the surfaces for `targets`."""
    n, E, nb = spec["n"], spec["extent"], spec["buildings"]
    n_ground = int(n * 0.35)
    n_bld = n - n_ground
    centre = torch.stack([uniform(nb, -0.95 * E, 0.95 * E, g, dev), torch.zeros(nb, device=dev),
                          uniform(nb, -0.95 * E, 0.95 * E, g, dev)], 1)
    half = torch.stack([uniform(nb, 1.0, 4.0, g, dev), uniform(nb, 2.0, 12.0, g, dev),
                        uniform(nb, 1.0, 4.0, g, dev)], 1)
    bld_sh = uniform((nb, 3), -0.8, 0.8, g, dev)

    xyz = torch.empty(n, 3, device=dev)
    xyz[:n_ground, 0] = uniform(n_ground, -E, E, g, dev)
    xyz[:n_ground, 1] = 0.0
    xyz[:n_ground, 2] = uniform(n_ground, -E, E, g, dev)
    which = torch.randint(0, nb, (n_bld,), generator=g, device=dev)
    face = torch.randint(0, 5, (n_bld,), generator=g, device=dev)
    u = uniform(n_bld, -1.0, 1.0, g, dev)
    v = uniform(n_bld, 0.0, 1.0, g, dev)
    w = uniform(n_bld, -1.0, 1.0, g, dev)
    s = half[which]
    sgn = torch.where(face % 2 == 0, 1.0, -1.0)
    # faces 0, 1: the +-x walls; 2, 3: the +-z walls; 4: the roof
    xw, zw, roof = face < 2, (face >= 2) & (face < 4), face == 4
    local = torch.stack([
        torch.where(xw, sgn * s[:, 0], u * s[:, 0]),
        torch.where(roof, s[:, 1], v * s[:, 1]),
        torch.where(zw, sgn * s[:, 2], torch.where(roof, w, u) * s[:, 2]),
    ], 1)
    xyz[n_ground:] = centre[which] + local

    spacing = E * 2 / math.sqrt(n / 4.0)
    log_scale = math.log(spacing) + 0.4 * torch.randn(n, 3, generator=g, device=dev)
    quat = torch.randn(n, 4, generator=g, device=dev)
    quat = quat / quat.norm(dim=1, keepdim=True)
    opaque = torch.rand(n, generator=g, device=dev) < 0.7
    opacity = torch.where(opaque, uniform(n, 1.5, 5.0, g, dev), uniform(n, -3.0, -0.5, g, dev))
    sh = torch.empty(n, 48, device=dev)
    ground_sh = torch.tensor(GROUND_SH, device=dev)
    sh[:n_ground, :3] = ground_sh + 0.1 * torch.randn(n_ground, 3, generator=g, device=dev)
    sh[n_ground:, :3] = bld_sh[which] + 0.05 * torch.randn(n_bld, 3, generator=g, device=dev)
    sh[:, 3:] = 0.02 * torch.randn(n, 45, generator=g, device=dev)
    params = {"xyz": xyz, "opacity": opacity, "log_scale": log_scale, "quat": quat,
              "sh": sh}
    # a box spans [centre - half, centre + half] in x and z, [0, height] in y
    lo = centre - half * torch.tensor([1.0, 0.0, 1.0], device=dev)
    return params, {"lo": lo, "hi": centre + half, "rgb": C0 * bld_sh + 0.5,
                    "ground_rgb": C0 * ground_sh + 0.5, "extent": E}


def _in_view(lo, hi, view, K, width, height):
    """(boxes,) bool: the bounding sphere of each box meets the camera's
    view frustum (conservatively)."""
    c = 0.5 * (lo + hi)
    r = 0.5 * (hi - lo).norm(dim=1)
    p = c @ view[:3, :3].T + view[:3, 3]
    tx = 0.5 * width / K[0, 0]
    ty = 0.5 * height / K[1, 1]
    z = p[:, 2]
    return ((z + r > 0)
            & (p[:, 0].abs() <= (z + r) * tx + r * math.sqrt(1 + float(tx) ** 2))
            & (p[:, 1].abs() <= (z + r) * ty + r * math.sqrt(1 + float(ty) ** 2)))


def targets(spec: dict, surfaces: dict, cams: dict, ids, dev):
    """(len(ids), 3, H, W) uint8: the ground and the boxes ray-cast from
    cameras `ids`."""
    E = surfaces["extent"]
    W, H = cams["width"], cams["height"]
    images = []
    for i in ids.tolist():
        keep = _in_view(surfaces["lo"], surfaces["hi"], cams["viewmats"][i],
                        cams["Ks"][i], W, H)
        lo, hi, rgb = surfaces["lo"][keep], surfaces["hi"][keep], surfaces["rgb"][keep]

        def hit(o, d, lo=lo, hi=hi, rgb=rgb):
            d = torch.where(d == 0, torch.full_like(d, 1e-12), d)
            inv = 1.0 / d
            t = torch.full((d.shape[0],), float("inf"), device=dev)
            col = torch.zeros(d.shape[0], 3, device=dev)
            for b in range(0, lo.shape[0], BOX_CHUNK):
                t1 = (lo[None, b:b + BOX_CHUNK] - o) * inv[:, None]
                t2 = (hi[None, b:b + BOX_CHUNK] - o) * inv[:, None]
                tmin = torch.minimum(t1, t2).amax(-1)
                tmax = torch.maximum(t1, t2).amin(-1)
                tb = torch.where(tmin > 1e-4, tmin, tmax)
                tb = torch.where((tmax >= torch.clamp_min(tmin, 1e-4)), tb,
                                 torch.full_like(tb, float("inf")))
                tb, k = tb.min(1)
                nearer = tb < t
                t = torch.where(nearer, tb, t)
                col = torch.where(nearer[:, None], rgb[b:b + BOX_CHUNK][k], col)
            tg = -o[1] / d[:, 1]
            p = o[None] + tg[:, None] * d
            ground = ((tg > 1e-4) & (tg < t) & (p[:, 0].abs() <= E) & (p[:, 2].abs() <= E))
            col = torch.where(ground[:, None], surfaces["ground_rgb"][None], col)
            return col

        images.append(raycast(cams, torch.tensor([i]), hit, dev))
    return torch.cat(images)
