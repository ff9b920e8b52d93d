"""A 360-degree object scene: splats on a ground square and on the shells of
ellipsoids, and a faint shell of large background splats, with every number
drawn on the device from the run's seed.

The layout is the port's synthetic bench scene's (`_surface_gaussians`: 35%
ground, 50% object shells, the rest background), drawn with torch instead
of numpy, with one colour per surface and the splats' size set from the
density, so that a larger count covers the same surfaces with smaller
splats, as a trained model does. The training targets are the same
surfaces ray-cast in their own colours (`targets`): what the splats stand
for, not a render of them. The background splats are black, as is the sky
the targets show where a ray meets no surface.
"""

from __future__ import annotations

import torch

from perfbench.scenes.common import normal_quats, raycast, sh_from_rgb, uniform

GROUND_Y = -1.0
GROUND_HALF = 4.0
CENTRE_LO = (-2.5, -1.0, -2.5)
CENTRE_HI = (2.5, 1.5, 2.5)
RADIUS_LO, RADIUS_HI = 0.15, 0.8
FOG_R = (8.0, 14.0)


def _layout(spec, g, dev):
    s = spec["shapes"]
    centres = torch.stack([uniform(s, lo, hi, g, dev)
                           for lo, hi in zip(CENTRE_LO, CENTRE_HI)], 1)
    radii = uniform((s, 3), RADIUS_LO, RADIUS_HI, g, dev)
    colours = uniform((s, 3), 0.05, 0.95, g, dev)
    return centres, radii, colours


def gaussians(spec: dict, g: torch.Generator, dev):
    """{"xyz", "opacity", "log_scale", "quat", "sh"} of spec["n"] rows, and
    the surfaces for `targets`."""
    n = spec["n"]
    n_ground = int(n * 0.35)
    n_obj = int(n * 0.50)
    n_fog = n - n_ground - n_obj
    centres, radii, colours = _layout(spec, g, dev)
    ground_rgb = torch.tensor(spec["ground_rgb"], device=dev)

    xyz = torch.empty(n, 3, device=dev)
    normal = torch.empty(n, 3, device=dev)
    rgb = torch.zeros(n, 3, device=dev)
    a, b = 0, n_ground
    xyz[a:b, 0] = uniform(n_ground, -GROUND_HALF, GROUND_HALF, g, dev)
    xyz[a:b, 1] = GROUND_Y
    xyz[a:b, 2] = uniform(n_ground, -GROUND_HALF, GROUND_HALF, g, dev)
    normal[a:b] = torch.tensor([0.0, 1.0, 0.0], device=dev)
    rgb[a:b] = ground_rgb
    a, b = b, b + n_obj
    which = torch.randint(0, centres.shape[0], (n_obj,), generator=g, device=dev)
    u = torch.randn(n_obj, 3, generator=g, device=dev)
    u = u / u.norm(dim=1, keepdim=True)
    xyz[a:b] = centres[which] + u * radii[which]
    nrm = u / radii[which]
    normal[a:b] = nrm / nrm.norm(dim=1, keepdim=True)
    rgb[a:b] = colours[which]
    a, b = b, n
    f = torch.randn(n_fog, 3, generator=g, device=dev)
    f = f / f.norm(dim=1, keepdim=True)
    xyz[a:b] = f * uniform((n_fog, 1), FOG_R[0], FOG_R[1], g, dev)
    normal[a:b] = -f

    n_surf = n_ground + n_obj
    base = spec["splat_scale"] * torch.exp(0.5 * torch.randn(n_surf, generator=g, device=dev))
    log_scale = torch.empty(n, 3, device=dev)
    log_scale[:n_surf, 0] = torch.log(base)
    log_scale[:n_surf, 1] = torch.log(base) + 0.3 * torch.randn(n_surf, generator=g,
                                                                 device=dev)
    log_scale[:n_surf, 2] = torch.log(0.1 * base)
    log_scale[n_surf:] = (torch.log(torch.tensor(spec["fog_scale"], device=dev))
                          + 0.4 * torch.randn(n_fog, 3, generator=g, device=dev))
    opacity = torch.empty(n, device=dev)
    opacity[:n_surf] = 2.5 + 1.2 * torch.randn(n_surf, generator=g, device=dev)
    opacity[n_surf:] = -2.0 + torch.randn(n_fog, generator=g, device=dev)
    sh = torch.empty(n, 48, device=dev)
    sh[:, :3] = sh_from_rgb(rgb) + spec["dc_noise"] * torch.randn(n, 3, generator=g,
                                                                  device=dev)
    sh[:, 3:] = spec["rest_noise"] * torch.randn(n, 45, generator=g, device=dev)
    params = {"xyz": xyz, "opacity": opacity, "log_scale": log_scale,
              "quat": normal_quats(normal), "sh": sh}
    return params, {"centres": centres, "radii": radii, "colours": colours,
                    "ground_rgb": ground_rgb}


def targets(spec: dict, surfaces: dict, cams: dict, ids, dev):
    """(len(ids), 3, H, W) uint8: the surfaces ray-cast from cameras `ids`."""
    c, r = surfaces["centres"], surfaces["radii"]
    inv_r2 = 1.0 / (r * r)

    def hit(o, d):
        # ellipsoids: |(o + t d - c) / r|^2 = 1, the nearer root in front
        a = (d * d) @ inv_r2.T
        oc = o[None] - c
        bh = d @ (oc * inv_r2).T
        cc = (oc * oc * inv_r2).sum(1)
        disc = bh * bh - a * cc
        root = torch.sqrt(torch.clamp_min(disc, 0.0))
        t = torch.where(cc[None] > 0, -bh - root, -bh + root) / a
        t = torch.where((disc >= 0) & (t > 1e-4), t, torch.full_like(t, float("inf")))
        t_obj, k = t.min(1)
        col = surfaces["colours"][k]
        # the ground square
        tg = (GROUND_Y - o[1]) / torch.where(d[:, 1] == 0, torch.full_like(d[:, 1], 1e-12),
                                             d[:, 1])
        p = o[None] + tg[:, None] * d
        ok = (tg > 1e-4) & (p[:, 0].abs() <= GROUND_HALF) & (p[:, 2].abs() <= GROUND_HALF)
        tg = torch.where(ok, tg, torch.full_like(tg, float("inf")))
        use_g = tg < t_obj
        col = torch.where(use_g[:, None], surfaces["ground_rgb"][None], col)
        miss = torch.isinf(torch.minimum(tg, t_obj))
        return torch.where(miss[:, None], torch.zeros_like(col), col)

    return raycast(cams, ids, hit, dev)

