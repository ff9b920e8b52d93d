"""Plain PyTorch reference of one 3D Gaussian Splatting training step, as the
benchmark's configurations state it: EWA projection, SH colour (degree 3),
binning into 64x32-pixel tiles with opacity-aware extents, front-to-back
alpha compositing, the 0.8 L1 + 0.2 (1 - SSIM) loss, and Adam with the
trainer's batch-size scaling (`--lr_scale_mode sqrt`), selective under
`--sparse_adam`.

Gradients come from autograd, not from a hand-derived backward. The
compositing runs over groups of tiles twice: once without a graph for the
image and the loss's gradient, then group by group with a graph, whose
backward adds into one (visible rows, 9) table of the rasterizer's inputs;
that table's gradient then goes back through projection and SH. Everything
but the loss is computed in `dtype` (float32; the control runs bfloat16),
with TF32 off.
It imports nothing of the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

TILE_W, TILE_H = 64, 32
P = TILE_W * TILE_H
CHUNK = 512  # instances a compositing step takes
GROUP_SLOTS = 1 << 27  # (tile, instance, pixel) slots of one group of tiles
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.999
T_MIN = 1e-4
EPS2D = 0.3
NEAR = 0.01
FAR = 1e10
LEAVES = ("xyz", "opacity", "log_scale", "quat", "sh")

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------- projection

def rotation(q):
    """(n, 4) quaternions [w, x, y, z], not normalised -> (n, 3, 3)."""
    q = q / torch.sqrt((q * q).sum(1, keepdim=True) + 1e-24)
    w, x, y, z = q.unbind(1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], 1).reshape(-1, 3, 3)


def project(xyz, quat, log_scale, view, K, width: int, height: int):
    """EWA splatting of n Gaussians into one camera: (means2d (n, 2),
    conic (n, 3) = the inverse 2D covariance's [a, b, c], depth (n,),
    radius (n,) with 0 where culled)."""
    Rw, tw = view[:3, :3], view[:3, 3]
    p = xyz @ Rw.T + tw
    z = p[:, 2]
    M = rotation(quat) * torch.exp(log_scale)[:, None, :]
    cov = Rw @ (M @ M.transpose(1, 2)) @ Rw.T
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    zs = torch.where(z == 0, torch.full_like(z, 1e-6), z)
    lx = 0.3 * (0.5 * width / fx)
    ly = 0.3 * (0.5 * height / fy)
    tx = zs * torch.clamp(p[:, 0] / zs, -(cx / fx + lx), (width - cx) / fx + lx)
    ty = zs * torch.clamp(p[:, 1] / zs, -(cy / fy + ly), (height - cy) / fy + ly)
    zero = torch.zeros_like(zs)
    J = torch.stack([fx / zs, zero, -fx * tx / (zs * zs),
                     zero, fy / zs, -fy * ty / (zs * zs)], 1).reshape(-1, 2, 3)
    c2 = J @ cov @ J.transpose(1, 2)
    a = c2[:, 0, 0] + EPS2D
    b = c2[:, 0, 1]
    c = c2[:, 1, 1] + EPS2D
    det = a * c - b * b
    ok = (z > NEAR) & (z < FAR) & (det > 0)
    det = torch.where(ok, det, torch.ones_like(det))
    conic = torch.stack([c / det, -b / det, a / det], 1)
    mid = 0.5 * (a + c)
    radius = torch.ceil(3.0 * torch.sqrt(mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.01))))
    m2d = torch.stack([fx * p[:, 0] / zs + cx, fy * p[:, 1] / zs + cy], 1)
    with torch.no_grad():
        seen = ok & ((m2d[:, 0] + radius > 0) & (m2d[:, 0] - radius < width)
                     & (m2d[:, 1] + radius > 0) & (m2d[:, 1] - radius < height)
                     & (radius > 0))
        radius = torch.where(seen, radius, torch.zeros_like(radius)).detach()
    return m2d, conic, z, radius


def sh_colour(xyz, sh, campos):
    """Degree-3 SH colour of each Gaussian seen from `campos`, + 0.5,
    clamped at 0: (n, 3)."""
    d = xyz - campos
    d = d / (torch.sqrt((d * d).sum(1, keepdim=True)) + 1e-12)
    x, y, z = d.unbind(1)
    xx, yy, zz = x * x, y * y, z * z
    basis = torch.stack([
        SH_C0 * torch.ones_like(x), -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
        SH_C2[0] * x * y, SH_C2[1] * y * z, SH_C2[2] * (2 * zz - xx - yy),
        SH_C2[3] * x * z, SH_C2[4] * (xx - yy),
        SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * x * y * z,
        SH_C3[2] * y * (4 * zz - xx - yy), SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
        SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
        SH_C3[6] * x * (xx - 3 * yy),
    ], 1)
    rgb = (basis[:, :, None] * sh.reshape(-1, 16, 3)).sum(1)
    return torch.clamp_min(rgb + 0.5, 0.0)


# ---------------------------------------------------------------- binning

def tile_grid(width: int, height: int):
    return -(-width // TILE_W), -(-height // TILE_H)


@torch.no_grad()
def bin_tiles(table, radius, depth, width: int, height: int):
    """Instances of each 64x32 tile, front to back: (ids (m,) rows of
    `table`, grouped by tile and depth-ordered inside each, starts (T,) and
    counts (T,)). A Gaussian covers the tiles of the box around its ellipse
    where op * exp(-sigma) >= 1/255, widened by a pixel and capped at its
    3-sigma radius."""
    m2d, ca, cb, cc, op = table[:, 0:2], table[:, 2], table[:, 3], table[:, 4], table[:, 5]
    t_sup = torch.log(255.0 * torch.clamp_min(op, 1e-12))
    det = torch.clamp_min(ca * cc - cb * cb, 1e-12)
    tt = 2.0 * torch.clamp_min(t_sup, 0.0)
    good = (radius > 0) & (t_sup > 0)
    rx = torch.where(good, torch.minimum(torch.sqrt(tt * cc / det) + 1.0, radius), 0.0)
    ry = torch.where(good, torch.minimum(torch.sqrt(tt * ca / det) + 1.0, radius), 0.0)
    nx, ny = tile_grid(width, height)
    x0 = torch.clamp(torch.floor((m2d[:, 0] - rx) / TILE_W), 0, nx).long()
    x1 = torch.clamp(torch.ceil((m2d[:, 0] + rx) / TILE_W), 0, nx).long()
    y0 = torch.clamp(torch.floor((m2d[:, 1] - ry) / TILE_H), 0, ny).long()
    y1 = torch.clamp(torch.ceil((m2d[:, 1] + ry) / TILE_H), 0, ny).long()
    n = torch.where(good & (rx > 0) & (ry > 0), (x1 - x0) * (y1 - y0), 0)
    front = torch.sort(torch.where(n > 0, depth, torch.full_like(depth, float("inf"))),
                       stable=True).indices
    n = n[front]
    rows = torch.repeat_interleave(front, n)
    first = torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
    k = torch.arange(rows.shape[0], device=table.device) - first
    w = (x1 - x0)[rows]
    tile = (y0[rows] + k // w) * nx + x0[rows] + k % w
    tile, order = torch.sort(tile, stable=True)
    counts = torch.bincount(tile, minlength=nx * ny)
    return rows[order], torch.cumsum(counts, 0) - counts, counts


# ---------------------------------------------------------------- compositing

def tile_pixels(tiles, width: int, height: int):
    """Integer pixel coordinates (x, y) (G, P) of tiles `tiles`, row-major in a tile,
    and which lie inside the image."""
    nx, _ = tile_grid(width, height)
    i = torch.arange(P, device=tiles.device)
    x = (tiles % nx)[:, None] * TILE_W + (i % TILE_W)[None]
    y = (tiles // nx)[:, None] * TILE_H + (i // TILE_W)[None]
    return x, y, (x < width) & (y < height)


def _chunk(table, ids, starts, counts, k0, px, py, T):
    """Instances [k0, k0 + CHUNK) of each tile against its pixels: (alpha
    a (G, K, P) after the skips, 1 - a, the transmittance before each,
    each instance's colour (G, K, 3))."""
    kk = k0 + torch.arange(CHUNK, device=px.device)
    valid = kk[None] < counts[:, None]
    rows = table[ids[torch.where(valid, starts[:, None] + kk[None], 0)]]
    dx = px - rows[..., 0:1]
    dy = py - rows[..., 1:2]
    sigma = 0.5 * (rows[..., 2:3] * dx * dx + rows[..., 4:5] * dy * dy) + rows[..., 3:4] * dx * dy
    alpha = torch.clamp_max(rows[..., 5:6] * torch.exp(-sigma), ALPHA_MAX)
    a = torch.where(valid[..., None] & (sigma >= 0) & (alpha >= ALPHA_MIN), alpha, 0.0)
    om = 1.0 - a
    cp = torch.cumprod(om, 1)
    t_before = T[:, None] * torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], 1)
    return a, om, t_before, rows[..., 6:9]


def _step(a, om, t_before, done):
    """Which instances a pixel composites (none at or after the one that
    would bring its transmittance to 1e-4 or less), and which pixels that
    ends."""
    with torch.no_grad():
        stop = (a > 0) & (t_before * om <= T_MIN)
        keep = (torch.cumsum(stop.int(), 1) == 0) & ~done[:, None] & (a > 0)
    return keep, stop.any(1)


def _pixels(x, y, dtype):
    return (x.to(dtype) + 0.5)[:, None, :], (y.to(dtype) + 0.5)[:, None, :]


@torch.no_grad()
def composite_tiles(table, ids, starts, counts, x, y, inside):
    """Front-to-back compositing of a group of tiles, without a graph:
    (rgb (G, 3, P), T (G, P), walked (G,): the instances a tile walked
    until each of its pixels had ended, or all). A pixel skips an instance
    with sigma < 0 or alpha < 1/255 and stops before the one that would bring
    its transmittance to 1e-4 or less. A tile leaves the group once every
    pixel of it has ended."""
    dt = table.dtype
    G = x.shape[0]
    rgb_out = torch.zeros(G, 3, P, dtype=dt, device=x.device)
    T_out = torch.ones(G, P, dtype=dt, device=x.device)
    walked = counts.clone()
    act = torch.arange(G, device=x.device)
    px, py = _pixels(x, y, dt)
    T = torch.ones(G, P, dtype=dt, device=x.device)
    done = ~inside
    rgb = torch.zeros(G, 3, P, dtype=dt, device=x.device)
    k0 = 0
    while act.numel() and k0 < int(counts[act].max()):
        a, om, t_before, col = _chunk(table, ids, starts[act], counts[act], k0, px, py, T)
        keep, ended = _step(a, om, t_before, done)
        rgb += torch.einsum("gkp,gkc->gcp", torch.where(keep, a * t_before, 0.0), col)
        T = T * torch.where(keep, om, 1.0).prod(1)
        done = done | ended
        k0 += CHUNK
        fin = done.all(1)
        if bool(fin.any()):
            rgb_out[act[fin]], T_out[act[fin]] = rgb[fin], T[fin]
            walked[act[fin]] = torch.clamp_max(counts[act[fin]], k0)
            rest = ~fin
            act, rgb, T, done, px, py = act[rest], rgb[rest], T[rest], done[rest], px[rest], py[rest]
    rgb_out[act], T_out[act] = rgb, T
    return rgb_out, T_out, walked


def composite_tiles_graph(table, ids, starts, walked, x, y, inside):
    """The same with a graph, each tile walking its `walked` instances."""
    dt = table.dtype
    G = x.shape[0]
    px, py = _pixels(x, y, dt)
    T = torch.ones(G, P, dtype=dt, device=x.device)
    done = ~inside
    rgb = torch.zeros(G, 3, P, dtype=dt, device=x.device)
    for k0 in range(0, int(walked.max()), CHUNK):
        a, om, t_before, col = _chunk(table, ids, starts, walked, k0, px, py, T)
        keep, ended = _step(a, om, t_before, done)
        rgb = rgb + torch.einsum("gkp,gkc->gcp", torch.where(keep, a * t_before, 0.0), col)
        T = T * torch.where(keep, om, 1.0).prod(1)
        done = done | ended
    return rgb, T


def tile_groups(counts):
    """Non-empty tiles, most instances first, in groups of at most
    GROUP_SLOTS padded (tile, instance, pixel) slots (a tile alone may
    exceed it)."""
    order = torch.argsort(counts, descending=True)
    c = counts[order].tolist()
    groups, lo = [], 0
    while lo < len(c) and c[lo] > 0:
        hi = lo + 1
        while hi < len(c) and c[hi] > 0 and (hi + 1 - lo) * c[lo] * P <= GROUP_SLOTS:
            hi += 1
        groups.append(order[lo:hi])
        lo = hi
    return groups


def render(table, ids, starts, counts, bg, width: int, height: int):
    """(the image (3, H, W) of `table`, each tile's walked instances)."""
    dt = table.dtype
    img = bg.to(dt)[:, None, None].expand(3, height, width).clone()
    walked = torch.zeros_like(counts)
    for tiles in tile_groups(counts):
        x, y, inside = tile_pixels(tiles, width, height)
        rgb, T, walked[tiles] = composite_tiles(table, ids, starts[tiles], counts[tiles], x, y,
                                                inside)
        out = rgb + T[:, None] * bg.to(dt)[None, :, None]
        img[:, y[inside], x[inside]] = out.permute(1, 0, 2)[:, inside]
    return img, walked


def render_backward(table, ids, starts, walked, bg, width: int, height: int, v_image):
    """The backward of <image, v_image> into table.grad, group by group,
    each tile walking what its forward walked."""
    for tiles in tile_groups(walked):
        x, y, inside = tile_pixels(tiles, width, height)
        rgb, T = composite_tiles_graph(table, ids, starts[tiles], walked[tiles], x, y, inside)
        out = rgb + T[:, None] * bg.to(table.dtype)[None, :, None]
        v = v_image[:, y.clamp_max(height - 1), x.clamp_max(width - 1)].permute(1, 0, 2)
        (out * (v * inside[:, None]).to(out.dtype)).sum().backward()


# ---------------------------------------------------------------- loss

def _window(dtype, device):
    g = torch.exp(-(torch.arange(11, dtype=torch.float64) - 5) ** 2 / (2 * 1.5 ** 2))
    return (g / g.sum()).to(dtype).to(device)


def loss_fn(img, gt, lambda_dssim: float = 0.2):
    """(1 - l) L1 + l (1 - SSIM), SSIM over an 11x11 Gaussian window of
    sigma 1.5 with zero padding; gt clamped to [0, 1]."""
    gt = torch.clamp(gt, 0.0, 1.0)
    x = torch.cat([img, gt, img * img, gt * gt, img * gt])[None]
    w = _window(img.dtype, img.device)
    c = x.shape[1]
    x = F.conv2d(x, w.view(1, 1, 11, 1).expand(c, 1, 11, 1), padding=(5, 0), groups=c)
    x = F.conv2d(x, w.view(1, 1, 1, 11).expand(c, 1, 1, 11), padding=(0, 5), groups=c)[0]
    mu1, mu2, s11, s22, s12 = x[0:3], x[3:6], x[6:9], x[9:12], x[12:15]
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim = ((2 * mu1 * mu2 + c1) * (2 * (s12 - mu1 * mu2) + c2)) / (
        (mu1 * mu1 + mu2 * mu2 + c1) * ((s11 - mu1 * mu1) + (s22 - mu2 * mu2) + c2))
    return (1 - lambda_dssim) * (img - gt).abs().mean() + lambda_dssim * (1 - ssim.mean())


# ---------------------------------------------------------------- one camera

def camera_step(params, grads, view, K, campos, gt, bg, width: int, height: int, dtype):
    """Forward and backward of one camera: adds d(loss)/d(params) into
    `grads` (leaf -> float32 tensor of the leaf's shape). Returns (loss,
    visible (n,) bool)."""
    with torch.no_grad():
        _, _, _, radius = project(params["xyz"].to(dtype), params["quat"].to(dtype),
                                  params["log_scale"].to(dtype), view.to(dtype),
                                  K.to(dtype), width, height)
        vis = radius > 0
        idx = torch.nonzero(vis)[:, 0]
    sub = {k: params[k][idx].to(dtype).requires_grad_(True) for k in LEAVES}
    m2d, conic, depth, radius = project(sub["xyz"], sub["quat"], sub["log_scale"],
                                        view.to(dtype), K.to(dtype), width, height)
    table = torch.cat([m2d, conic, torch.sigmoid(sub["opacity"])[:, None],
                       sh_colour(sub["xyz"], sub["sh"], campos.to(dtype))], 1)
    leaf = table.detach().requires_grad_(True)
    ids, starts, counts = bin_tiles(leaf.detach(), radius, depth, width, height)
    bg = bg.to(dtype)
    image, walked = render(leaf, ids, starts, counts, bg, width, height)
    image.requires_grad_(True)
    # the loss in float32 whatever `dtype`: SSIM's variances cancel to
    # nothing in bfloat16
    loss = loss_fn(image.float(), gt.float())
    loss.backward()
    render_backward(leaf, ids, starts, walked, bg, width, height, image.grad)
    table.backward(leaf.grad)
    with torch.no_grad():
        for k in LEAVES:
            if sub[k].grad is not None:
                grads[k].index_add_(0, idx, sub[k].grad.float())
    return float(loss.detach()), vis


# ---------------------------------------------------------------- training

def adam_constants(bsz: int):
    """(beta1, beta2, eps) under --lr_scale_mode sqrt."""
    return 0.9 ** bsz, 0.999 ** bsz, 1e-15 / math.sqrt(bsz)


def train(p0: dict, steps, cams: dict, gt_of, bg, bsz: int, sparse: bool,
          dtype=torch.float32):
    """Adam over `steps` from the parameters `p0` (leaf -> (n, ...) float32,
    copied): each step is (camera ids, {leaf: learning rate, the "sh" one
    (48,)}), its cameras' gradients summed and divided by bsz; under
    `sparse` only the rows some camera of the batch sees are updated.
    `gt_of(cam)` gives a camera's target (3, H, W) in [0, 1]. Returns
    {"losses": per step the batch's mean loss, "grad": per leaf the norm of
    step 1's gradient, "change": per leaf the norm of the parameters'
    change after the last step}."""
    no_tf32()
    p = {k: p0[k].clone() for k in LEAVES}
    m = {k: torch.zeros_like(p[k]) for k in LEAVES}
    v = {k: torch.zeros_like(p[k]) for k in LEAVES}
    b1, b2, eps = adam_constants(bsz)
    W, H = cams["width"], cams["height"]
    out = {"losses": []}
    for t, (ids, lrs) in enumerate(steps, start=1):
        g = {k: torch.zeros_like(p[k]) for k in LEAVES}
        losses, seen = [], torch.zeros(p["xyz"].shape[0], dtype=torch.bool,
                                       device=p["xyz"].device)
        for i in ids:
            loss, vis = camera_step(p, g, cams["viewmats"][i], cams["Ks"][i],
                                    cams["camtoworlds"][i, :3, 3], gt_of(i), bg, W, H,
                                    dtype)
            losses.append(loss)
            seen |= vis
        out["losses"].append(sum(losses) / len(losses))
        with torch.no_grad():
            bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
            if t == 1:
                out["grad"] = {k: _norm(g[k] / bsz) for k in LEAVES}
            for k in LEAVES:
                gk = g.pop(k) / bsz
                mask = (seen if sparse else torch.ones_like(seen)).reshape(
                    (-1,) + (1,) * (gk.ndim - 1))
                m[k] = torch.where(mask, b1 * m[k] + (1 - b1) * gk, m[k])
                v[k] = torch.where(mask, b2 * v[k] + (1 - b2) * gk * gk, v[k])
                step = lrs[k] * (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + eps)
                p[k] = torch.where(mask, p[k] - step, p[k])
    with torch.no_grad():
        out["change"] = {k: _norm(p[k] - p0[k]) for k in LEAVES}
    return out


def _norm(x) -> float:
    return float(torch.linalg.vector_norm(x.double()))
