"""Tile rasterizer: compositing forward (kernel 1) and backward (kernel 2).

Port of clm_gs_tpu/ops/rasterize.py:321-1002 ``rasterize``. Semantics as in
the reference: alpha = min(0.999, op exp(-sigma)) at pixel centres; an
instance with alpha < 1/255 is skipped; a pixel stops before the instance that
would bring T <= 1e-4; image = sum w rgb + T_final bg. The backward is the
reference's hand-derived front-to-back VJP, with no gradient through the
0.999 clamp.

Binning (ops/tiles.py), in the span `render.bin`, gives a tile-major,
depth-ordered instance list.
Per-Gaussian attributes travel as one (N, 9) table [mx, my, ca, cb, cc, op,
r, g, b]. The forward saves, per pixel, its final T and the index of its last
composited instance; the backward emits one 9-column gradient row per
instance, which a stable sort by Gaussian id and the segment reduce (kernel 3,
ops/segreduce.py) turn into per-Gaussian gradients.

Each kernel has a plain PyTorch version here (``rasterize_fwd_plain``,
``rasterize_bwd_plain``) that walks the instances in chunks with the
reference's closed-form termination. CPU tensors take the plain versions,
CUDA tensors the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from clm_gs_tpu_torch import _build
from clm_gs_tpu_torch.ops.segreduce import segment_reduce_sorted
from clm_gs_tpu_torch.ops.tiles import isect_tiles, tight_extents
from clm_gs_tpu_torch.utils.timer import OFF

TILE_W = 64
TILE_H = 32
P = TILE_W * TILE_H
ALPHA_THRESHOLD = 1.0 / 255.0
T_EPS = 1e-4
MAX_ALPHA = 0.999
NGC = 9  # table columns: mx, my, ca, cb, cc, op, r, g, b
CHUNK = 64  # instances per step of the plain versions
# tiles per pass of the plain versions: their (tiles, CHUNK, P) maps stay
# within 2**28 floats each (a 4K frame's 4,080 tiles take two passes)
TILE_GROUP = 2**28 // (CHUNK * P)

_FWD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5
_BWD_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 7


def tile_grid(width: int, height: int):
    return -(-width // TILE_W), -(-height // TILE_H)


def _tile_pixels(width, height, device):
    """(T, P) pixel centres of every tile, tile-local row-major, and the
    inside-the-image mask."""
    tx_n, ty_n = tile_grid(width, height)
    t = torch.arange(tx_n * ty_n, device=device)
    idx = torch.arange(P, device=device)
    x = (t % tx_n)[:, None] * TILE_W + (idx % TILE_W)[None]
    y = (t // tx_n)[:, None] * TILE_H + (idx // TILE_W)[None]
    inside = (x < width) & (y < height)
    return x.float() + 0.5, y.float() + 0.5, inside


def _to_tiles(img, fill=0):
    """(C, H, W) -> (T, C, P), padding the ragged edge with `fill`."""
    C, H, W = img.shape
    tx_n, ty_n = tile_grid(W, H)
    pad = img.new_full((C, ty_n * TILE_H, tx_n * TILE_W), fill)
    pad[:, :H, :W] = img
    t = pad.reshape(C, ty_n, TILE_H, tx_n, TILE_W).permute(1, 3, 0, 2, 4)
    return t.reshape(ty_n * tx_n, C, P)


def _from_tiles(t, width, height):
    """(T, C, P) -> (C, H, W)."""
    tx_n, ty_n = tile_grid(width, height)
    C = t.shape[1]
    img = t.reshape(ty_n, tx_n, C, TILE_H, TILE_W).permute(2, 0, 3, 1, 4)
    return img.reshape(C, ty_n * TILE_H, tx_n * TILE_W)[:, :height, :width]


def _chunk(table, gauss_ids, starts, counts, k0, px, py):
    """Attributes and per-pixel alpha terms of instances [k0, k0 + CHUNK) of
    every tile: (T, K) indices and validity, (T, K, 9) rows, (T, K, P)
    maps."""
    K = CHUNK
    kk = k0 + torch.arange(K, device=table.device)
    valid = kk[None] < counts[:, None]
    idx = starts[:, None] + kk[None]
    gid = gauss_ids[torch.where(valid, idx, torch.zeros_like(idx))].long()
    attrs = torch.where(valid[..., None], table[gid], torch.zeros((), device=table.device))
    mx, my, ca, cb, cc, op = (attrs[..., c : c + 1] for c in range(6))
    dx = px[:, None, :] - mx
    dy = py[:, None, :] - my
    sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
    vis = torch.exp(-sigma)
    ga = op * vis
    alpha = torch.clamp_max(ga, MAX_ALPHA)
    ok = valid[..., None] & (sigma >= 0) & (alpha >= ALPHA_THRESHOLD)
    return idx, valid, attrs, dx, dy, vis, ga, alpha, ok


def _excl_cumprod(cp):
    return torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)


@torch.no_grad()
def rasterize_fwd_plain(table, gauss_ids, tile_offsets, background, width: int,
                        height: int):
    """Plain version of kernel 1: (image (3,H,W), alpha, t_final (H,W) f32,
    last (H,W) int32)."""
    dev = table.device
    px, py, inside = _tile_pixels(width, height, dev)
    nt = px.shape[0]
    starts = tile_offsets[:-1].long()
    counts = tile_offsets[1:].long() - starts
    parts = [_fwd_tiles(table, gauss_ids, starts[g:g + TILE_GROUP],
                        counts[g:g + TILE_GROUP], px[g:g + TILE_GROUP],
                        py[g:g + TILE_GROUP], inside[g:g + TILE_GROUP])
             for g in range(0, nt, TILE_GROUP)] or [
        _fwd_tiles(table, gauss_ids, starts, counts, px, py, inside)]
    rgb, acc, T, last = (torch.cat(x) for x in zip(*parts))
    image = rgb + T[:, None] * background[None, :, None]
    out = _from_tiles(torch.cat([image, acc[:, None], T[:, None]], 1), width, height)
    last_img = _from_tiles(last[:, None], width, height)[0].to(torch.int32)
    return (out[0:3].contiguous(), out[3].contiguous(), out[4].contiguous(),
            last_img.contiguous())


def _fwd_tiles(table, gauss_ids, starts, counts, px, py, inside):
    """The forward of a group of tiles: their (rgb, acc, T, last)."""
    dev = table.device
    nt = px.shape[0]
    T = torch.ones(nt, P, device=dev)
    done = ~inside
    rgb = torch.zeros(nt, 3, P, device=dev)
    acc = torch.zeros(nt, P, device=dev)
    last = torch.full((nt, P), -1, dtype=torch.int64, device=dev)
    max_count = int(counts.max()) if nt else 0
    for k0 in range(0, max_count, CHUNK):
        idx, _, attrs, _, _, _, _, alpha, ok = _chunk(
            table, gauss_ids, starts, counts, k0, px, py
        )
        a = torch.where(ok, alpha, torch.zeros_like(alpha))
        om = 1.0 - a
        cp = torch.cumprod(om, dim=1)
        T_excl = T[:, None] * _excl_cumprod(cp)
        viol = (a > 0) & (T_excl * om <= T_EPS)
        dead = torch.cumsum(viol.int(), dim=1) > 0
        keep = ~dead & ~done[:, None] & (a > 0)
        w = torch.where(keep, a * T_excl, torch.zeros_like(a))
        rgb += torch.einsum("tkp,tkc->tcp", w, attrs[..., 6:9])
        acc += w.sum(1)
        kidx = torch.where(keep, idx[..., None], torch.full_like(last[:, None], -1))
        last = torch.maximum(last, kidx.amax(1))
        T = T * torch.where(keep, om, torch.ones_like(om)).prod(1)
        done = done | viol.any(1)
        if bool(done.all()):
            break
    return rgb, acc, T, last


@torch.no_grad()
def rasterize_bwd_plain(table, gauss_ids, tile_offsets, image, alpha, last,
                        v_image, v_alpha, width: int, height: int):
    """Plain version of kernel 2: (M, 9) per-instance gradient rows."""
    dev = table.device
    m = gauss_ids.shape[0]
    px, py, _ = _tile_pixels(width, height, dev)
    nt = px.shape[0]
    out4 = _to_tiles(torch.cat([image, alpha[None]], 0))
    v4 = _to_tiles(torch.cat([v_image, v_alpha[None]], 0))
    last_t = _to_tiles(last[None].long(), fill=-1)[:, 0]
    d_tot = (out4 * v4).sum(1)
    starts = tile_offsets[:-1].long()
    counts = tile_offsets[1:].long() - starts
    # instances after a tile's last contributor get zero gradient
    needed = torch.minimum(counts, torch.clamp_min(last_t.amax(1) - starts + 1, 0))
    rows = torch.zeros(m, NGC, device=dev)
    for g in range(0, nt, TILE_GROUP):
        s = slice(g, g + TILE_GROUP)
        _bwd_tiles(rows, table, gauss_ids, starts[s], needed[s], px[s], py[s], v4[s],
                   last_t[s], d_tot[s])
    return rows


def _bwd_tiles(rows, table, gauss_ids, starts, needed, px, py, v4, last_t, d_tot):
    """The backward of a group of tiles, written into their instances'
    `rows`."""
    dev = table.device
    nt = px.shape[0]
    T = torch.ones(nt, P, device=dev)
    E = torch.zeros(nt, P, device=dev)
    max_needed = int(needed.max()) if nt else 0
    for k0 in range(0, max_needed, CHUNK):
        idx, valid, attrs, dx, dy, vis, ga, alpha_k, ok = _chunk(
            table, gauss_ids, starts, needed, k0, px, py
        )
        keep = ok & (idx[..., None] <= last_t[:, None, :])
        zero = torch.zeros_like(alpha_k)
        a = torch.where(keep, alpha_k, zero)
        om = 1.0 - a
        cp = torch.cumprod(om, dim=1)
        T_excl = T[:, None] * _excl_cumprod(cp)
        w = a * T_excl
        ctilde = torch.cat([attrs[..., 6:9], torch.ones_like(attrs[..., :1])], -1)
        dot1 = torch.einsum("tkc,tcp->tkp", ctilde, v4)
        cum = E[:, None] + torch.cumsum(w * dot1, dim=1)
        grad_ok = keep & (ga <= MAX_ALPHA)
        v_a = torch.where(grad_ok, T_excl * dot1 - (d_tot[:, None] - cum) / om, zero)
        v_sigma = torch.where(grad_ok, -ga * v_a, zero)
        ca, cb, cc = attrs[..., 2:3], attrs[..., 3:4], attrs[..., 4:5]
        g = torch.stack(
            [
                -((ca * dx + cb * dy) * v_sigma).sum(-1),
                -((cc * dy + cb * dx) * v_sigma).sum(-1),
                (0.5 * dx * dx * v_sigma).sum(-1),
                (dx * dy * v_sigma).sum(-1),
                (0.5 * dy * dy * v_sigma).sum(-1),
                (vis * v_a).sum(-1),
            ],
            dim=-1,
        )
        g = torch.cat([g, torch.einsum("tkp,tcp->tkc", w, v4[:, 0:3])], dim=-1)
        rows[idx[valid]] = g[valid]
        T = T * cp[:, -1]
        E = cum[:, -1]


def rasterize_fwd_cuda(table, gauss_ids, tile_offsets, background, width: int,
                       height: int):
    """Kernel 1 (csrc/rasterize_fwd.cu); outputs as rasterize_fwd_plain.

    Replaces ops/rasterize.py:321 _fwd_kernel of the reference. Bound by
    operations per (instance, pixel) pair: eight 16x16 blocks per 64x32 tile
    walk the tile's range with rows staged in shared memory beside a cut
    that rejects most pairs without the exp, one pixel per thread, and stop
    when every pixel of the block has terminated."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError("rasterize_fwd_cuda takes CUDA tensors")
    tx_n, ty_n = tile_grid(width, height)
    _build.require(table, "table", torch.float32, (table.shape[0], NGC), dev)
    _build.require(gauss_ids, "gauss_ids", torch.int32, (gauss_ids.shape[0],), dev)
    _build.require(tile_offsets, "tile_offsets", torch.int32, (tx_n * ty_n + 1,), dev)
    _build.require(background, "background", torch.float32, (3,), dev)
    if width * height >= 2**31 or gauss_ids.shape[0] >= 2**31:
        raise ValueError("rasterize: sizes exceed int32 indexing")
    image = torch.empty((3, height, width), dtype=torch.float32, device=dev)
    alpha = torch.empty((height, width), dtype=torch.float32, device=dev)
    t_final = torch.empty((height, width), dtype=torch.float32, device=dev)
    last = torch.empty((height, width), dtype=torch.int32, device=dev)
    if width * height == 0:
        return image, alpha, t_final, last
    _build.launch(
        "rasterize_fwd", "clmgs_rasterize_fwd", _FWD_ARGTYPES, dev,
        _build.ptr(table), _build.ptr(gauss_ids), _build.ptr(tile_offsets),
        _build.ptr(background), width, height, tx_n, ty_n, _build.ptr(image),
        _build.ptr(alpha), _build.ptr(t_final), _build.ptr(last),
    )
    return image, alpha, t_final, last


def rasterize_bwd_cuda(table, gauss_ids, tile_offsets, image, alpha, last,
                       v_image, v_alpha, width: int, height: int):
    """Kernel 2 (csrc/rasterize_bwd.cu); output as rasterize_bwd_plain.

    Replaces ops/rasterize.py:372 _bwd_kernel of the reference. Bound by
    operations: a cluster of eight 16x16 blocks per tile (one pixel per
    thread) replays each pixel up to its saved last instance and sums each
    instance's 9 gradients over the tile through distributed shared memory
    in a fixed order: one row per instance, without atomics, the same bits
    every run."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError("rasterize_bwd_cuda takes CUDA tensors")
    tx_n, ty_n = tile_grid(width, height)
    m = gauss_ids.shape[0]
    if width * height >= 2**31 or m >= 2**31:
        raise ValueError("rasterize: sizes exceed int32 indexing")
    _build.require(table, "table", torch.float32, (table.shape[0], NGC), dev)
    _build.require(gauss_ids, "gauss_ids", torch.int32, (m,), dev)
    _build.require(tile_offsets, "tile_offsets", torch.int32, (tx_n * ty_n + 1,), dev)
    for name, t, dt, shape in (
        ("image", image, torch.float32, (3, height, width)),
        ("alpha", alpha, torch.float32, (height, width)),
        ("last", last, torch.int32, (height, width)),
        ("v_image", v_image, torch.float32, (3, height, width)),
        ("v_alpha", v_alpha, torch.float32, (height, width)),
    ):
        _build.require(t, name, dt, shape, dev)
    rows = torch.empty((m, NGC), dtype=torch.float32, device=dev)
    if m == 0:
        return rows
    _build.launch(
        "rasterize_bwd", "clmgs_rasterize_bwd", _BWD_ARGTYPES, dev,
        _build.ptr(table), _build.ptr(gauss_ids), _build.ptr(tile_offsets),
        width, height, tx_n, ty_n, _build.ptr(image), _build.ptr(alpha),
        _build.ptr(last), _build.ptr(v_image), _build.ptr(v_alpha),
        _build.ptr(rows),
    )
    return rows


def rasterize_fwd(table, gauss_ids, tile_offsets, background, width, height):
    if table.device.type == "cuda":
        return rasterize_fwd_cuda(table, gauss_ids, tile_offsets, background,
                                  width, height)
    return rasterize_fwd_plain(table, gauss_ids, tile_offsets, background,
                               width, height)


def rasterize_bwd(table, gauss_ids, tile_offsets, image, alpha, last, v_image,
                  v_alpha, width, height):
    if table.device.type == "cuda":
        return rasterize_bwd_cuda(table, gauss_ids, tile_offsets, image, alpha,
                                  last, v_image, v_alpha, width, height)
    return rasterize_bwd_plain(table, gauss_ids, tile_offsets, image, alpha,
                               last, v_image, v_alpha, width, height)


class _Rasterize(torch.autograd.Function):
    """Compositing with the hand-derived backward; differentiable wrt
    means2d, conics, colors, opacities and background."""

    @staticmethod
    def forward(ctx, means2d, conics, colors, opacities, background, gauss_ids,
                tile_offsets, width, height):
        table = torch.cat(
            [means2d, conics, opacities[:, None], colors], dim=1
        ).contiguous()
        background = background.contiguous()
        image, alpha, t_final, last = rasterize_fwd(
            table, gauss_ids, tile_offsets, background, width, height
        )
        ctx.save_for_backward(table, gauss_ids, tile_offsets, image, alpha,
                              t_final, last)
        ctx.size = (width, height)
        return image, alpha

    @staticmethod
    def backward(ctx, v_image, v_alpha):
        table, gauss_ids, tile_offsets, image, alpha, t_final, last = (
            ctx.saved_tensors
        )
        width, height = ctx.size
        v_image = v_image.contiguous()
        v_alpha = v_alpha.contiguous()
        rows = rasterize_bwd(table, gauss_ids, tile_offsets, image, alpha, last,
                             v_image, v_alpha, width, height)
        ids_sorted, perm = torch.sort(gauss_ids, stable=True)
        v_table = segment_reduce_sorted(ids_sorted, rows[perm].contiguous(),
                                        table.shape[0])
        v_bg = (t_final[None] * v_image).sum(dim=(1, 2))
        return (v_table[:, 0:2], v_table[:, 2:5], v_table[:, 6:9],
                v_table[:, 5], v_bg, None, None, None, None)


def rasterize(means2d, conics, colors, opacities, depths, radii, width: int,
              height: int, background):
    """Render one camera from projected Gaussians.

    means2d (N,2), conics (N,3), colors (N,3), opacities (N,), depths (N,),
    radii (N,) with 0 = culled, background (3,).
    Returns (image (3, H, W), alpha (H, W), n_isects int). The binning
    (the extents and `isect_tiles`: the depth sort, the fill, the tile sort
    and the offsets) runs in the span `render.bin`.
    """
    tx_n, ty_n = tile_grid(width, height)
    with OFF.span("render.bin"):
        with torch.no_grad():
            ext = tight_extents(conics.detach(), opacities.detach(), radii.detach())
        isect = isect_tiles(means2d.detach(), radii.detach(), depths.detach(),
                            (TILE_W, TILE_H), tx_n, ty_n, extents=ext)
    image, alpha = _Rasterize.apply(
        means2d.float().contiguous(), conics.float().contiguous(),
        colors.float().contiguous(), opacities.float().contiguous(),
        background.float(), isect.gauss_ids, isect.tile_offsets, width, height,
    )
    return image, alpha, isect.n_isects
