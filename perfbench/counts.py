"""The yardstick's peaks and work counts: the least time one H100 could take
for a kernel launch, and the float32 operations of a training batch.

A bound is the larger of bytes / PEAK_BYTES and operations / PEAK_F32
(NVIDIA's H100 SXM data sheet, at the full 700 W). The counts come from a
launch's inputs, never from the kernel's launch geometry, so a kernel's
roofline share reads the same work whatever implements it:

- compositing (forward and backward): the (instance, pixel) pairs the
  inputs need, by how far each goes (`pair_counts`): the forward tests a
  pixel's instances up to the one that ends it, the backward replays them up
  to the pixel's last composited instance. Bytes: the table, the instance
  list and offsets read once, the per-pixel outputs (forward) or the
  per-pixel inputs and per-instance gradient rows (backward) once.
- the segment reduce: the sorted ids and rows read once, the sums written.
- the fill: each channel slot read once and written once.

These are frozen copies of the port's chip check (`chip_smoke.py` `_bound`,
`pair_counts`, `_pair_ops`, `OPS_*`), which import nothing of the port.
"""

from __future__ import annotations

import torch

PEAK_BYTES = 3.35e12  # HBM3 bytes/s
PEAK_F32 = 67e12  # float32 FLOP/s outside the tensor cores

TILE_W, TILE_H = 64, 32
P = TILE_W * TILE_H
CHUNK = 512
TILE_GROUP = 2 ** 28 // (CHUNK * P)
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.999
T_MIN = 1e-4
# float32 operations per (instance, pixel) pair (an FMA is two, exp one), by
# how far the pair goes: past the row's sigma cut (the offsets, the
# quadratic form and a compare), sigma < 0, alpha < 1/255 after the exp,
# op * vis, the clamp and the compare; a composited pair adds the forward's
# transmittance and colour sums or the backward's replayed weight and its 9
# gradient terms
OPS_CUT = 12
OPS_CULLED = 13
OPS_TESTED = 17
OPS_COMPOSITED = {"fwd": OPS_TESTED + 11, "bwd": OPS_TESTED + 46}
KINDS = ("cut", "culled", "tested", "composited")
# whole-batch operations besides compositing, forward and backward (the
# backward counted as twice the forward): per visible Gaussian and camera,
# the projection (view transform, covariance from quaternion and scales,
# the Jacobian's product, the inverse and radius: ~260) and the degree-3
# SH colour (basis ~40, 48 products and sums ~100; ~150); per pixel and
# channel, the loss (five 11-tap separable blurs, the SSIM map and L1:
# ~250); per updated parameter float, Adam (~14)
OPS_GAUSSIAN = 3 * (260 + 150)
OPS_PIXEL_CHANNEL = 3 * 250
OPS_ADAM_FLOAT = 14


def bound_s(nbytes: float, ops: float) -> float:
    """The least seconds a launch could take on the card."""
    return max(nbytes / PEAK_BYTES, ops / PEAK_F32)


def tile_grid(width: int, height: int):
    return -(-width // TILE_W), -(-height // TILE_H)


def _tile_pixels(width, height, device):
    nx, ny = tile_grid(width, height)
    t = torch.arange(nx * ny, device=device)
    i = torch.arange(P, device=device)
    x = (t % nx)[:, None] * TILE_W + (i % TILE_W)[None]
    y = (t // nx)[:, None] * TILE_H + (i // TILE_W)[None]
    return x.float() + 0.5, y.float() + 0.5, (x < width) & (y < height)


def _to_tiles(img, fill):
    """(H, W) -> (T, P), padding the ragged edge with `fill`."""
    H, W = img.shape
    nx, ny = tile_grid(W, H)
    pad = img.new_full((ny * TILE_H, nx * TILE_W), fill)
    pad[:H, :W] = img
    return pad.reshape(ny, TILE_H, nx, TILE_W).permute(0, 2, 1, 3).reshape(nx * ny, P)


@torch.no_grad()
def pair_counts(table, gauss_ids, tile_offsets, last, width: int, height: int):
    """{"fwd" | "bwd": {kind: pairs}} that one compositing launch's inputs
    need: `table` (n, 9) [mx, my, a, b, c, op, r, g, b], the instance list
    `gauss_ids` (m,) grouped by tile, `tile_offsets` (T + 1,), and the
    forward's per-pixel last composited instance `last` (H, W)."""
    dev = table.device
    px, py, inside = _tile_pixels(width, height, dev)
    starts = tile_offsets[:-1].long()
    counts = tile_offsets[1:].long() - starts
    last_t = _to_tiles(last.long(), -1)
    n = {d: dict.fromkeys(KINDS, 0) for d in ("fwd", "bwd")}
    for g in range(0, px.shape[0], TILE_GROUP):
        s = slice(g, g + TILE_GROUP)
        _group_pairs(n, table, gauss_ids, starts[s], counts[s], last_t[s], px[s], py[s],
                     inside[s])
    return n


def _group_pairs(n, table, gauss_ids, starts, counts, last_t, px, py, inside):
    T = torch.ones_like(px)
    done = ~inside
    for k0 in range(0, int(counts.max()) if counts.numel() else 0, CHUNK):
        kk = k0 + torch.arange(CHUNK, device=table.device)
        valid = kk[None] < counts[:, None]
        idx = starts[:, None] + kk[None]
        gid = gauss_ids[torch.where(valid, idx, torch.zeros_like(idx))].long()
        attrs = torch.where(valid[..., None], table[gid], torch.zeros((), device=table.device))
        mx, my, ca, cb, cc, op = (attrs[..., c:c + 1] for c in range(6))
        dx = px[:, None, :] - mx
        dy = py[:, None, :] - my
        sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
        alpha = torch.clamp_max(op * torch.exp(-sigma), ALPHA_MAX)
        ok = valid[..., None] & (sigma >= 0) & (alpha >= ALPHA_MIN)
        past = valid[..., None] & (sigma > torch.log(255 * op) + 1e-3)
        culled = valid[..., None] & ~past & (sigma < 0)
        a = torch.where(ok, alpha, torch.zeros_like(alpha))
        om = 1.0 - a
        cp = torch.cumprod(om, dim=1)
        T_excl = T[:, None] * torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], 1)
        viol = (a > 0) & (T_excl * om <= T_MIN)
        ended = (torch.cumsum(viol.int(), dim=1) - viol.int()) > 0
        live = valid[..., None] & ~done[:, None] & ~ended
        keep = live & ~viol & (a > 0)
        replay = valid[..., None] & (idx[..., None] <= last_t[:, None, :])
        for d, mask, comp in (("fwd", live, keep), ("bwd", replay, replay & ok)):
            n[d]["cut"] += int((mask & past).sum())
            n[d]["culled"] += int((mask & culled).sum())
            n[d]["composited"] += int(comp.sum())
            n[d]["tested"] += int((mask & ~past & ~culled & ~comp).sum())
        T = T * torch.where(keep, om, torch.ones_like(om)).prod(1)
        done = done | viol.any(1)
        if bool(done.all()):
            break


def pair_ops(pairs: dict, d: str) -> int:
    p = pairs[d]
    return (p["cut"] * OPS_CUT + p["culled"] * OPS_CULLED + p["tested"] * OPS_TESTED
            + p["composited"] * OPS_COMPOSITED[d])


def rasterize_bytes(n_rows: int, m: int, width: int, height: int, d: str) -> int:
    """Bytes a compositing launch must move: the (n, 9) table, the m ids
    and the offsets read; the forward writes image, alpha, T and last (6
    floats a pixel with the 3 channels), the backward reads image, alpha,
    last, v_image and v_alpha (9 a pixel) and writes m (9,) rows."""
    nx, ny = tile_grid(width, height)
    common = n_rows * 9 * 4 + m * 4 + (nx * ny + 1) * 4
    if d == "fwd":
        return common + 12 + 6 * width * height * 4
    return common + 9 * width * height * 4 + m * 9 * 4


def segreduce_bytes(m: int, n: int) -> int:
    """The sorted ids and (m, 9) rows read, the (n, 9) sums written."""
    return m * 4 + m * 36 + n * 36


def fill_bytes(channels: int, slots: int) -> int:
    """Each int32 slot of each channel read once and written once."""
    return 2 * channels * slots * 4
