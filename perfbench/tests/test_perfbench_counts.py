"""The frozen count functions against pairs and bytes counted by hand,
pixel by pixel, on one 64x32 tile."""

import math
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfbench import counts  # noqa: E402


def _by_hand(rows, width, height):
    """Each pixel walks the rows front to back in scalar Python: the kind of
    each (row, pixel) pair, the forward up to the row that ends the pixel,
    and the pixel's last composited row."""
    fwd = dict.fromkeys(counts.KINDS, 0)
    bwd = dict.fromkeys(counts.KINDS, 0)
    lasts = {}
    for y in range(height):
        for x in range(width):
            T, last, kinds = 1.0, -1, []
            for k, (mx, my, a, b, c, op) in enumerate(rows):
                dx, dy = x + 0.5 - mx, y + 0.5 - my
                s = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
                alpha = min(op * math.exp(-s), 0.999)
                if s > math.log(255 * op) + 1e-3:
                    kinds.append("cut")
                    continue
                if s < 0:
                    kinds.append("culled")
                    continue
                if alpha < 1 / 255:
                    kinds.append("tested")
                    continue
                if T * (1 - alpha) <= 1e-4:
                    kinds.append("tested")  # ends the pixel, not composited
                    break
                kinds.append("composited")
                T *= 1 - alpha
                last = k
            for kind in kinds:
                fwd[kind] += 1
            lasts[(x, y)] = last
            for k, (mx, my, a, b, c, op) in enumerate(rows[:last + 1]):
                dx, dy = x + 0.5 - mx, y + 0.5 - my
                s = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
                alpha = min(op * math.exp(-s), 0.999)
                if s > math.log(255 * op) + 1e-3:
                    bwd["cut"] += 1
                elif s < 0:
                    bwd["culled"] += 1
                elif alpha < 1 / 255:
                    bwd["tested"] += 1
                else:
                    bwd["composited"] += 1
    return {"fwd": fwd, "bwd": bwd}, lasts


def test_pairs_on_one_tile():
    W, H = 64, 32
    # three opaque round splats over each other and a faint wide one behind:
    # pixels under the three end there, the rest walk all four
    rows = [(32.0, 16.0, 1 / 64, 0.0, 1 / 64, 1.0), (31.0, 17.0, 1 / 49, 0.0, 1 / 49, 1.0),
            (33.0, 15.0, 1 / 36, 0.001, 1 / 36, 1.0), (40.0, 10.0, 1 / 100, 0.002, 1 / 64, 0.3)]
    want, lasts = _by_hand(rows, W, H)
    table = torch.tensor([list(r) + [0.5, 0.5, 0.5] for r in rows], dtype=torch.float32)
    ids = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    offsets = torch.tensor([0, 4], dtype=torch.int32)
    last = torch.tensor([[lasts[(x, y)] for x in range(W)] for y in range(H)], dtype=torch.int32)
    got = counts.pair_counts(table, ids, offsets, last, W, H)
    assert got == want
    assert sum(want["fwd"].values()) < 4 * W * H  # some pixels ended early
    assert counts.pair_ops(got, "fwd") == (
        want["fwd"]["cut"] * 12 + want["fwd"]["culled"] * 13 + want["fwd"]["tested"] * 17
        + want["fwd"]["composited"] * 28)


def test_bytes_by_hand():
    # 100 rows, 1000 instances, one 64x32 tile (2 offsets)
    assert counts.rasterize_bytes(100, 1000, 64, 32, "fwd") == (
        100 * 36 + 1000 * 4 + 2 * 4 + 12 + 64 * 32 * 24)
    assert counts.rasterize_bytes(100, 1000, 64, 32, "bwd") == (
        100 * 36 + 1000 * 4 + 2 * 4 + 64 * 32 * 36 + 1000 * 36)
    assert counts.segreduce_bytes(1000, 100) == 1000 * 40 + 100 * 36
    assert counts.fill_bytes(3, 1000) == 24000
    assert counts.bound_s(3.35e12, 0) == 1.0
    assert counts.bound_s(0, 67e12) == 1.0
