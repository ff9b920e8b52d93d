"""Each CUDA kernel against its plain PyTorch version, on the card.

Marked ``cuda``; skipped where CUDA is unavailable (a CUDA kernel has no CPU
mode). Run on a machine with the card:
``python -m pytest tests/test_torch_kernels.py --noconftest -q``.
Tolerances: fill, binning and the instance order are exact; segment reduce
is held to 1e-5 of its largest output and to identical output over two
launches; the compositing forward differs by float rounding (the kernel's
FMAs and sequential T against the plain version's cumulative products),
which can flip a pixel's stop decision near T = 1e-4 and change it by about
1e-4 alpha times a colour of up to ~2: 5e-4 absolute, as in chip_smoke.py.
The backward gets the same saved forward from both, so it never re-decides
termination: 1e-4 of the largest row entry.
"""

import numpy as np
import pytest
import torch

from clm_gs_tpu_torch.ops.fill import forward_fill_cuda, forward_fill_plain
from clm_gs_tpu_torch.ops.rasterize import (rasterize_bwd_cuda, rasterize_bwd_plain,
                                            rasterize_fwd_cuda, rasterize_fwd_plain,
                                            tile_grid)
from clm_gs_tpu_torch.ops.segreduce import segment_reduce_cuda, segment_reduce_plain
from clm_gs_tpu_torch.ops.tiles import isect_tiles, tight_extents

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _fill_input(n, c, pattern, seed):
    """(c, n) int32 channels; channel 0 is valid (nonzero) at the slots the
    pattern picks, and the other channels hold junk at invalid slots, which
    the fill must never copy."""
    rng = np.random.RandomState(seed)
    valid = rng.rand(n) < 0.03
    if pattern == "gap":  # invalid across many blocks and past the look-back
        valid[n // 20: n - n // 5] = False
    elif pattern in ("first", "last", "none"):
        valid[:] = False
        if n and pattern != "none":
            valid[0 if pattern == "first" else n - 1] = True
    x = rng.randint(1, 1000, (c, n))
    x[0] = np.where(valid, x[0], 0)
    return x.astype(np.int32)


@pytest.mark.parametrize("n,c,pattern", [
    (1, 3, "random"), (1023, 3, "random"), (1024, 3, "random"),
    (4098, 3, "random"), (5000, 3, "random"), (300_001, 3, "random"),
    (300_003, 1, "random"), (5001, 1, "random"), (6_002, 4, "random"),
    (300_001, 3, "gap"), (300_002, 1, "gap"), (300_002, 3, "first"),
    (200_003, 3, "last"), (100_001, 3, "none"), (0, 3, "random")])
def test_fill(dev, n, c, pattern):
    x = torch.from_numpy(_fill_input(n, c, pattern, n + c)).to(dev)
    want = forward_fill_plain(x)
    assert torch.equal(forward_fill_cuda(x), want)
    assert torch.equal(forward_fill_cuda(x), want)  # a second call, new epoch


def test_segment_reduce(dev):
    rng = np.random.RandomState(0)
    n, m = 5000, 40_000
    ids = torch.from_numpy(np.sort(rng.randint(-2, n + 3, m)).astype(np.int32)).to(dev)
    rows = torch.from_numpy(rng.normal(size=(m, 9)).astype(np.float32)).to(dev)
    got = segment_reduce_cuda(ids, rows, n)
    want = segment_reduce_plain(ids, rows, n)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _seg_ids(case, n, rng):
    if case == "deep":  # one Gaussian of 5,000 rows among shallow ones
        ids = np.concatenate([rng.randint(0, n, 20_000), np.full(5000, n // 3)])
    elif case == "out_of_range":
        ids = np.concatenate([rng.randint(-50, 0, 3000), rng.randint(n, n + 50, 3000)])
    elif case == "empty":
        ids = np.zeros(0, np.int64)
    else:  # shallow runs, some ids out of range
        ids = rng.randint(-2, n + 3, 30_000)
    return np.sort(ids).astype(np.int32)


@pytest.mark.parametrize("case,n", [("deep", 4096), ("deep", 1001), ("out_of_range", 4096),
                                    ("empty", 1001), ("ragged", 1001), ("ragged", 257)])
def test_segment_reduce_cases(dev, case, n):
    """Within 1e-5 of the largest output (the tolerance of chip_smoke.py),
    and identical over two launches. n = 1001 and 257 are not multiples of a
    block's 512 Gaussians; the deep run crosses batches and blocks' searches."""
    rng = np.random.RandomState(n)
    ids = _seg_ids(case, n, rng)
    rows = rng.normal(size=(ids.shape[0], 9)).astype(np.float32)
    ids, rows = torch.from_numpy(ids).to(dev), torch.from_numpy(rows).to(dev)
    got = segment_reduce_cuda(ids, rows, n)
    want = segment_reduce_plain(ids, rows, n)
    assert got.shape == (n, 9)
    assert (got - want).abs().max().item() <= 1e-5 * max(want.abs().max().item(), 1.0)
    assert torch.equal(got, segment_reduce_cuda(ids, rows, n))


def _scene(dev, n=3000, width=300, height=200, seed=0):
    g = np.random.RandomState(seed)
    m2d = np.stack([g.rand(n) * width, g.rand(n) * height], 1)
    s = g.uniform(0.5, 8.0, (n, 2))
    rho = g.uniform(-0.5, 0.5, n)
    cov = np.stack([s[:, 0] ** 2, rho * s[:, 0] * s[:, 1], s[:, 1] ** 2], 1)
    det = cov[:, 0] * cov[:, 2] - cov[:, 1] ** 2
    conics = np.stack([cov[:, 2], -cov[:, 1], cov[:, 0]], 1) / det[:, None]
    radii = np.ceil(3 * s.max(1))
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    return (t(m2d), t(conics), t(g.rand(n, 3)), t(g.uniform(0.05, 0.99, n)),
            t(g.uniform(1, 5, n)), t(radii), width, height)


def _deep_stack(dev, n=2000, width=300, height=200, seed=1):
    """Broad near-opaque splats piled over the image: every pixel terminates
    long before its tile's last instance."""
    g = np.random.RandomState(seed)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    return (t(np.stack([g.rand(n) * width, g.rand(n) * height], 1)),
            t(np.tile([[0.02, 0.0, 0.02]], (n, 1))), t(g.rand(n, 3)),
            t(0.6 + 0.39 * g.rand(n)), t(1 + g.rand(n)), t(np.full(n, 30.0)),
            width, height)


def _ragged(dev):
    """An image whose width and height are multiples of neither 16 nor 64/32:
    sub-tiles and tiles cut by the edge."""
    return _scene(dev, n=2000, width=237, height=115, seed=2)


def _sparse(dev, n=400, width=300, height=200, seed=3):
    """Splats only in the top-left corner: most tiles have no instances."""
    m2d, conics, colors, opac, depths, radii, _, _ = _scene(dev, n, 60, 40, seed)
    return m2d, conics, colors, opac, depths, radii, width, height


def _one_deep_pixel(dev, seed=4):
    """Faint one-pixel splats piled on one pixel behind a few others:
    one sub-tile of its tile walks hundreds of instances deeper than the
    other seven."""
    g = np.random.RandomState(seed)
    m2d, conics, colors, opac, depths, radii, width, height = _scene(
        dev, n=300, width=300, height=200, seed=seed)
    k = 1500
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    pile = (t(np.tile([[20.5, 10.5]], (k, 1)) + g.uniform(-0.2, 0.2, (k, 2))),
            t(np.tile([[2.0, 0.0, 2.0]], (k, 1))), t(g.rand(k, 3)),
            t(g.uniform(0.01, 0.03, k)), t(g.uniform(6, 10, k)), t(np.full(k, 3.0)))
    out = [torch.cat([a, b]) for a, b in
           zip((m2d, conics, colors, opac, depths, radii), pile)]
    return (*out, width, height)


def _binned(dev, make):
    m2d, conics, colors, opac, depths, radii, width, height = make(dev)
    tx, ty = tile_grid(width, height)
    ext = tight_extents(conics, opac, radii)
    isect = isect_tiles(m2d, radii, depths, (64, 32), tx, ty, extents=ext)
    table = torch.cat([m2d, conics, opac[:, None], colors], 1).contiguous()
    return table, isect, width, height


@pytest.mark.parametrize("make", [_scene, _deep_stack, _ragged, _sparse,
                                  _one_deep_pixel])
def test_rasterize_fwd_bwd(dev, make):
    m2d, conics, colors, opac, depths, radii, width, height = make(dev)
    tx, ty = tile_grid(width, height)
    ext = tight_extents(conics, opac, radii)
    isect = isect_tiles(m2d, radii, depths, (64, 32), tx, ty, extents=ext)
    cpu = isect_tiles(*(a.cpu() for a in (m2d, radii, depths)), (64, 32), tx, ty,
                      extents=tuple(e.cpu() for e in ext))
    assert torch.equal(isect.gauss_ids.cpu(), cpu.gauss_ids)
    assert torch.equal(isect.tile_offsets.cpu(), cpu.tile_offsets)
    table = torch.cat([m2d, conics, opac[:, None], colors], 1).contiguous()
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    args = (table, isect.gauss_ids, isect.tile_offsets, bg, width, height)
    k = rasterize_fwd_cuda(*args)
    p = rasterize_fwd_plain(*args)
    torch.testing.assert_close(k[0], p[0], rtol=0, atol=5e-4)
    torch.testing.assert_close(k[1], p[1], rtol=0, atol=5e-4)
    g = torch.Generator(device="cpu").manual_seed(0)
    v_img = torch.randn(3, height, width, generator=g).to(dev)
    v_alpha = torch.randn(height, width, generator=g).to(dev)
    bargs = (table, isect.gauss_ids, isect.tile_offsets, k[0], k[1], k[3],
             v_img, v_alpha, width, height)
    rk = rasterize_bwd_cuda(*bargs)
    rp = rasterize_bwd_plain(*bargs)
    scale = rp.abs().amax(0).clamp_min(1e-6)
    assert ((rk - rp).abs() / scale).max().item() < 1e-4


@pytest.mark.parametrize("make", [_scene, _one_deep_pixel])
def test_rasterize_deterministic(dev, make):
    """Two launches on the same inputs give identical outputs: the backward
    sums each row in a fixed order, without atomics."""
    table, isect, width, height = _binned(dev, make)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    args = (table, isect.gauss_ids, isect.tile_offsets, bg, width, height)
    k = rasterize_fwd_cuda(*args)
    assert all(torch.equal(a, b) for a, b in zip(k, rasterize_fwd_cuda(*args)))
    g = torch.Generator(device="cpu").manual_seed(1)
    bargs = (table, isect.gauss_ids, isect.tile_offsets, k[0], k[1], k[3],
             torch.randn(3, height, width, generator=g).to(dev),
             torch.randn(height, width, generator=g).to(dev), width, height)
    assert torch.equal(rasterize_bwd_cuda(*bargs), rasterize_bwd_cuda(*bargs))
