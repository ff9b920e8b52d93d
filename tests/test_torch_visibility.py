"""clm's visibility pass: csrc/visibility.cu against its plain version.

`offload_common.calculate_filters` takes `visibility_cuda` (one launch a row
chunk for all cameras) for CUDA tensors and `visibility_plain` (the
projection of `ops/projection.py`, a camera at a time) for CPU tensors.

- On the CPU: `camera_table`, built for all cameras at once, equals the
  scalars `_project_one_cam` computes for each camera alone; the CPU takes
  the plain version and launches nothing; the plain version is the
  projection's radii > 0.
- On the card (marked ``cuda``, skipped without one; a CUDA kernel has no
  CPU mode): the kernel's mask equals the plain version's bit for bit at
  B = 1, 4 and 64 and radius_clip 0 and 1.5, on random rows with dead ones
  and on rows placed at the edges (around the near plane, centres just off
  the image by less than their radius, degenerate scales and quaternions);
  `calculate_filters` gives the plain loop's ids, counts and sample with a
  row count that no chunk divides and a nonzero sample phase, one launch a
  chunk. Run on the card with
  ``python -m pytest tests/test_torch_visibility.py --noconftest -q``.
"""

import numpy as np
import pytest
import torch

from clm_gs_tpu_torch import _build
from clm_gs_tpu_torch.ops.projection import _project_one_cam, fully_fused_projection
from clm_gs_tpu_torch.strategies import offload_common as oc


def _cameras(n_cams, width, height, seed):
    """(viewmats (B, 4, 4), Ks (B, 3, 3)) float32: random rotations, centres
    4-8 from the origin facing it, focal lengths and principal points off
    the image centre."""
    rng = np.random.RandomState(seed)
    views, Ks = [], []
    for _ in range(n_cams):
        d = rng.normal(size=3)
        centre = d / np.linalg.norm(d) * rng.uniform(4, 8)
        fwd = -centre / np.linalg.norm(centre) + rng.normal(scale=0.1, size=3)
        fwd /= np.linalg.norm(fwd)
        right = np.cross(rng.normal(size=3), fwd)
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd])  # world -> camera rows
        v = np.eye(4)
        v[:3, :3], v[:3, 3] = R, -R @ centre
        views.append(v)
        f = rng.uniform(0.6, 1.4) * width
        Ks.append([[f, 0, width * rng.uniform(0.4, 0.6)],
                   [0, f * rng.uniform(0.9, 1.1), height * rng.uniform(0.4, 0.6)],
                   [0, 0, 1]])
    return (torch.tensor(np.array(views), dtype=torch.float32),
            torch.tensor(np.array(Ks), dtype=torch.float32))


def _edge_rows(view, K, width, height, rng):
    """Rows at camera `view`'s edges: centres around the near plane, just
    off each image side by less than their radius, at the far plane, and
    degenerate scales and quaternions. Returns (xyz, quat, log_scale)."""
    R, t = view[:3, :3].double().numpy(), view[:3, 3].double().numpy()
    fx, fy, cx, cy = (float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2]))
    cam = []
    k = np.arange(-64, 65)
    cam.append(np.stack([rng.uniform(-1e-3, 1e-3, k.size), rng.uniform(-1e-3, 1e-3, k.size),
                         0.01 + k * 1e-7], 1))  # the near plane
    n = 400
    z = rng.uniform(1, 12, n)
    off = rng.uniform(-40, 40, n)  # pixels past an image side
    v = rng.uniform(0, height, n)
    for u in (off, width + off):  # left and right
        cam.append(np.stack([(u - cx) * z / fx, (v - cy) * z / fy, z], 1))
    u = rng.uniform(0, width, n)
    for vv in (off, height + off):  # top and bottom
        cam.append(np.stack([(u - cx) * z / fx, (vv - cy) * z / fy, z], 1))
    cam.append(np.stack([rng.uniform(-1, 1, 8), rng.uniform(-1, 1, 8),
                         1e10 * (1 + np.linspace(-1e-6, 1e-6, 8))], 1))  # far plane
    cam = np.concatenate(cam)
    xyz = (cam - t) @ R  # R^T (p - t)
    m = len(xyz)
    quat = rng.normal(size=(m, 4))
    # radii of a few pixels to tens at the sides' depths
    log_scale = rng.uniform(-4.5, -1.5, (m, 3))
    # degenerate scales (tiny, subnormal squares, overflowing to inf, zero)
    # and quaternions (zero, huge, tiny) on every 7th row
    bad = np.arange(0, m, 7)
    log_scale[bad] = rng.choice([-100.0, -50.0, -45.0, 44.5, 60.0, 89.0, -np.inf, 3.0],
                                (len(bad), 3))
    quat[bad[::2]] = rng.choice([0.0, 1e20, 1e-30, 1.0], (len(bad[::2]), 4))
    return xyz, quat, log_scale


def _scene(n, n_cams, width, height, seed):
    """Random rows (a tenth dead) with every camera's edge rows mixed in,
    and the cameras: (xyz, quat, log_scale, alive, viewmats, Ks) as CPU
    tensors."""
    rng = np.random.RandomState(seed)
    viewmats, Ks = _cameras(n_cams, width, height, seed + 1)
    parts = [(rng.uniform(-6, 6, (n, 3)), rng.normal(size=(n, 4)),
              rng.uniform(-6, 0.5, (n, 3)))]
    for b in range(min(n_cams, 4)):
        parts.append(_edge_rows(viewmats[b], Ks[b], width, height, rng))
    xyz, quat, log_scale = (np.concatenate(x) for x in zip(*parts))
    perm = rng.permutation(len(xyz))
    alive = rng.rand(len(xyz)) > 0.1
    return (*(torch.tensor(a[perm], dtype=torch.float32) for a in (xyz, quat, log_scale)),
            torch.from_numpy(alive), viewmats, Ks)


# ---- on the CPU ----

def test_camera_table_equals_project_one_cam_scalars():
    """Each column of the table, for all cameras at once, equals the scalar
    `_project_one_cam` computes from one camera (its expressions, 0-d)."""
    W, H = 1237, 822
    viewmats, Ks = _cameras(6, W, H, 3)
    table = oc.camera_table(viewmats, Ks, W, H)
    assert table.dtype == torch.float32 and table.shape == (6, oc.CAM_FLOATS)
    for b in range(6):
        viewmat, K = viewmats[b], Ks[b]
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        tan_fovx = 0.5 * W / fx
        tan_fovy = 0.5 * H / fy
        lim_x_pos = (W - cx) / fx + 0.3 * tan_fovx
        lim_x_neg = cx / fx + 0.3 * tan_fovx
        lim_y_pos = (H - cy) / fy + 0.3 * tan_fovy
        lim_y_neg = cy / fy + 0.3 * tan_fovy
        want = torch.stack([*viewmat[:3, :3].flatten(), *viewmat[:3, 3], fx, fy, cx, cy,
                            -lim_x_neg, lim_x_pos, -lim_y_neg, lim_y_pos])
        assert torch.equal(table[b], want), b


def test_cpu_takes_the_plain_version(monkeypatch):
    """CPU tensors go through `visibility_plain` once a chunk and launch
    nothing; the kernel's wrapper refuses CPU tensors."""
    xyz, quat, log_scale, alive, viewmats, Ks = _scene(3000, 3, 320, 240, 5)
    calls = []
    plain = oc.visibility_plain

    def counted(*a, **k):
        calls.append(a[0].shape[0])
        return plain(*a, **k)

    monkeypatch.setattr(oc, "visibility_plain", counted)
    before = _build.LAUNCHES["visibility"]
    F = oc.calculate_filters(xyz, quat, log_scale, alive, viewmats, Ks, 320, 240, 0.0,
                             chunk_rows=1024)
    n = xyz.shape[0]
    assert calls == [min(1024, n - lo) for lo in range(0, n, 1024)]
    assert _build.LAUNCHES["visibility"] == before
    assert min(F.counts.tolist()) > 0
    cams = oc.camera_table(viewmats, Ks, 320, 240)
    with pytest.raises(ValueError, match="CUDA"):
        oc.visibility_cuda(xyz, quat, log_scale, alive, cams, 320, 240, 0.0)


@pytest.mark.parametrize("radius_clip", [0.0, 1.5])
def test_plain_version_is_the_projections_mask(radius_clip):
    xyz, quat, log_scale, alive, viewmats, Ks = _scene(2000, 3, 320, 240, 6)
    vis = oc.visibility_plain(xyz, quat, log_scale, alive, viewmats, Ks, 320, 240,
                              radius_clip)
    proj = fully_fused_projection(xyz, quat, torch.exp(log_scale), viewmats, Ks, 320, 240,
                                  radius_clip, alive)
    assert torch.equal(vis, proj.radii > 0)
    assert 0 < int(vis.sum()) < vis.numel()
    one = _project_one_cam(xyz, oc.covar_cols(quat, torch.exp(log_scale)), viewmats[0],
                           Ks[0], 320, 240, radius_clip, torch.ones_like(alive))[0] > 0
    assert torch.equal(oc.visibility_plain(xyz, quat, log_scale, None, viewmats[:1],
                                           Ks[:1], 320, 240, radius_clip)[0], one)


# ---- on the card ----

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("radius_clip", [0.0, 1.5])
@pytest.mark.parametrize("n_cams,width,height", [(1, 1600, 900), (4, 1237, 822),
                                                 (64, 1600, 900)])
def test_kernel_equals_plain_version(dev, n_cams, width, height, radius_clip):
    scene = _scene(200_003, n_cams, width, height, 10 + n_cams)
    xyz, quat, log_scale, alive, viewmats, Ks = (t.to(dev) for t in scene)
    cams = oc.camera_table(viewmats, Ks, width, height)
    got = oc.visibility_cuda(xyz, quat, log_scale, alive, cams, width, height,
                             radius_clip)
    want = oc.visibility_plain(xyz, quat, log_scale, alive, viewmats, Ks, width, height,
                               radius_clip)
    assert got.dtype == torch.bool and got.shape == want.shape
    diff = (got != want).nonzero()
    assert len(diff) == 0, f"{len(diff)} (camera, row) pairs differ, first {diff[:5].tolist()}"
    # every kind of outcome occurs, so the mask is no constant
    assert 0 < int(want.sum()) < want.numel()
    # every row alive: the kernel's null `alive`
    assert torch.equal(
        oc.visibility_cuda(xyz, quat, log_scale, None, cams, width, height, radius_clip),
        oc.visibility_plain(xyz, quat, log_scale, None, viewmats, Ks, width, height,
                            radius_clip))


@pytest.mark.cuda
def test_kernel_equals_plain_version_at_the_edges(dev):
    """Only the edge rows of four cameras, so that a differing row is not
    lost among random ones."""
    rng = np.random.RandomState(21)
    viewmats, Ks = _cameras(4, 1600, 900, 22)
    parts = [_edge_rows(viewmats[b], Ks[b], 1600, 900, rng) for b in range(4)]
    xyz, quat, log_scale = (torch.tensor(np.concatenate(x), dtype=torch.float32, device=dev)
                            for x in zip(*parts))
    viewmats, Ks = viewmats.to(dev), Ks.to(dev)
    cams = oc.camera_table(viewmats, Ks, 1600, 900)
    for clip in (0.0, 1.5, 4.0):
        got = oc.visibility_cuda(xyz, quat, log_scale, None, cams, 1600, 900, clip)
        want = oc.visibility_plain(xyz, quat, log_scale, None, viewmats, Ks, 1600, 900,
                                   clip)
        assert torch.equal(got, want), clip
        assert 0 < int(want.sum()) < want.numel()


@pytest.mark.cuda
def test_calculate_filters_equals_the_plain_loop(dev):
    """ids, counts and sample against the plain version over every row at
    once, with chunks that do not divide the rows, a sample phase of 7 and
    one launch a chunk."""
    scene = _scene(100_003, 8, 1237, 822, 31)
    xyz, quat, log_scale, alive, viewmats, Ks = (t.to(dev) for t in scene)
    n, chunk = xyz.shape[0], 1 << 15
    before = _build.LAUNCHES["visibility"]
    F = oc.calculate_filters(xyz, quat, log_scale, alive, viewmats, Ks, 1237, 822, 0.0,
                             sample_phase=7, chunk_rows=chunk)
    assert _build.LAUNCHES["visibility"] - before == -(-n // chunk)
    vis = oc.visibility_plain(xyz, quat, log_scale, alive, viewmats, Ks, 1237, 822, 0.0)
    for b in range(8):
        assert torch.equal(F.ids[b], vis[b].nonzero().flatten().to(torch.int32)), b
    assert F.counts.tolist() == vis.sum(1).tolist()
    assert torch.equal(F.sample, vis[:, 7::oc.SAMPLE_STRIDE])
