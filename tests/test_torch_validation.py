"""Port vs reference: the JAX repo's validation runs (the 30k strategy parity,
the flagship quality run, the 4K bench step), the names of the JAX package
that no entry point reaches, and the host RSS the training log records.

The JAX repo's tools (tools/parity30k.py, collect_parity.py,
make_flagship_scene.py, flagship_run.py, collect_quality.py) are loaded by
file path. Their training commands are captured by monkeypatching
`clm_gs_tpu.train.main` and equal the port's; the flagship scene's COLMAP
files are byte-equal to the tool's and its ground truth within one level;
the port's collectors give the tools' records on the same run directories;
the 4K binning equals the JAX package's; each ported name matches its JAX
function within the tolerance its case states.
"""

import importlib.util
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from clm_gs_tpu.data import cameras as jcams
from clm_gs_tpu.data.cameras import stack_cameras as j_stack
from clm_gs_tpu.ops import projection as jproj, sh as jsh, ssim as jssim, tiles as jtiles
from clm_gs_tpu.utils import general as jgeneral, plyio as jplyio
from clm_gs_tpu_torch import train as T
from clm_gs_tpu_torch.data import cameras as tcams
from clm_gs_tpu_torch.ops import projection as tproj, sh as tsh, ssim as tssim
from clm_gs_tpu_torch.ops import tiles as ttiles
from clm_gs_tpu_torch.utils import bench4k as B4, flagship as F, general as tgeneral
from clm_gs_tpu_torch.utils import parity30k as P, plyio as tplyio
from clm_gs_tpu_torch.utils.bench_scene import _surface_gaussians
from clm_gs_tpu_torch.utils.synthetic_colmap import make_dataset
from tests.utils3d import make_camera

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name):
    """A module of the JAX repo's tools/, loaded by its path."""
    spec = importlib.util.spec_from_file_location(
        f"validation_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_tool(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [mod.__file__] + [str(a) for a in argv])
    mod.main()


def _captured_argv(mod, argv, monkeypatch):
    """The argv a tool hands clm_gs_tpu.train.main."""
    import clm_gs_tpu.train

    got = []
    monkeypatch.setattr(clm_gs_tpu.train, "main", lambda a: got.append(list(a)))
    _run_tool(mod, argv, monkeypatch)
    assert len(got) == 1
    return got[0]


# ---- the training commands ----

@pytest.mark.parametrize("strategy", P.STRATEGIES)
def test_parity_argv_matches_tool(strategy, tmp_path, monkeypatch):
    os.makedirs(tmp_path / "scene" / "sparse")  # the tool builds no scene
    want = _captured_argv(_tool("parity30k"), [strategy, 30000, tmp_path], monkeypatch)
    got = P.train_argv(strategy, 30000, P.scene_dir(str(tmp_path)),
                       P.run_dir(str(tmp_path), strategy))
    assert got == want
    assert got[got.index("--test_iterations") + 1:][:2] == ["1000", "2000"]


@pytest.mark.parametrize("seed", [None, 4])
def test_parity_seed_runs_into_its_own_directory(seed, tmp_path, monkeypatch):
    """`run --seed S` trains into run_STRATEGY_sS with the tool's command
    and --seed S after it (the scene stays seed 3's); without a seed, the
    tool's command into run_STRATEGY."""
    os.makedirs(tmp_path / "scene" / "sparse")
    calls = []
    monkeypatch.setattr(P, "train_run",
                        lambda argv, out, name, device: calls.append((argv, out)) or {})
    monkeypatch.setattr(P, "parse_run", lambda d: {"reached_iter": None})
    rec = P.run(str(tmp_path), "naive_offload", 30000, device="cpu", seed=seed)
    (argv, out), = calls
    base = P.train_argv("naive_offload", 30000, P.scene_dir(str(tmp_path)), out)
    if seed is None:
        assert out == str(tmp_path / "run_naive_offload") and argv == base
    else:
        assert out == str(tmp_path / "run_naive_offload_s4")
        assert argv == base + ["--seed", "4"]
    assert rec["seed"] == seed and rec["strategy"] == "naive_offload"


@pytest.mark.parametrize("iters", [15000, 2000])
def test_flagship_argv_matches_tool(iters, tmp_path, monkeypatch):
    scene, out = str(tmp_path / "scene"), str(tmp_path / "run")
    want = _captured_argv(_tool("flagship_run"), [iters, scene, out], monkeypatch)
    got = F.train_argv(iters, scene, out)
    assert got == want
    assert got[got.index("--densify_until_iter") + 1] == str(min(9000, int(iters * 0.6)))


# ---- the flagship scene ----

def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_flagship_scene_matches_tool(tmp_path, monkeypatch):
    """3,000 Gaussians, 8 cameras of 96x64, 500 init points: the COLMAP
    files byte-equal, the ground truth within one level."""
    monkeypatch.setenv("FLAGSHIP_INIT_POINTS", "500")
    monkeypatch.setenv("FLAGSHIP_ISECT", str(2**16))
    tool = tmp_path / "tool"
    _run_tool(_tool("make_flagship_scene"), [tool, 3000, 8, 96, 64], monkeypatch)
    port = tmp_path / "port"
    info = F.make(str(port), n=3000, n_cams=8, width=96, height=64, n_init=500, device="cpu")
    assert (info["n"], info["capacity"], info["n_init"]) == (3000, 65536, 500)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert _bytes(port / "sparse" / "0" / name) == _bytes(tool / "sparse" / "0" / name)
    names = sorted(os.listdir(tool / "images"))
    assert names == sorted(os.listdir(port / "images")) and len(names) == 8
    for n in names:
        a = np.asarray(Image.open(port / "images" / n)).astype(np.int32)
        b = np.asarray(Image.open(tool / "images" / n)).astype(np.int32)
        assert a.shape == (64, 96, 3) and a.std() > 5
        assert np.abs(a - b).max() <= 1


# ---- the collectors, on the same tiny CPU runs ----

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three strategies on the small synthetic scene: the parity
    schedule's grammar at 16 iterations (evals every 8, densification every
    4 and an opacity reset), each run's RUN_INFO written by `train_run`."""
    root = tmp_path_factory.mktemp("parity")
    scene = make_dataset(str(root / "scene"), device="cpu")
    for s in P.STRATEGIES:
        argv = P.train_argv(s, 16, scene, P.run_dir(str(root), s))
        # below 1,000 iterations the tool's eval list is empty
        argv.insert(argv.index("--test_iterations") + 1, "8")
        argv += ["--densify_from_iter", "4",
                 "--densification_interval", "4", "--densify_grad_threshold", "1e-7",
                 "--opacity_reset_interval", "12", "--llffhold", "5"]
        P.train_run(argv, P.run_dir(str(root), s), P.RUN_INFO, "cpu")
    return root


def _load(path):
    with open(path) as f:
        return json.load(f)


def test_parity_collect_matches_tool(runs, tmp_path, monkeypatch):
    dirs = [P.run_dir(str(runs), s) for s in P.STRATEGIES]
    _run_tool(_tool("collect_parity"), [tmp_path / "tool.json", *dirs], monkeypatch)
    want = _load(tmp_path / "tool.json")
    got = P.collect(str(tmp_path / "port.json"), dirs)
    assert got == _load(tmp_path / "port.json")
    for k in want:
        if k != "runs":
            assert got[k] == want[k], k
    assert sorted(got["runs"]) == sorted(want["runs"])
    for s, rec in want["runs"].items():
        assert {k: got["runs"][s][k] for k in rec} == rec
        assert rec["reached_iter"] == 16 and rec["n_densify_events"] >= 2
        rss = got["runs"][s]["rss_gb_at_eval"]
        assert sorted(rss, key=int) == sorted(rec["test_psnr"], key=int)
        assert all(v > 0 for v in rss.values())
    assert got["pairwise_at_milestones"]["clm_offload|naive_offload"]
    # an earlier record's runs are merged in, as the tool merges them
    _run_tool(_tool("collect_parity"), [tmp_path / "tool2.json", tmp_path / "tool.json"],
              monkeypatch)
    merged = P.collect(str(tmp_path / "port2.json"), [str(tmp_path / "tool.json")])
    assert merged["runs"] == _load(tmp_path / "tool2.json")["runs"]


def test_quality_collect_matches_tool(runs, tmp_path, monkeypatch):
    d = P.run_dir(str(runs), "no_offload")
    _run_tool(_tool("collect_quality"), [d, tmp_path / "tool.json", "tiny"], monkeypatch)
    want = _load(tmp_path / "tool.json")
    got = F.collect(d, str(tmp_path / "port.json"), "tiny")
    got = _load(tmp_path / "port.json")
    # the tool's scene label is a literal of its own scene; the port's is
    # composed from the scene's flagship.json (absent here)
    for k in want:
        if k != "scene":
            assert got[k] == want[k], k
    assert got["host_gb_final"] > 0 and got["densification"]["opacity_reset_iters"]
    assert all(v > 0 for v in got["rss_gb_at_eval"].values())


# ---- the 4K binning ----

def test_4k_binning_matches_reference():
    """3,000 bench-scene Gaussians seen at 3840x2160 (60x68 tiles of
    64x32): the port's isect_tiles equals the JAX package's."""
    w, h = 3840, 2160
    xyz, log_scale, quat, opacity, _ = _surface_gaussians(3000, np.random.RandomState(0))
    cb = j_stack([make_camera(width=w, height=h, dist=6.0)])
    proj = jproj.fully_fused_projection(jnp.asarray(xyz), jnp.asarray(quat),
                                        jnp.exp(jnp.asarray(log_scale)), cb.viewmats,
                                        cb.Ks, w, h)
    m2d, conics, depths, radii = (np.array(a[0]) for a in (
        proj.means2d, proj.conics, proj.depths, proj.radii))
    opac = (1.0 / (1.0 + np.exp(-opacity))).astype(np.float32)
    tw, th = -(-w // 64), -(-h // 32)
    assert (tw, th) == (60, 68) and max(tw, th) < ttiles.GEO_AXIS_LIMIT
    ext = tuple(np.array(e) for e in jtiles.tight_extents(
        jnp.asarray(conics), jnp.asarray(opac), jnp.asarray(radii)))
    cap = 2**19
    ref = jtiles.isect_tiles(jnp.asarray(m2d), jnp.asarray(radii), jnp.asarray(depths),
                             (64, 32), tw, th, cap, extents=tuple(map(jnp.asarray, ext)))
    n_ref = int(ref.n_isects)
    assert 3000 < n_ref < cap
    got = ttiles.isect_tiles(torch.from_numpy(m2d), torch.from_numpy(radii),
                             torch.from_numpy(depths), (64, 32), tw, th,
                             extents=tuple(map(torch.from_numpy, ext)))
    assert got.n_isects == n_ref
    np.testing.assert_array_equal(got.gauss_ids.numpy(), np.asarray(ref.gauss_ids)[:n_ref])
    np.testing.assert_array_equal(got.tile_offsets.numpy(), np.asarray(ref.tile_offsets))


# ---- the 4K bench step's entry ----

def test_bench4k_main_on_cpu(tmp_path):
    out = tmp_path / "bench.json"
    rec = B4.main(["--out", str(out), "--width", "128", "--height", "96", "--n", "500",
                   "--cap", "512"], device="cpu")
    assert _load(out) == rec
    assert (rec["resolution"], rec["tiles"], rec["tile_grid"]) == (
        "128x96", "2x3 (64x32 px)", [2, 3])
    assert rec["tiles_per_axis_limit"] == ttiles.GEO_AXIS_LIMIT == 512
    assert (rec["n_gaussians"], rec["capacity"], rec["cameras"]) == (500, 512, 4)
    assert rec["mpix_s"] == pytest.approx(3 * 4 * 128 * 96 / rec["sec_per_batch"] / 3 / 1e6)
    assert len(rec["n_isects"]) == 4 and min(rec["n_isects"]) > 0
    assert all(np.isfinite(rec["losses"])) and all(np.isfinite(rec["warm_losses"]))
    assert rec["peak_device_bytes"] is None and rec["host_peak_bytes"] > 0
    assert rec["card"] is None and rec["device"] == "cpu"
    with pytest.raises(SystemExit):  # --out is required: no default path
        B4.main([], device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the missing card")
@pytest.mark.parametrize("entry", [
    lambda d: B4.main(["--out", str(d / "b.json"), "--n", "10", "--cap", "16"]),
    lambda d: P.main(["make", str(d / "p")]),
    lambda d: F.main(["make", str(d / "f"), "--n", "10", "--cams", "2"]),
])
def test_entries_raise_without_a_card(entry, tmp_path):
    """The card is the default; without one the entries raise and do not
    move to the CPU."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry(tmp_path)


# ---- the host RSS ----

def test_host_rss_reads_proc(monkeypatch):
    """train._host_gb reads /proc (utils/general.rss_bytes): psutil's RSS
    here, and above 0 where psutil is missing."""
    psutil = pytest.importorskip("psutil")
    a = T._host_gb()
    b = psutil.Process().memory_info().rss / 2**30
    assert abs(a - b) <= max(0.01 * b, 16 / 1024)
    monkeypatch.setitem(sys.modules, "psutil", None)
    assert T._host_gb() > 0


# ---- the names no entry point reaches ----

def _rng():
    return np.random.RandomState(4)


def _quats_scales():
    r = _rng()
    return (r.normal(size=(50, 4)).astype(np.float32),
            np.exp(r.uniform(-3, -1, (50, 3))).astype(np.float32))


def _covar():
    q, s = _quats_scales()
    return (tproj.quat_scale_to_covar(torch.from_numpy(q), torch.from_numpy(s)).numpy(),
            np.asarray(jproj.quat_scale_to_covar(jnp.asarray(q), jnp.asarray(s))), 1e-6)


def _visibility():
    r = _rng()
    xyz = r.uniform(-1.5, 1.5, (200, 3)).astype(np.float32)
    q, _ = _quats_scales()
    q = np.tile(q, (4, 1))
    s = np.exp(r.uniform(-3.5, -2.0, (200, 3))).astype(np.float32)
    alive = r.rand(200) < 0.9
    cams = [make_camera(width=64, height=48, angle=a) for a in (0.0, 1.3)]
    jcb = j_stack(cams)
    tcb = tcams.stack_cameras([tcams.Camera(c.uid, c.image_name, c.width, c.height, c.R,
                                            c.T, c.fovx, c.fovy) for c in cams], "cpu")
    got = tproj.visibility_mask(torch.from_numpy(xyz), torch.from_numpy(q),
                                torch.from_numpy(s), tcb.viewmats, tcb.Ks, 64, 48,
                                alive=torch.from_numpy(alive)).numpy()
    want = np.asarray(jproj.visibility_mask(jnp.asarray(xyz), jnp.asarray(q),
                                            jnp.asarray(s), jcb.viewmats, jcb.Ks, 64, 48,
                                            alive=jnp.asarray(alive)))
    assert got.shape == (2, 200) and 0 < got.sum() < got.size
    return got, want, 0


def _eval_color():
    r = _rng()
    means = r.normal(size=(60, 3)).astype(np.float32)
    campos = np.array([0.3, -0.2, 4.0], np.float32)
    coeffs = r.normal(size=(60, 16, 3)).astype(np.float32)
    return (tsh.eval_color(3, torch.from_numpy(means), torch.from_numpy(campos),
                           torch.from_numpy(coeffs)).numpy(),
            np.asarray(jsh.eval_color(3, jnp.asarray(means), jnp.asarray(campos),
                                      jnp.asarray(coeffs))), 1e-5)


def _sh_color_flat():
    r = _rng()
    basis = r.normal(size=(60, 16)).astype(np.float32)
    flat = r.normal(size=(60, 48)).astype(np.float32)
    return (tsh.sh_color_flat(torch.from_numpy(basis), torch.from_numpy(flat)).numpy(),
            np.asarray(jsh.sh_color_flat(jnp.asarray(basis), jnp.asarray(flat))), 1e-5)


def _sh_vjp_coeffs():
    r = _rng()
    dirs = r.normal(size=(60, 3)).astype(np.float32)
    v = r.normal(size=(60, 3)).astype(np.float32)
    return (tsh.spherical_harmonics_vjp_coeffs(2, torch.from_numpy(dirs),
                                               torch.from_numpy(v)).numpy(),
            np.asarray(jsh.spherical_harmonics_vjp_coeffs(2, jnp.asarray(dirs),
                                                          jnp.asarray(v))), 1e-5)


def _drop_duplicates():
    """Rows with duplicates (exact, and equal after rounding at coeff 10)."""
    r = _rng()
    xyz = r.normal(size=(50, 3)).astype(np.float32)
    xyz[[7, 31]] = xyz[3]
    xyz[40] = xyz[12] + 1e-8
    got = tgeneral.drop_duplicate_gaussians(torch.from_numpy(xyz), 10.0)
    want = jgeneral.drop_duplicate_gaussians(xyz, 10.0)
    assert len(want) < 50
    return got, want, 0


def _masked(name):
    def case():
        r = _rng()
        img = r.rand(3, 24, 20).astype(np.float32)
        gt = r.rand(3, 24, 20).astype(np.float32)
        mask = (r.rand(24, 20) < 0.6).astype(np.float32)
        got = getattr(tssim, name)(*map(torch.from_numpy, (img, gt, mask)))
        want = getattr(jssim, name)(*map(jnp.asarray, (img, gt, mask)))
        return got.numpy(), np.asarray(want), 1e-5
    return case


def _nudge():
    c = make_camera(width=64, height=48, angle=0.7)
    tc = tcams.Camera(c.uid, c.image_name, c.width, c.height, c.R, c.T, c.fovx, c.fovy)
    got = tcams.nudge_camera(tc, 0.1, -0.2, 0.3)
    want = jcams.nudge_camera(c, 0.1, -0.2, 0.3)
    assert isinstance(got, tcams.Camera)
    return (np.concatenate([got.viewmat.ravel(), got.K.ravel(), got.camera_center]),
            np.concatenate([want.viewmat.ravel(), want.K.ravel(), want.camera_center]), 1e-9)


def _minicam():
    vm = make_camera(width=80, height=60, angle=2.1).viewmat
    got = tcams.MiniCam(80, 60, 0.8, 0.6, vm)
    want = jcams.MiniCam(80, 60, 0.8, 0.6, vm)
    assert (got.znear, got.zfar) == (want.znear, want.zfar)
    return (np.concatenate([got.K.ravel(), got.camera_center]),
            np.concatenate([want.K.ravel(), want.camera_center]), 0)


def _ply_points(tmp_path):
    r = _rng()
    pts = r.normal(size=(37, 3)).astype(np.float32)
    cols = r.uniform(-0.1, 1.1, (37, 3))
    out = []
    for colors in (cols, None):
        tplyio.write_ply_points(tmp_path / "t.ply", pts, colors)
        jplyio.write_ply_points(tmp_path / "j.ply", pts, colors)
        out.append((_bytes(tmp_path / "t.ply"), _bytes(tmp_path / "j.ply")))
    got, want = zip(*out)
    return np.frombuffer(b"".join(got), np.uint8), np.frombuffer(b"".join(want), np.uint8), 0


def _general(name):
    def case():
        r = _rng()
        q, s = _quats_scales()
        if name == "build_scaling_rotation":
            args = (s, q)
        elif name == "strip_symmetric":
            m = r.normal(size=(5, 3, 3)).astype(np.float32)
            args = (m + m.transpose(0, 2, 1),)
        else:
            args = (q,)
        if name == "np_sigmoid":
            x = r.normal(size=(40,)) * 5
            return tgeneral.np_sigmoid(x), jgeneral.np_sigmoid(x), 0
        got = getattr(tgeneral, name)(*map(torch.from_numpy, args)).numpy()
        return got, np.asarray(getattr(jgeneral, name)(*map(jnp.asarray, args))), 1e-6
    return case


NAMES = {
    "quat_scale_to_covar": _covar,
    "visibility_mask": _visibility,
    "eval_color": _eval_color,
    "sh_color_flat": _sh_color_flat,
    "spherical_harmonics_vjp_coeffs": _sh_vjp_coeffs,
    "drop_duplicate_gaussians": _drop_duplicates,
    **{n: _masked(n) for n in ("l1_loss_pixelwise_masked", "ssim_masked",
                               "pixelwise_l1_with_mask", "pixelwise_ssim_with_mask")},
    "nudge_camera": _nudge,
    "MiniCam": _minicam,
    "write_ply_points": _ply_points,
    **{n: _general(n) for n in ("build_scaling_rotation", "strip_symmetric",
                                "quat_normalize", "np_sigmoid")},
}


@pytest.mark.parametrize("name", sorted(NAMES))
def test_unreached_names_match_reference(name, tmp_path):
    """Each name against its JAX function on seeded numpy inputs: the
    largest absolute difference within the case's tolerance (0: equal;
    write_ply_points: the files' bytes)."""
    case = NAMES[name]
    got, want, tol = case(tmp_path) if name == "write_ply_points" else case()
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if tol == 0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, np.abs(want).max()))
