"""Port vs reference: the BigCity regime (clm_gs_tpu_torch/utils/bigcity.py),
the streaming model loader and clm_offload.prepare_device_loop.

The JAX repo's tools (tools/make_bigcity_scene.py, degrade_ply.py) are loaded
by file path. The scene's arrays and files are equal to theirs to the bit;
the streaming loader equals the JAX package's whole-file loader to the bit;
prepare_device_loop's replay equals the port's own in-situ batch to the bit
(under stop_update_param) and the JAX package's replay within 1e-5
relative. A tiny BigCity run (bsz 12 over 8 training cameras, so that every
batch holds a camera twice) goes through both packages' `train.main`: the
logged losses agree within 2e-6 and the final test PSNR within 1e-3 dB.
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clm_gs_tpu import config as jconfig, optim as joptim
from clm_gs_tpu.data.cameras import stack_cameras as j_stack
from clm_gs_tpu.models import gaussians as jG
from clm_gs_tpu.strategies import clm_offload as j_clm
from clm_gs_tpu.strategies.base import render_one_cam as j_render
from clm_gs_tpu_torch import config as tconfig, convert, optim as toptim
from clm_gs_tpu_torch.data.cameras import stack_cameras as t_stack
from clm_gs_tpu_torch.models import gaussians as tG
from clm_gs_tpu_torch.strategies import clm_offload as t_clm
from clm_gs_tpu_torch.utils import bigcity as B
from clm_gs_tpu_torch.utils.bench_scene import make_camera as t_make_camera
from tests.test_torch_cli import _events, _losses, _unpacked_reference_grads
from tests.test_torch_densify import _jax_state
from tests.test_torch_naive import T_BG, T_LRS, _perturbed_np
from tests.test_torch_native import reference_native
from tests.test_train_synthetic import BG, H, ISECT_CAP, LRS, W, _scene
from tests.utils3d import make_camera

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, CAMS = 20_000, 8
FIELDS = ("xyz", "opacity", "log_scale", "quat", "sh")


def _tool(name):
    """A module of the JAX repo's tools/, loaded by its path."""
    spec = importlib.util.spec_from_file_location(
        f"bigcity_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_tool(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [mod.__file__] + argv)
    mod.main()


@pytest.fixture(scope="module")
def tools():
    return _tool("make_bigcity_scene"), _tool("degrade_ply")


def test_city_matches_tool(tools):
    """The Gaussians equal to the bit, drawn whole by the tool and in row
    chunks by the port; the cameras' poses within 1e-6."""
    make_tool, _ = tools
    want = make_tool.city_gaussians(N, np.random.RandomState(B.SEED))
    got = B.city_gaussians(N, np.random.RandomState(B.SEED), chunk_rows=3_001)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    tc, jc = B.serpentine_cameras(CAMS, 64, 40), make_tool.serpentine_cameras(CAMS, 64, 40)
    assert len(tc) == len(jc) == CAMS
    for t, j in zip(tc, jc):
        assert (t.uid, t.image_name, t.width, t.height) == (j.uid, j.image_name, 64, 40)
        np.testing.assert_allclose(t.viewmat, j.viewmat, atol=1e-6)
        np.testing.assert_allclose(t.K, j.K, atol=1e-6)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def plys(tools, tmp_path_factory):
    """The tool's model PLY and its degraded copy, written once."""
    make_tool, degrade_tool = tools
    d = tmp_path_factory.mktemp("tool")
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("BIGCITY_SKIP_RENDER", "1")
        _run_tool(make_tool, [str(d), str(N), str(CAMS), "64", "40"], mp)
        _run_tool(degrade_tool, [str(d / B.INIT_PLY), str(d / "degraded.ply")], mp)
    finally:
        mp.undo()
    return d / B.INIT_PLY, d / "degraded.ply"


def test_ply_writer_and_degrade_match_tools(plys, tmp_path, monkeypatch):
    """The port's PLY writer (whole and in 7,000-row chunks), degrade_ply
    (in 6,000-row chunks) and make's degraded init are byte-equal to the
    tools' files."""
    model, degraded = plys
    monkeypatch.setenv("BIGCITY_SKIP_RENDER", "1")
    B.make(str(tmp_path / "true"), N, CAMS, 64, 40, degrade=None, device="cpu")
    assert _bytes(tmp_path / "true" / B.INIT_PLY) == _bytes(model)
    arrays = B.city_gaussians(N, np.random.RandomState(B.SEED))
    B.write_model_ply(tmp_path / "chunked.ply", *arrays[:3], arrays[3], arrays[4],
                      chunk_rows=7_000)
    assert _bytes(tmp_path / "chunked.ply") == _bytes(model)
    assert B.degrade_ply(model, tmp_path / "d.ply", chunk_rows=6_000) == N
    assert _bytes(tmp_path / "d.ply") == _bytes(degraded)
    B.make(str(tmp_path / "deg"), N, CAMS, 64, 40, device="cpu")
    assert _bytes(tmp_path / "deg" / B.INIT_PLY) == _bytes(degraded)


@pytest.mark.parametrize("host_sh", [False, True])
def test_streaming_load_matches_reference(plys, host_sh):
    """load_ply in chunks of 3,000 rows (N = 20,000) against the JAX
    package's whole-file load_ply, every row of every field to the bit."""
    _, path = plys
    cap = B.capacity_for(N)
    got = tG.load_ply(str(path), capacity=cap, device="cpu", host_sh=host_sh,
                      chunk_rows=3_000)
    want = jG.load_ply(str(path), capacity=cap, host_sh=host_sh)
    if host_sh:
        (got, got_sh), (want, want_sh) = got, want
        np.testing.assert_array_equal(got_sh.numpy(), np.asarray(want_sh))
        assert tuple(got.params.sh.shape) == (1, 48)
    assert got.n_alive == int(want.n_alive) == N
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))
    for f in FIELDS[:4] + (() if host_sh else ("sh",)):
        g, w = getattr(got.params, f).numpy(), np.asarray(getattr(want.params, f))
        assert g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def test_point_cloud_reader_streams(tmp_path, monkeypatch):
    """utils/plyio.py read_ply_vertices in chunks of 1,000 rows over 2,503
    rows of a binary point cloud, equal to the JAX package's reader."""
    from clm_gs_tpu.utils import plyio as jplyio
    from clm_gs_tpu_torch.utils import plyio as tplyio

    rng = np.random.RandomState(3)
    path = str(tmp_path / "points.ply")
    jplyio.write_ply_points(path, rng.normal(size=(2503, 3)).astype(np.float32),
                            (rng.rand(2503, 3) * 255).astype(np.uint8))
    monkeypatch.setattr(tplyio, "CHUNK_ROWS", 1000)
    got, want = tplyio.read_ply_vertices(path), jplyio.read_ply_vertices(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---- prepare_device_loop ----

N_CAMS = 5


def _five_cameras():
    """test_strategies.py's perturbed scene seen by five cameras, and the
    ground truth of the unperturbed scene."""
    state, _ = _scene()
    cb = j_stack([make_camera(uid=i, width=W, height=H, angle=0.8 * i)
                  for i in range(N_CAMS)])
    gts = np.stack([np.asarray(j_render(state.params, state.alive, cb.viewmats[i],
                                        cb.Ks[i], cb.camera_centers[i], 3, W, H, BG,
                                        ISECT_CAP).image)
                    for i in range(N_CAMS)])
    pert_np, _ = _perturbed_np()
    return pert_np, cb, gts


def _cfg(pkg):
    cfg = pkg.Config()
    cfg.aux.clm_offload = True
    cfg.opt.bsz = N_CAMS
    cfg.opt.lr_scale_mode = "accumu"
    cfg.debug.stop_update_param = True
    cfg.debug.stop_update_param_assert = False
    return pkg.init_config(cfg)


def _jax_replay(state_np, cb, gts):
    cfg = _cfg(jconfig)
    state = _jax_state(state_np)
    ctx = j_clm.make_context(cfg, state, joptim.AdamConfig())
    state = j_clm.strip_device_sh(state)
    run, n_groups = j_clm.prepare_device_loop(state, ctx, cb, jnp.asarray(gts), 3, BG, W,
                                              H, ISECT_CAP, cfg)
    loss, _ = run()
    return float(loss), n_groups


def test_device_loop_replays_the_batch():
    """The replay's last loss equals the in-situ batch's last camera's to
    the bit; two runs give equal losses and accumulators; the staged inputs
    are left as they were; the loss is within 1e-5 relative of the JAX
    package's replay."""
    reference_native()
    state_np, jcb, gts = _five_cameras()
    with _unpacked_reference_grads():
        j_loss, j_groups = _jax_replay(state_np, jcb, gts)
    cfg = _cfg(tconfig)
    state = convert.state_from_numpy(state_np, device="cpu")
    ctx = t_clm.make_context(cfg, state, toptim.AdamConfig())
    state = t_clm.strip_device_sh(state)
    opt = toptim.init_adam(state.params)
    cb = t_stack([t_make_camera(uid=i, width=W, height=H, angle=0.8 * i)
                  for i in range(N_CAMS)], device="cpu")
    gt = torch.from_numpy(gts)
    sh0 = ctx.sh_host.clone()
    try:
        _, _, ctx, out = t_clm.train_one_batch(state, opt, ctx, cb, gt, 3, T_LRS,
                                               toptim.AdamConfig(), T_BG, W, H, cfg)
        run, n_groups = t_clm.prepare_device_loop(state, ctx, cb, gt, 3, T_BG, W, H, cfg)
        loss1, acc1 = run()
        loss2, acc2 = run()
    finally:
        ctx.close()
    assert n_groups == 2 * N_CAMS + 1 and j_groups == 2 * N_CAMS + 2
    assert len(out.losses) == N_CAMS
    assert float(loss1) == float(loss2) == float(out.losses[-1])
    for f in ("g_xyz", "g_opacity", "g_log_scale", "g_quat", "accum", "denom", "vis_any"):
        assert torch.equal(getattr(acc1, f), getattr(acc2, f)), f
    assert acc1.n_isects == acc2.n_isects
    assert torch.equal(ctx.sh_host, sh0)
    np.testing.assert_allclose(float(loss1), j_loss, rtol=1e-5)


# ---- a tiny BigCity run through both packages' main ----

TINY = 4_000


@pytest.fixture(scope="module")
def tiny_scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bigcity") / "scene")
    info = B.make(root, TINY, n_cams=10, width=64, height=40, device="cpu")
    return root, info


def test_tiny_bigcity_run_matches_reference(tiny_scene, tmp_path):
    """BIGCITY_ARGS at bsz 12 over the 8 training cameras of 10 (every batch
    holds a camera twice), --sparse_adam, no densification, 24 iterations:
    the port's losses within 2e-6 of the reference's (the log's 6
    decimals), the final test PSNR within 1e-3 dB, above the degraded init's
    (bigcity.json); the run's record through `collect`. The capacity is 4,096
    rows, not train_args's 65,536, and the reference's instance buffer 8,192
    (the cameras bin at most 3,007 instances): it pads each camera's rows to
    min(capacity, 65,536) and its instances to isect_cap, which its
    interpreted rasterizer walks."""
    from clm_gs_tpu.train import main as jmain
    from clm_gs_tpu_torch.train import main as tmain

    root, info = tiny_scene
    assert info["test_cameras"] == 2 and info["capacity"] == 65_536
    argv = B.train_args(root, "OUT", 24, TINY)
    assert argv[argv.index("--prealloc_capacity") + 1] == "65536"
    extra = ["--bsz", "12", "--log_interval", "1", "--do_not_save",
             "--prealloc_capacity", "4096"]
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    reference_native()
    with _unpacked_reference_grads():
        jmain(B.train_args(root, jout, 24, TINY) + extra + ["--isect_cap", "8192"])
    tmain(B.train_args(root, tout, 24, TINY) + extra, device="cpu")
    jl, tl = _losses(jout), _losses(tout)
    assert len(tl) == len(jl) == 2
    np.testing.assert_allclose(tl, jl, atol=2e-6)
    je, te = ([e for e in _events(o, "eval") if e["split"] == "test"] for o in (jout, tout))
    assert [e["iteration"] for e in te] == [e["iteration"] for e in je] == [13]
    assert abs(te[-1]["psnr"] - je[-1]["psnr"]) < 1e-3
    assert te[-1]["psnr"] > info["init_test_psnr"]
    rec = B.collect(tout)
    assert rec["n_gaussians"] == TINY and rec["capacity"] == 4096
    assert rec["clm_host_state_bytes"] == 768 * 4096
    assert rec["setup_host_peak_gb"] is not None and rec["end2end"]["iterations"] == 24


def test_run_splits_a_batch_and_samples_rss(tiny_scene, tmp_path):
    """`bigcity.run` with --device_loop on the CPU: one batch of 12 (a
    camera twice), the replay's last loss equal to the in-situ batch's to
    the bit, the spans and bytes of the timed batch, and the RSS sampled
    before, within the set-up and over the run."""
    root, _ = tiny_scene
    res = B.run(root, str(tmp_path / "run"), 12, device_loop=True, device="cpu",
                extra=["--bsz", "12", "--do_not_save", "--quiet",
                       "--prealloc_capacity", "4096"])
    loop = res["device_loop"]
    assert loop["replay_equal_to_in_situ"] and loop["unique_cameras"] == 8
    assert loop["n_launch_groups"] == 2 * 12 + 1
    assert loop["batch_h2d_bytes"] > 0 and loop["batch_d2h_bytes"] > 0
    assert {"clm.filters", "clm.micro", "clm.advance"} <= set(loop["batch_spans_ms"])
    assert 0 < res["rss_before_bytes"] <= res["setup_rss_bytes"] <= res["sampled_peak_rss_bytes"]
    assert res["setup_s"] is not None and res["clm_host_state_bytes"] == 768 * 4096


def test_pinned_ab_stores_first_departures(tiny_scene, tmp_path):
    """`bigcity.run --device_loop --pinned_ab` on the CPU: the batch on the
    host path and with --pinned_host from one start, equal to the bit; the
    pinned run's scatter stores its rows' first departures into zero slots
    (more rows stored than added) and the host run's stores none."""
    root, _ = tiny_scene
    res = B.run(root, str(tmp_path / "run"), 12, device_loop=True, pinned_ab=True,
                device="cpu", extra=["--bsz", "12", "--do_not_save", "--quiet",
                                     "--prealloc_capacity", "4096"])
    ab = res["device_loop"]["pinned_ab"]
    assert all(ab["equal"].values()), ab["equal"]
    host, pinned = ab["runs"]["host"], ab["runs"]["pinned"]
    assert host["scatter_rows"] == host["stored_rows"] == 0
    assert pinned["scatter_rows"] > 0
    assert pinned["scatter_rows"] - pinned["stored_rows"] < pinned["stored_rows"]
    assert pinned["d2h_bytes"] == host["d2h_bytes"]
    # the run's log line of bytes each way (host path: nothing stored)
    assert res["transfer_last"]["h2d_bytes_per_batch"] > 0
    assert res["transfer_last"]["d2h_bytes_per_batch"] > 0
    assert res["transfer_last"]["scatter_rows"] == 0
