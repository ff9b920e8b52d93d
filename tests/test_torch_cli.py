"""Port vs reference: the training CLI and what it reads and writes.

Config parsing, the scene readers, the synthetic scene, PLY and tensor files,
checkpoints, and whole `main` runs of both packages on one synthetic COLMAP
scene (the port on the CPU, through its plain kernel versions). Tolerances
are stated at each comparison.
"""

import contextlib
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from clm_gs_tpu import config as jconfig
from clm_gs_tpu.data import readers as jreaders
from clm_gs_tpu.models import gaussians as jG
from clm_gs_tpu.utils import checkpoint as jckpt
from clm_gs_tpu_torch import config as tconfig, convert
from clm_gs_tpu_torch.data import readers as treaders
from clm_gs_tpu_torch.models import gaussians as tG
from clm_gs_tpu_torch.train import main as tmain
from clm_gs_tpu_torch.utils import checkpoint as tckpt
from clm_gs_tpu_torch.utils.synthetic_colmap import make_dataset as t_make_dataset
from tests.make_synthetic_colmap import (make_blender_dataset, make_city_dataset,
                                         make_dataset)
from tests.test_torch_densify import _densify_inputs, _jax_adam, _jax_state

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("xyz", "opacity", "log_scale", "quat", "sh")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_dataset(str(tmp_path_factory.mktemp("scene")))


def _argv(scene, out, iters=12, extra=()):
    """tests/test_cli_end2end.py's run, no_offload."""
    return [
        "-s", scene, "-m", out, "--no_offload", "--eval", "--llffhold", "5",
        "--bsz", "4", "--iterations", str(iters), "--test_iterations", str(iters),
        "--save_iterations", str(iters), "--densify_from_iter", "4",
        "--densification_interval", "8", "--densify_grad_threshold", "0.0000001",
        "--opacity_reset_interval", "100000", "--isect_cap", "65536",
        "--log_interval", "4", "--lr_scale_mode", "sqrt",
    ] + list(extra)


def _log(out):
    with open(os.path.join(out, "python.log")) as f:
        return f.read()


def _events(out, kind):
    with open(os.path.join(out, "events.jsonl")) as f:
        return [e for e in map(json.loads, f) if e["kind"] == kind]


# ---- config ----

ARGVS = [
    [],
    ["--no_offload"],
    ["-s", "/data/s", "-m", "/out/m", "--naive_offload", "--bsz", "8",
     "--test_iterations", "30000", "7000", "--save_iterations", "5", "5", "1",
     "--iterations", "100", "--densify_grad_threshold", "1e-5", "--eval",
     "--no-end2end_time", "--white_background", "--lr_scale_mode", "linear"],
    ["--clm_offload", "--nsys_profile", "--nsys_profile_start_iter", "7",
     "--decode_dataset_path", "/x", "--do_not_save", "--mesh_shape", "2x2",
     "--isect_cap", "4096", "--gt_device_cache_mb", "0", "-i", "imgs"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_parse_config_matches_reference(argv):
    assert (dataclasses.asdict(tconfig.parse_config(argv))
            == dataclasses.asdict(jconfig.parse_config(argv)))


def test_config_validation_matches_reference():
    for argv in (["--no_offload", "--clm_offload"],
                 ["--dataset_cache_and_stream_mode", "preload"]):
        for pkg in (jconfig, tconfig):
            with pytest.raises(ValueError):
                pkg.parse_config(argv)


# ---- readers ----

def _same_scene(t, j):
    for tc_list, jc_list in ((t.train_cameras, j.train_cameras),
                             (t.test_cameras, j.test_cameras)):
        assert [c.image_name for c in tc_list] == [c.image_name for c in jc_list]
        for tc, jc in zip(tc_list, jc_list):
            assert (tc.uid, tc.width, tc.height, tc.image_path) == (
                jc.uid, jc.width, jc.height, jc.image_path)
            np.testing.assert_array_equal(tc.R, jc.R)
            np.testing.assert_array_equal(tc.T, jc.T)
            assert (tc.fovx, tc.fovy) == (jc.fovx, jc.fovy)
    np.testing.assert_array_equal(t.point_cloud.points, j.point_cloud.points)
    np.testing.assert_array_equal(t.point_cloud.colors, j.point_cloud.colors)
    assert t.nerf_normalization["radius"] == j.nerf_normalization["radius"]
    np.testing.assert_array_equal(t.nerf_normalization["translate"],
                                  j.nerf_normalization["translate"])
    assert t.ply_path == j.ply_path


@pytest.mark.parametrize("eval_split", [False, True])
def test_colmap_reader_matches_reference(scene, eval_split):
    assert treaders.detect_scene_type(scene) == "colmap"
    _same_scene(treaders.read_colmap_scene(scene, eval_split=eval_split, llffhold=3),
                jreaders.read_colmap_scene(scene, eval_split=eval_split, llffhold=3))


def _to_text(sparse):
    """Rewrite a sparse/0 directory's binaries as COLMAP text files."""
    from clm_gs_tpu.data import colmap

    cams = colmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    imgs = colmap.read_images_binary(os.path.join(sparse, "images.bin"))
    xyz, rgb, err = colmap.read_points3d_binary(os.path.join(sparse, "points3D.bin"))
    with open(os.path.join(sparse, "cameras.txt"), "w") as f:
        for c in cams.values():
            f.write(f"{c.id} {c.model} {c.width} {c.height} "
                    + " ".join(repr(float(p)) for p in c.params) + "\n")
    with open(os.path.join(sparse, "images.txt"), "w") as f:
        f.write("# comment\n")
        for im in imgs.values():
            f.write(" ".join(map(str, [im.id, *map(repr, im.qvec.tolist()),
                                       *map(repr, im.tvec.tolist()),
                                       im.camera_id, im.name])) + "\n\n")
    with open(os.path.join(sparse, "points3D.txt"), "w") as f:
        for i in range(len(xyz)):
            f.write(" ".join(map(str, [i, *map(repr, xyz[i].tolist()),
                                       *rgb[i].tolist(), repr(float(err[i]))])) + "\n")
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        os.remove(os.path.join(sparse, name))


@pytest.mark.parametrize("variant", ["text", "dense_ply"])
def test_colmap_text_and_dense_ply_match_reference(scene, tmp_path, variant):
    import shutil

    from clm_gs_tpu.utils.plyio import write_ply_points

    src = str(tmp_path / "s")
    shutil.copytree(scene, src)
    kw = {}
    if variant == "text":
        _to_text(os.path.join(src, "sparse", "0"))
    else:
        rng = np.random.RandomState(2)
        kw["dense_ply_file"] = str(tmp_path / "dense.ply")
        write_ply_points(kw["dense_ply_file"], rng.normal(size=(50, 3)).astype(np.float32),
                         rng.rand(50, 3).astype(np.float32))
    t = treaders.read_colmap_scene(src, eval_split=True, **kw)
    _same_scene(t, jreaders.read_colmap_scene(src, eval_split=True, **kw))
    assert len(t.point_cloud.points) == (50 if kw else 120)


@pytest.mark.parametrize("ocean", [False, True])
def test_city_reader_matches_reference(tmp_path, ocean):
    src = make_city_dataset(str(tmp_path / "city"), ocean=ocean)
    assert treaders.detect_scene_type(src) == jreaders.detect_scene_type(src) == "city"
    ply = os.path.join(src, "point_cloud.ply")
    t = treaders.read_city_scene(src, ply_path=ply, ocean_mask=ocean)
    _same_scene(t, jreaders.read_city_scene(src, ply_path=ply, ocean_mask=ocean))
    assert len(t.train_cameras) == (5 if ocean else 6)


def test_blender_reader_matches_reference(tmp_path):
    src = make_blender_dataset(str(tmp_path / "lego"))
    assert treaders.detect_scene_type(src) == "blender"
    _same_scene(treaders.read_blender_scene(src), jreaders.read_blender_scene(src))


def test_synthetic_scene_matches_the_test_helper(scene, tmp_path):
    """The port's own make_dataset writes the helper's COLMAP files byte for
    byte, and images within 1/255 (the tile rasterizer against the
    reference's dense oracle) at 99% of the pixels."""
    own = t_make_dataset(str(tmp_path / "own"), device="cpu")
    for f in ("cameras.bin", "images.bin", "points3D.bin"):
        with open(os.path.join(own, "sparse", "0", f), "rb") as a, \
                open(os.path.join(scene, "sparse", "0", f), "rb") as b:
            assert a.read() == b.read(), f
    for i in range(10):
        a, b = (np.asarray(Image.open(os.path.join(r, "images", f"img_{i:03d}.png")),
                           np.int16) for r in (own, scene))
        assert np.abs(a - b).max() <= 2 and (np.abs(a - b) <= 1).mean() >= 0.99


# ---- PLY, tensors, checkpoints ----

def _states(seed=0):
    state_np, opt_np = _densify_inputs(seed=seed)
    return (state_np, opt_np, _jax_state(state_np),
            convert.state_from_numpy(state_np, device="cpu"))


def _rows(state):
    """Live rows as numpy, either package's state."""
    alive = np.asarray(state.alive.numpy() if torch.is_tensor(state.alive)
                       else state.alive)
    out = {}
    for f in FIELDS:
        v = getattr(state.params, f)
        out[f] = (v.numpy() if torch.is_tensor(v) else np.asarray(v))[alive]
    return out


def test_ply_files_cross_read_and_are_identical(tmp_path):
    _, _, js, ts = _states()
    tp, jp = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
    tG.save_ply(ts, tp)
    jG.save_ply(js, jp)
    with open(tp, "rb") as a, open(jp, "rb") as b:
        assert a.read() == b.read()
    want = _rows(ts)
    for got in (_rows(jG.load_ply(tp)), _rows(tG.load_ply(jp, device="cpu"))):
        for f in FIELDS:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    back = tG.load_ply(tp, capacity=64, device="cpu")
    assert back.capacity == 64 and back.n_alive == ts.n_alive


def test_chunked_ply_writer_matches_reference(tmp_path):
    _, _, js, ts = _states()
    tG.save_ply(ts, str(tmp_path / "t.ply"), chunk_rows=20)
    jG.save_ply(js, str(tmp_path / "j.ply"), chunk_rows=20)
    names = sorted(os.listdir(tmp_path))
    assert names == sorted([f"{p}_rk{i}_ws3.ply" for p in "tj" for i in range(3)])
    for i in range(3):
        with open(tmp_path / f"t_rk{i}_ws3.ply", "rb") as a, \
                open(tmp_path / f"j_rk{i}_ws3.ply", "rb") as b:
            assert a.read() == b.read()
    total = sum(tG.load_ply(str(tmp_path / f"t_rk{i}_ws3.ply"), device="cpu").n_alive
                for i in range(3))
    assert total == ts.n_alive


def test_loaders_raise_below_the_row_count(tmp_path):
    _, _, _, ts = _states()
    tG.save_ply(ts, str(tmp_path / "m.ply"))
    tG.save_tensors(ts, str(tmp_path / "m.npz"))
    with pytest.raises(ValueError, match="capacity"):
        tG.load_ply(str(tmp_path / "m.ply"), capacity=ts.n_alive - 1, device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        tG.load_tensors(str(tmp_path / "m.npz"), capacity=ts.n_alive - 1,
                        device="cpu")


def test_tensor_files_cross_read(tmp_path):
    _, _, js, ts = _states()
    tG.save_tensors(ts, str(tmp_path / "t.npz"))
    jG.save_tensors(js, str(tmp_path / "j.npz"))
    want = _rows(ts)
    for got in (_rows(jG.load_tensors(str(tmp_path / "t.npz"))),
                _rows(tG.load_tensors(str(tmp_path / "j.npz"), device="cpu"))):
        for f in FIELDS:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_resize_rows_matches_reference():
    _, _, js, ts = _states()
    for coeff in (0.5, 1.7):
        j, t = jG.resize_rows(js, coeff), tG.resize_rows(ts, coeff)
        assert t.capacity == j.capacity and t.n_alive == int(j.n_alive)
        for f in FIELDS:
            np.testing.assert_array_equal(_rows(t)[f], _rows(j)[f])


def test_checkpoint_round_trip(tmp_path):
    state_np, opt_np, js, ts = _states(seed=3)
    opt = convert.adam_from_numpy(opt_np, device="cpu")
    gen = torch.Generator().manual_seed(11)
    torch.rand(5, generator=gen)
    tckpt.save_checkpoint(str(tmp_path), 9, ts, opt, gen)
    expect_next = torch.rand(4, generator=gen)
    s, o, g, it = tckpt.load_checkpoint(tckpt.latest_checkpoint(str(tmp_path)),
                                        device="cpu")
    assert it == 9 and s.n_alive == ts.n_alive
    assert torch.equal(torch.rand(4, generator=g), expect_next)
    want_s, got_s = convert.state_to_numpy(ts), convert.state_to_numpy(s)
    want_o, got_o = convert.adam_to_numpy(opt), convert.adam_to_numpy(o)
    for f in FIELDS:
        np.testing.assert_array_equal(got_s["params"][f], want_s["params"][f])
        for grp in ("mu", "nu"):
            np.testing.assert_array_equal(got_o[grp][f], want_o[grp][f])
    for k in ("alive", "xyz_grad_accum", "denom", "max_radii2d"):
        np.testing.assert_array_equal(got_s[k], want_s[k])
    assert float(o.steps) == 7.0
    # the JAX package's file layout and key names
    jckpt.save_checkpoint(str(tmp_path / "j"), 9, js, _jax_adam(opt_np),
                          jax.random.PRNGKey(0))
    with np.load(tmp_path / "checkpoints" / "9" / "chkpnt.npz") as a, \
            np.load(tmp_path / "j" / "checkpoints" / "9" / "chkpnt.npz") as b:
        assert sorted(a.files) == sorted(b.files)
    # an incomplete newer checkpoint (no meta.json) is skipped
    os.makedirs(tmp_path / "checkpoints" / "13")
    np.savez(tmp_path / "checkpoints" / "13" / "chkpnt.npz", x=np.zeros(1))
    assert tckpt.latest_checkpoint(str(tmp_path)).endswith(os.path.join("checkpoints", "9"))
    assert tckpt.latest_checkpoint(str(tmp_path / "none")) is None


# ---- whole runs ----

@contextlib.contextmanager
def _unpacked_reference_grads():
    """The reference's f32 rasterizer gradients (CLMGS_PACK_GRADS=0)."""
    old = os.environ.get("CLMGS_PACK_GRADS")
    os.environ["CLMGS_PACK_GRADS"] = "0"
    jax.clear_caches()
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("CLMGS_PACK_GRADS")
        else:
            os.environ["CLMGS_PACK_GRADS"] = old
        jax.clear_caches()


def _losses(out):
    return [float(ln.split("loss: ")[1].split()[0])
            for ln in _log(out).splitlines() if " loss: " in ln]


def test_main_matches_reference(scene, tmp_path):
    """JAX main and port main on one scene, 8 iterations at bsz 4 without
    densification: the logged losses (6 decimals) agree to 2e-6, the eval
    PSNRs to 1e-4 dB and the L1s to 1e-5 relative (measured: equal losses,
    1.4e-6 dB, 3e-7)."""
    argv = ["-s", scene, "--no_offload", "--eval", "--llffhold", "5", "--bsz", "4",
            "--iterations", "8", "--disable_auto_densification",
            "--test_iterations", "8", "--log_interval", "1",
            "--isect_cap", "65536", "--do_not_save"]
    from clm_gs_tpu.train import main as jmain

    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    with _unpacked_reference_grads():
        jmain(argv + ["-m", jout])
    tmain(argv + ["-m", tout], device="cpu")
    jl, tl = _losses(jout), _losses(tout)
    assert len(tl) == len(jl) == 2
    np.testing.assert_allclose(tl, jl, atol=2e-6)
    je, te = _events(jout, "eval"), _events(tout, "eval")
    assert [(e["iteration"], e["split"]) for e in te] == [
        (e["iteration"], e["split"]) for e in je]
    np.testing.assert_allclose([e["psnr"] for e in te], [e["psnr"] for e in je],
                               atol=1e-4)
    np.testing.assert_allclose([e["l1"] for e in te], [e["l1"] for e in je],
                               rtol=1e-5)


def test_cli_full_run(scene, tmp_path):
    """test_cli_end2end.py::test_cli_full_run's run and checks, on the port."""
    out = str(tmp_path / "run")
    state, _ = tmain(_argv(scene, out), device="cpu")
    log = _log(out)
    assert "Evaluating test:" in log and "Evaluating train:" in log
    assert "end2end total_time:" in log and "densify_and_prune" in log
    evals = _events(out, "eval")
    assert evals and all(np.isfinite(e["psnr"]) and e["psnr"] > 5 for e in evals)
    with open(os.path.join(out, "cameras.json")) as f:
        cams = json.load(f)
    assert len(cams) == 10 and all(
        set(c) == {"id", "img_name", "width", "height", "position", "rotation",
                   "fx", "fy"} for c in cams)
    ply = os.path.join(out, "point_cloud", "iteration_12", "point_cloud.ply")
    st = jG.load_ply(ply)
    assert int(st.n_alive) == state.n_alive > 120  # densification grew the model
    got, want = _rows(tG.load_ply(ply, device="cpu")), _rows(state)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], want[f])
    from release_scripts.log2csv import from_events, from_log

    for m in (from_events(os.path.join(out, "events.jsonl")),
              from_log(os.path.join(out, "python.log"))):
        assert m["test_psnr"] is not None and m["total_time_s"] is not None
        assert m["num_3dgs"] == state.n_alive
    csv_path = str(tmp_path / "r.csv")
    subprocess.run([sys.executable, os.path.join(ROOT, "release_scripts", "log2csv.py"),
                    out, "-o", csv_path], check=True, capture_output=True)
    with open(csv_path) as f:
        assert len(f.read().splitlines()) == 2


def test_resume_and_resize_on_resume(scene, tmp_path):
    out = str(tmp_path / "ckpt_run")
    tmain(_argv(scene, out, iters=8, extra=["--checkpoint_iterations", "4",
                                            "--do_not_save"]), device="cpu")
    ck = tckpt.latest_checkpoint(out)
    assert ck is not None and ck.endswith(os.path.join("checkpoints", "5"))
    n_ckpt = json.load(open(os.path.join(ck, "meta.json")))["n_alive"]
    for coeff, want_rows in (("1.0", None), ("0.5", n_ckpt // 2)):
        out2 = str(tmp_path / f"resume_{coeff}")
        state, opt = tmain([
            "-s", scene, "-m", out2, "--no_offload", "--bsz", "4",
            "--iterations", "8", "--start_checkpoint", ck, "--do_not_save",
            "--disable_auto_densification", "--drop_duplicate_gaussians_coeff", coeff,
        ], device="cpu")
        log = _log(out2)
        assert f"Resumed from {ck} at iteration 5" in log
        assert "end2end total_time:" in log and "iterations: 4," in log
        if want_rows is not None:
            assert f"drop_duplicate_gaussians: resized to {want_rows} rows" in log
            assert state.n_alive == want_rows and float(opt.steps) == 1.0
        else:
            assert float(opt.steps) == 2.0  # restored moments and step count


def test_auto_resume_appends_to_the_log(scene, tmp_path):
    out = str(tmp_path / "auto")
    args = _argv(scene, out, iters=8, extra=["--checkpoint_iterations", "4",
                                             "--do_not_save"])
    tmain(args, device="cpu")
    tmain(args + ["--auto_start_checkpoint"], device="cpu")
    log = _log(out)
    assert log.count("end2end total_time:") == 2 and "Resumed from" in log


def test_opacity_reset_mid_run(scene, tmp_path):
    out = str(tmp_path / "reset")
    tmain(_argv(scene, out, extra=["--opacity_reset_interval", "8",
                                   "--do_not_save"]), device="cpu")
    log = _log(out)
    assert "iteration[5,9) reset_opacity" in log and "end2end total_time:" in log
    evals = _events(out, "eval")
    assert evals and all(np.isfinite(e["psnr"]) for e in evals)


@pytest.mark.parametrize("enabled", [True, False])
def test_timer_spans(scene, tmp_path, enabled):
    """--enable_timer reports one span per call of the loop, so that a run's
    time splits by them (chip_smoke.py's cli phase); without it, none. The
    run grows past a small first capacity, resets opacity, evaluates, saves
    and checkpoints once each."""
    out = str(tmp_path / "timed")
    tmain(_argv(scene, out, extra=[
        "--opacity_reset_interval", "8", "--checkpoint_iterations", "4",
        "--prealloc_capacity", "130"] + (["--enable_timer"] if enabled else [])),
        device="cpu")
    log = _log(out)
    spans = {ln.split(": sum ")[0]: int(ln.split(" ms over ")[1].split()[0])
             for ln in log.splitlines() if ": sum " in ln and " ms over " in ln}
    assert "capacity 130 -> " in log and "end2end total_time:" in log
    if not enabled:
        assert spans == {}
        return
    assert spans == {"data_next": 3, "stack_cameras": 3, "train_step": 3, "log": 4,
                     "eval": 1, "count_densify": 1, "grow_capacity": 1, "densify": 1,
                     "reset_opacity": 1, "save": 1, "checkpoint": 1}


def test_profile_background_and_saved_eval_images(scene, tmp_path):
    """--profile writes a torch.profiler trace; --random_background draws from
    the run's generator; saved eval images at --eval_res_cap's size."""
    out = str(tmp_path / "opts")
    tmain(_argv(scene, out, iters=8, extra=[
        "--do_not_save", "--profile", "--profile_start_iter", "5",
        "--random_background", "--num_save_images_during_eval", "1",
        "--eval_res_cap", "48"]), device="cpu")
    assert os.path.getsize(os.path.join(out, "profile", "trace.json")) > 0
    assert "profiler trace written to" in _log(out)
    img = Image.open(os.path.join(out, "eval_images", "5", "test_img_000_render.png"))
    assert img.size == (48, 32)
    evals = _events(out, "eval")
    assert len(evals) == 2 and all(np.isfinite(e["psnr"]) for e in evals)


def test_stop_update_param(scene, tmp_path):
    """--stop_update_param keeps the parameters as loaded (the tripwire
    checks it at each log line); it refuses to run with densification."""
    out = str(tmp_path / "frozen")
    args = _argv(scene, out, iters=8, extra=["--do_not_save", "--stop_update_param",
                                             "--log_interval", "1"])
    state, opt = tmain(args + ["--disable_auto_densification"], device="cpu")
    assert float(opt.steps) == 0.0 and _log(out).count(" loss: ") == 2
    with pytest.raises(ValueError, match="stop_update_param"):
        tmain(args, device="cpu")
