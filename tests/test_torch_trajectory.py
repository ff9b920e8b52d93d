"""Port vs reference: the trajectory renderer (clm_gs_tpu/render_trajectory.py).

The path helpers take the same numpy inputs in both packages and agree to
1e-6. The renderers load the same files (a PLY written by the port's
`create_from_pcd`, a tensor file, or a run trained by the port's CLI through
--model_dir) and render 2 frames of 64x64 on the CPU, the reference's Pallas
forward through the interpreter: the PNG frames agree within one level of
255 (the two forwards differ by float rounding, which can move a value
across a level boundary).
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from clm_gs_tpu import render_trajectory as jRT
from clm_gs_tpu_torch import render_trajectory as tRT
from clm_gs_tpu_torch.models import gaussians as tG

STRATEGIES = ("--no_offload", "--naive_offload", "--clm_offload")
FRAME_ARGS = ["--num_frames", "2", "--width", "64", "--height", "64"]


def _frames(d):
    names = sorted(os.listdir(d))
    return names, [np.asarray(Image.open(os.path.join(d, n))).astype(np.int32)
                   for n in names]


def _assert_frames_agree(port_dir, ref_dir):
    names, got = _frames(port_dir)
    ref_names, ref = _frames(ref_dir)
    assert names == ref_names == ["frame_00000.png", "frame_00001.png"]
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (64, 64, 3)
        assert np.abs(g - r).max() <= 1
    # real structure: not a blank frame, and the camera moves
    assert got[0].std() > 5 and not np.array_equal(got[0], got[1])


def _render_both(tmp_path, tag, model_args, flag):
    """The port's main on the CPU and the reference's main on the same
    model; returns the two frame directories."""
    port, ref = tmp_path / f"port_{tag}", tmp_path / f"ref_{tag}"
    tRT.main(model_args + ["--out_dir", str(port), flag] + FRAME_ARGS, device="cpu")
    jRT.main(model_args + ["--out_dir", str(ref), flag, "--isect_cap", "16384"]
             + FRAME_ARGS)
    return port, ref


@pytest.fixture(scope="module")
def ply(tmp_path_factory):
    rng = np.random.RandomState(0)
    pts = rng.randn(300, 3).astype(np.float32)
    state = tG.create_from_pcd(pts, rng.rand(300, 3).astype(np.float32), device="cpu")
    path = str(tmp_path_factory.mktemp("model") / "model.ply")
    tG.save_ply(state, path)
    return path


@pytest.mark.parametrize("k,samples", [(3, 7), (8, 8), (8, 120), (13, 50)])
def test_catmull_rom_matches_reference(k, samples):
    pts = np.random.RandomState(k).normal(size=(k, 3))
    np.testing.assert_allclose(tRT.catmull_rom_closed(pts, samples),
                               jRT.catmull_rom_closed(pts, samples), rtol=0, atol=1e-6)


@pytest.mark.parametrize("branch", ["hull", "ellipse_two_points", "ellipse_collinear"])
def test_orbit_trajectory_matches_reference(branch):
    rng = np.random.RandomState(2)
    if branch == "hull":
        centers = rng.normal(size=(40, 3)) * [4.0, 0.5, 3.0]
    elif branch == "ellipse_two_points":  # too few points for a hull
        centers = rng.normal(size=(2, 3))
    else:  # a line in x-z has no hull
        t = rng.rand(9)
        centers = np.stack([t, rng.rand(9), 2 * t + 1], 1)
    got = tRT.generate_orbit_trajectory(centers, 30)
    np.testing.assert_allclose(got, jRT.generate_orbit_trajectory(centers, 30),
                               rtol=0, atol=1e-6)
    assert got.shape == (30, 3) and np.isfinite(got).all()


@pytest.mark.parametrize("pos,target", [
    ((3.0, -1.0, 4.0), (0.0, 0.0, 0.0)),
    ((0.5, 2.0, -6.0), (0.2, 0.1, 0.3)),
    ((0.0, -5.0, 0.0), (0.0, 0.0, 0.0)),  # looking along up: the x fallback
])
def test_look_at_matches_reference(pos, target):
    got = tRT.look_at_camera(pos, target)
    np.testing.assert_allclose(got, jRT.look_at_camera(pos, target), rtol=0, atol=1e-6)
    assert got.dtype == np.float32


@pytest.mark.parametrize("flag", STRATEGIES)
def test_ply_frames_match_reference(tmp_path, ply, flag):
    port, ref = _render_both(tmp_path, "ply", ["--load_ply_path", ply], flag)
    _assert_frames_agree(port, ref)


@pytest.mark.parametrize("flag", ["--no_offload", "--clm_offload"])
def test_load_pt_path_matches_reference(tmp_path, ply, flag):
    state = tG.load_ply(ply, device="cpu")
    pt = str(tmp_path / "model.npz")
    tG.save_tensors(state, pt)
    port, ref = _render_both(tmp_path, "pt", ["--load_pt_path", pt], flag)
    _assert_frames_agree(port, ref)
    # the same frames as from the PLY
    from_ply = tmp_path / "from_ply"
    tRT.main(["--load_ply_path", ply, "--out_dir", str(from_ply), flag] + FRAME_ARGS,
             device="cpu")
    for a, b in zip(_frames(port)[1], _frames(from_ply)[1]):
        np.testing.assert_array_equal(a, b)


def test_model_dir_of_a_port_run(tmp_path, capfd):
    """--model_dir reads args.json (source path, SH degree) and the newest
    PLY of a run trained by the port's CLI; the trajectory follows the
    scene's training cameras in both packages."""
    from clm_gs_tpu_torch.train import main as train_main
    from clm_gs_tpu_torch.utils.synthetic_colmap import make_dataset

    scene = make_dataset(str(tmp_path / "scene"), device="cpu")
    run = str(tmp_path / "run")
    train_main(["-s", scene, "-m", run, "--no_offload", "--bsz", "4",
                "--iterations", "8", "--save_iterations", "4", "8",
                "--test_iterations", "100", "--disable_auto_densification",
                "--quiet"], device="cpu")
    assert sorted(os.listdir(os.path.join(run, "point_cloud"))) == [
        "iteration_4", "iteration_8"]
    capfd.readouterr()
    port, ref = _render_both(tmp_path, "run", ["--model_dir", run], "--clm_offload")
    err = capfd.readouterr().err
    newest = os.path.join(run, "point_cloud", "iteration_8", "point_cloud.ply")
    assert err.count(f"using {newest}") == 2
    _assert_frames_agree(port, ref)
    args = tRT.parse_args(["--model_dir", run, "--out_dir", str(port)])
    assert args.source_path == scene and args.load_ply_path == newest


def test_topdown_mp4_and_timing_line(tmp_path, ply, capfd):
    td, mp4 = str(tmp_path / "top.png"), str(tmp_path / "traj.mp4")
    tRT.main(["--load_ply_path", ply, "--out_dir", str(tmp_path / "f"), "--topdown", td,
              "--mp4", mp4, "--clm_offload"] + FRAME_ARGS, device="cpu")
    assert os.path.getsize(td) > 0
    # the MP4 is best-effort (imageio and an encoder are optional)
    if os.path.exists(mp4):
        assert os.path.getsize(mp4) > 0
    err = capfd.readouterr().err
    assert "rendered 2 frames in " in err and " frames/s; render and read-back " in err


def test_card_is_the_default(tmp_path, ply, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tRT.main(["--load_ply_path", ply, "--out_dir", str(tmp_path)] + FRAME_ARGS)
    assert not os.listdir(tmp_path)


def test_no_model_is_an_error(tmp_path):
    with pytest.raises(SystemExit):
        tRT.parse_args(["--out_dir", str(tmp_path)])
