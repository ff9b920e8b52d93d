"""The port's training CLI on a (data x gauss) mesh: `main(argv,
device="cpu")` in two gloo processes (tests/torch_parallel_workers.py, no
JAX), each run starting its process group from the --dist_* flags or from
the torchrun variables and destroying it at its end.

One synthetic COLMAP scene (utils/synthetic_colmap.make_dataset); the
reference is the port's own single-process run of the same arguments, which
densifies and grows its capacity (130 -> 65536) inside the run, under
--no_offload and under --clm_offload. Rank 0 alone writes the run's files;
checkpoints keep the single-device layout, so a mesh checkpoint resumes on
one process and the other way round.
"""

import json
import os

import numpy as np
import pytest
import torch

from clm_gs_tpu_torch.models import gaussians as tG
from clm_gs_tpu_torch.train import main as tmain
from clm_gs_tpu_torch.utils.synthetic_colmap import make_dataset
from tests import torch_parallel_workers as workers
from tests.test_torch_cli import FIELDS, _events, _log, _losses, _rows

torch.set_num_threads(1)


def _argv(scene, out, iters=12, extra=(), strategy="--no_offload"):
    """test_torch_naive_cli.py's run: densification at 8 grows the capacity
    past --prealloc_capacity 130; checkpoints at 4 and 8."""
    return [
        "-s", scene, "-m", out, strategy, "--eval", "--llffhold", "5",
        "--bsz", "4", "--iterations", str(iters), "--test_iterations", str(iters),
        "--save_iterations", str(iters), "--densify_from_iter", "4",
        "--densification_interval", "8", "--densify_grad_threshold", "0.0000001",
        "--checkpoint_iterations", "4", "8", "--prealloc_capacity", "130",
        "--log_interval", "4", "--quiet",
    ] + list(extra)


def _flags(mesh_shape):
    return ["--mesh_shape", mesh_shape, "--dist_coordinator",
            f"127.0.0.1:{workers.free_port()}", "--dist_num_processes", "2",
            "--dist_process_id", "{rank}"]


CLM = "--clm_offload"
CLM_RUNS = ("clm_single", "clm", "clm_data2", "clm_resume_on_mesh", "clm_bsz3",
            "clm_resume_single", "clm_resume_ref")


def _torchrun_env():
    return {"RANK": "{rank}", "LOCAL_RANK": "{rank}", "WORLD_SIZE": "2",
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(workers.free_port())}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The single-process run; then, in two processes, the same run on a 1x2
    mesh, a 1x2 resume of the single run's checkpoint (torchrun variables),
    the same run on a 2x1 mesh, bsz 3 on a 2x1 mesh, --naive_offload; the
    same four under --clm_offload (the 1x2 resume from the single clm run's
    checkpoint); then one process resuming the 1x2 run's checkpoint, and
    one resuming the single run's (a resumed run's loader starts a new
    epoch, so the resumes are compared with each other), each again under
    --clm_offload."""
    root = tmp_path_factory.mktemp("mesh_cli")
    out = {k: str(root / k) for k in ("scene", "single", "mesh", "resume_on_mesh",
                                      "data2", "bsz3", "naive", "resume_single",
                                      "resume_ref", *CLM_RUNS)}
    scene = make_dataset(out["scene"], device="cpu")
    single = tmain(_argv(scene, out["single"]), device="cpu")
    clm_single = tmain(_argv(scene, out["clm_single"], strategy=CLM), device="cpu")
    ckpt = os.path.join(out["single"], "checkpoints", "9")
    clm_ckpt = os.path.join(out["clm_single"], "checkpoints", "9")
    runs = [
        (_argv(scene, out["mesh"], extra=_flags("1x2")), {}),
        (_argv(scene, out["resume_on_mesh"], extra=["--start_checkpoint", ckpt,
                                                    "--mesh_shape", "1x2"]),
         _torchrun_env()),
        (_argv(scene, out["data2"], extra=_flags("2x1")), {}),
        (_argv(scene, out["bsz3"], iters=6, extra=_flags("2x1") + ["--bsz", "3"]), {}),
        (_argv(scene, out["naive"], iters=8, extra=_flags("1x2"),
               strategy="--naive_offload"), {}),
        (_argv(scene, out["clm"], extra=_flags("1x2"), strategy=CLM), {}),
        (_argv(scene, out["clm_data2"], extra=_flags("2x1"), strategy=CLM), {}),
        (_argv(scene, out["clm_resume_on_mesh"], strategy=CLM, extra=[
            "--start_checkpoint", clm_ckpt, "--mesh_shape", "1x2"]), _torchrun_env()),
        (_argv(scene, out["clm_bsz3"], iters=6, strategy=CLM,
               extra=_flags("2x1") + ["--bsz", "3"]), {}),
    ]
    ranks = workers.launch(workers.cli_runs, 2, runs, timeout=300)
    names = ("mesh", "resume_on_mesh", "data2", "bsz3", "naive", "clm", "clm_data2",
             "clm_resume_on_mesh", "clm_bsz3")
    per_run = {name: [r[i] for r in ranks] for i, name in enumerate(names)}
    resumed = tmain(_argv(scene, out["resume_single"], extra=[
        "--start_checkpoint", os.path.join(out["mesh"], "checkpoints", "9")]),
        device="cpu")
    tmain(_argv(scene, out["resume_ref"], extra=["--start_checkpoint", ckpt]), device="cpu")
    per_run["clm_resume_single"] = tmain(_argv(scene, out["clm_resume_single"], strategy=CLM,
                                               extra=["--start_checkpoint", os.path.join(
                                                   out["clm"], "checkpoints", "9")]),
                                         device="cpu")
    tmain(_argv(scene, out["clm_resume_ref"], strategy=CLM,
                extra=["--start_checkpoint", clm_ckpt]), device="cpu")
    per_run["clm_single"] = clm_single
    return out, single, per_run, resumed


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("run", ["mesh", "data2"])
def test_mesh_run_matches_the_single_process_run(runs, run):
    """Losses within 2e-6 (6 decimals in the log), the same growth, final
    Gaussian count and eval PSNRs within 1e-4 dB; the JAX package's mesh
    line; the process group gone at the end on both ranks."""
    out, (state, _), per_run, _ = runs
    log, ref = _log(out[run]), _log(out["single"])
    shape = {"mesh": "{'data': 1, 'gauss': 2}", "data2": "{'data': 2, 'gauss': 1}"}[run]
    assert f"multi-chip mesh: {shape}" in log
    assert "capacity 130 -> 65536" in log and "capacity 130 -> 65536" in ref
    np.testing.assert_allclose(_losses(out[run]), _losses(out["single"]), atol=2e-6)
    assert len(_losses(out[run])) == 3
    for r in per_run[run]:
        assert (r["n_alive"], r["capacity"]) == (state.n_alive, state.capacity)
        assert not r["group_left"]
    densify = [ln for ln in log.splitlines() if "densify_and_prune" in ln]
    assert [ln.split(". Max")[0] for ln in densify] == [
        ln.split(". Max")[0] for ln in ref.splitlines() if "densify_and_prune" in ln]
    te, re_ = _events(out[run], "eval"), _events(out["single"], "eval")
    assert [(e["iteration"], e["split"]) for e in te] == [
        (e["iteration"], e["split"]) for e in re_]
    np.testing.assert_allclose([e["psnr"] for e in te], [e["psnr"] for e in re_],
                               atol=1e-4)


def test_only_rank_0_writes(runs):
    """One writer: every line of python.log once (two writers would each
    have written the config and end lines), one end2end event, and the run
    directory holds what the single-process run's holds."""
    out, _, _, _ = runs
    log = _log(out["mesh"])
    assert log.count("config: ") == 1 and log.count("end2end total_time:") == 1
    assert log.count("multi-chip mesh:") == 1
    assert len(_events(out["mesh"], "end2end")) == 1
    assert sorted(os.listdir(out["mesh"])) == sorted(os.listdir(out["single"]))
    assert json.load(open(os.path.join(out["mesh"], "args.json")))["tpu"][
        "mesh_shape"] == "1x2"


def test_mesh_files_have_the_single_device_layout(runs):
    """The PLY and checkpoints of the 1x2 run have every row, as the single
    run's do, with the same keys, shapes and values (within 1e-6 of each
    array's largest)."""
    out, (state, _), _, _ = runs
    ply = os.path.join("point_cloud", "iteration_12", "point_cloud.ply")
    got = _rows(tG.load_ply(os.path.join(out["mesh"], ply), device="cpu"))
    want = _rows(tG.load_ply(os.path.join(out["single"], ply), device="cpu"))
    for f in FIELDS:
        assert got[f].shape == want[f].shape == (state.n_alive,) + got[f].shape[1:]
        np.testing.assert_allclose(got[f], want[f], atol=1e-6 * np.abs(want[f]).max())
    for it, cap in (("5", 130), ("9", 65536)):
        ck = _npz(os.path.join(out["mesh"], "checkpoints", it, "chkpnt.npz"))
        ref = _npz(os.path.join(out["single"], "checkpoints", it, "chkpnt.npz"))
        assert sorted(ck) == sorted(ref)
        assert ck["params.xyz"].shape == (cap, 3)
        assert not os.path.exists(os.path.join(out["mesh"], "checkpoints", it,
                                               "strategy_extra.npz"))
        for k, want_k in ref.items():
            assert ck[k].shape == want_k.shape and ck[k].dtype == want_k.dtype, k
            scale = max(float(np.abs(want_k.astype(np.float64)).max()), 1e-30)
            np.testing.assert_allclose(ck[k].astype(np.float64),
                                       want_k.astype(np.float64), atol=1e-6 * scale,
                                       err_msg=k)


def test_one_process_resumes_a_mesh_checkpoint(runs):
    """The 1x2 run's checkpoint after its growth, resumed on one process:
    the loss of the single run's checkpoint resumed alike, the same model."""
    out, (state, _), _, (resumed, _) = runs
    log = _log(out["resume_single"])
    assert "Resumed from" in log and "at iteration 9" in log
    assert "multi-chip mesh" not in log
    assert len(_losses(out["resume_single"])) == 1
    np.testing.assert_allclose(_losses(out["resume_single"]), _losses(out["resume_ref"]),
                               atol=2e-6)
    assert (resumed.n_alive, resumed.capacity) == (state.n_alive, state.capacity)


def test_a_mesh_resumes_a_single_process_checkpoint(runs):
    """torchrun's variables start the group; the single run's checkpoint
    after its growth is sharded onto the 1x2 mesh and trains on as the
    single process resumed it."""
    out, (state, _), per_run, _ = runs
    log = _log(out["resume_on_mesh"])
    assert "Resumed from" in log and "multi-chip mesh: {'data': 1, 'gauss': 2}" in log
    assert len(_losses(out["resume_on_mesh"])) == 1
    np.testing.assert_allclose(_losses(out["resume_on_mesh"]), _losses(out["resume_ref"]),
                               atol=2e-6)
    for r in per_run["resume_on_mesh"]:
        assert (r["n_alive"], r["capacity"]) == (state.n_alive, state.capacity)
        assert not r["group_left"]


@pytest.mark.parametrize("run,line", [
    ("bsz3", "mesh data axis 2 does not divide bsz 3; running single-device"),
    ("naive", "naive_offload does not support multi-chip sharding; "
              "running single-device"),
])
def test_single_device_fallbacks_say_so(runs, run, line):
    """The two cases in which the JAX package runs single-device on a mesh
    write its line; every rank then trains the same model."""
    out, _, per_run, _ = runs
    log = _log(out[run])
    assert line in log and "multi-chip mesh" not in log
    assert "end2end total_time:" in log and np.isfinite(_losses(out[run])).all()
    a, b = per_run[run]
    assert a == b and not a["group_left"]


@pytest.mark.parametrize("run", ["clm", "clm_data2"])
def test_clm_mesh_run_matches_the_single_process_run(runs, run):
    """--clm_offload on a 1x2 mesh (the host SH rows split between the two
    ranks) and a 2x1 mesh (two camera chains, the host rows on both) against
    the single-process clm run: losses within 2e-6, the same growth,
    densification and final Gaussian count, eval PSNRs within 1e-4 dB; the
    JAX package's clm mesh lines; the process group gone on both ranks."""
    out, _, per_run, _ = runs
    state, _ = per_run["clm_single"]
    log, ref = _log(out[run]), _log(out["clm_single"])
    shape = {"clm": "{'data': 1, 'gauss': 2}", "clm_data2": "{'data': 2, 'gauss': 1}"}[run]
    assert f"multi-chip mesh (clm gauss sharding): {shape}" in log
    assert ("clm data-parallel: 2 camera chains" in log) == (run == "clm_data2")
    assert ("clm data sum:" in log) == (run == "clm_data2")
    assert "clm overlap:" in log
    assert "capacity 130 -> 65536" in log and "capacity 130 -> 65536" in ref
    np.testing.assert_allclose(_losses(out[run]), _losses(out["clm_single"]), atol=2e-6)
    assert len(_losses(out[run])) == 3
    for r in per_run[run]:
        assert (r["n_alive"], r["capacity"]) == (state.n_alive, state.capacity)
        assert not r["group_left"]
    densify = [ln for ln in log.splitlines() if "densify_and_prune" in ln]
    assert densify and [ln.split(". Max")[0] for ln in densify] == [
        ln.split(". Max")[0] for ln in ref.splitlines() if "densify_and_prune" in ln]
    te, re_ = _events(out[run], "eval"), _events(out["clm_single"], "eval")
    assert te and [(e["iteration"], e["split"]) for e in te] == [
        (e["iteration"], e["split"]) for e in re_]
    np.testing.assert_allclose([e["psnr"] for e in te], [e["psnr"] for e in re_],
                               atol=1e-4)


def test_clm_mesh_writes_the_single_device_files_from_rank_0(runs):
    """The 1x2 clm run: one writer (every log line once), the single clm
    run's files, and checkpoints whose chkpnt.npz and strategy_extra.npz
    (the host SH rows and moments of every row, gathered from both ranks)
    have the single run's keys and shapes, with values within 1e-5 of each
    array's largest."""
    out, _, _, _ = runs
    log = _log(out["clm"])
    assert log.count("config: ") == 1 and log.count("end2end total_time:") == 1
    assert log.count("multi-chip mesh (clm gauss sharding):") == 1
    assert sorted(os.listdir(out["clm"])) == sorted(os.listdir(out["clm_single"]))
    for it, cap in (("5", 130), ("9", 65536)):
        for name in ("chkpnt.npz", "strategy_extra.npz"):
            ck = _npz(os.path.join(out["clm"], "checkpoints", it, name))
            ref = _npz(os.path.join(out["clm_single"], "checkpoints", it, name))
            assert sorted(ck) == sorted(ref)
            for k, want in ref.items():
                assert ck[k].shape == want.shape and ck[k].dtype == want.dtype, k
                scale = max(float(np.abs(want.astype(np.float64)).max()), 1e-30)
                np.testing.assert_allclose(ck[k].astype(np.float64),
                                           want.astype(np.float64), atol=1e-5 * scale,
                                           err_msg=f"{it} {name} {k}")
        sh = _npz(os.path.join(out["clm"], "checkpoints", it, "strategy_extra.npz"))
        assert sh["clm.sh_host"].shape == (cap, 48)


def test_clm_resumes_across_the_mesh_both_ways(runs):
    """The 1x2 clm run's checkpoint after its growth resumed on one process,
    and the single clm run's resumed on a 1x2 mesh (torchrun's variables):
    both give the loss of the single run's checkpoint resumed on one
    process, and the same model."""
    out, _, per_run, _ = runs
    state, _ = per_run["clm_single"]
    ref = _losses(out["clm_resume_ref"])
    assert len(ref) == 1
    for run, mesh in (("clm_resume_single", False), ("clm_resume_on_mesh", True)):
        log = _log(out[run])
        assert "Resumed from" in log and "at iteration 9" in log
        assert ("multi-chip mesh (clm gauss sharding): {'data': 1, 'gauss': 2}"
                in log) == mesh
        np.testing.assert_allclose(_losses(out[run]), ref, atol=2e-6)
    resumed, _ = per_run["clm_resume_single"]
    assert (resumed.n_alive, resumed.capacity) == (state.n_alive, state.capacity)
    for r in per_run["clm_resume_on_mesh"]:
        assert (r["n_alive"], r["capacity"]) == (state.n_alive, state.capacity)
        assert not r["group_left"]


def test_clm_data_axis_fallback_says_so(runs):
    """bsz 3 on a 2x1 mesh under --clm_offload: the gauss sharding kept, one
    camera chain (the whole tour) on every data rank, as the JAX package
    runs it, and the log says so; both ranks train the same model."""
    out, _, per_run, _ = runs
    log = _log(out["clm_bsz3"])
    assert "multi-chip mesh (clm gauss sharding): {'data': 2, 'gauss': 1}" in log
    assert ("mesh data axis 2 does not divide bsz 3; clm runs one camera chain, "
            "the whole tour, on every data rank") in log
    assert "clm data-parallel" not in log and "clm data sum:" not in log
    assert "end2end total_time:" in log and np.isfinite(_losses(out["clm_bsz3"])).all()
    a, b = per_run["clm_bsz3"]
    assert a == b and not a["group_left"]


def test_a_group_of_one_trains_on_a_1x1_mesh(runs, tmp_path):
    """The --dist_* flags with one process (as chip_smoke.py's mesh phase
    runs it on one card): the sharded step on a 1x1 mesh, in this process,
    gives the single run's losses and model, and the group is gone after."""
    import torch.distributed as dist

    out, (state, _), _, _ = runs
    mesh = str(tmp_path / "mesh1x1")
    got, _ = tmain(_argv(out["scene"], mesh, extra=[
        "--mesh_shape", "1x1", "--dist_coordinator", f"127.0.0.1:{workers.free_port()}",
        "--dist_num_processes", "1", "--dist_process_id", "0"]), device="cpu")
    assert not dist.is_initialized()
    assert "multi-chip mesh: {'data': 1, 'gauss': 1}" in _log(mesh)
    np.testing.assert_allclose(_losses(mesh), _losses(out["single"]), atol=2e-6)
    assert (got.n_alive, got.capacity) == (state.n_alive, state.capacity)



def test_a_group_of_one_trains_clm_on_a_1x1_mesh(runs, tmp_path):
    """--clm_offload with the --dist_* flags and one process (as chip_smoke.py's
    clm_mesh phase runs it on one card): the context cut to a 1x1 mesh, in
    this process, gives the single clm run's losses and model, and the group
    is gone after."""
    import torch.distributed as dist

    out, _, per_run, _ = runs
    state, _ = per_run["clm_single"]
    mesh = str(tmp_path / "clm1x1")
    got, _ = tmain(_argv(out["scene"], mesh, strategy=CLM, extra=[
        "--mesh_shape", "1x1", "--dist_coordinator", f"127.0.0.1:{workers.free_port()}",
        "--dist_num_processes", "1", "--dist_process_id", "0"]), device="cpu")
    assert not dist.is_initialized()
    assert "multi-chip mesh (clm gauss sharding): {'data': 1, 'gauss': 1}" in _log(mesh)
    np.testing.assert_allclose(_losses(mesh), _losses(out["clm_single"]), atol=2e-6)
    assert (got.n_alive, got.capacity) == (state.n_alive, state.capacity)
    np.testing.assert_array_equal(got.params.sh.numpy(), state.params.sh.numpy())


def test_mesh_cli_reads_a_clm_mesh_log(runs):
    """utils/mesh_cli.py's reading of the 2x1 clm run's python.log: the mesh
    lines, the data sum and overlap lines, it/s, the last test PSNR and the
    final Gaussian count."""
    from clm_gs_tpu_torch.utils.mesh_cli import parse_log

    out, _, per_run, _ = runs
    got = parse_log(_log(out["clm_data2"]))
    assert got["mesh_lines"] == ["multi-chip mesh (clm gauss sharding): "
                                 "{'data': 2, 'gauss': 1}",
                                 "clm data-parallel: 2 camera chains"]
    assert got["data_sum"].startswith("clm data sum: ") and got["overlap"]
    assert got["it_per_s"] > 0 and got["spans_ms"] == {}
    tests = [e for e in _events(out["clm_data2"], "eval") if e["split"] == "test"]
    assert got["test_psnr"] == pytest.approx(tests[-1]["psnr"], abs=1e-9)
    assert got["gaussians"] == per_run["clm_data2"][0]["n_alive"]
