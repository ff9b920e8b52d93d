"""Port vs reference: the training CLI under --clm_offload, the default
strategy.

Both packages' `main` on one synthetic COLMAP scene below the first capacity
(the port on the CPU, through its plain kernel versions), compared as
test_torch_naive_cli.py compares the naive runs. Then the port's own run
through a capacity growth, an opacity reset, a PLY, a checkpoint and a
resume from `strategy_extra.npz`; the resized resume of a clm checkpoint
(tests/test_cli_end2end.py::test_resize_on_resume_clm); and a run with no
strategy flag.
"""

import json
import os
import re
import threading

import numpy as np
import pytest
import torch

from clm_gs_tpu.models import gaussians as jG
from clm_gs_tpu_torch.models import gaussians as tG
from clm_gs_tpu_torch.strategies import clm_offload as t_clm
from clm_gs_tpu_torch.train import main as tmain
from tests.make_synthetic_colmap import make_dataset
from tests.test_torch_cli import (FIELDS, _events, _log, _losses, _rows,
                                  _unpacked_reference_grads)
from tests.test_torch_native import reference_native

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_dataset(str(tmp_path_factory.mktemp("scene")))


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _worker_threads():
    return [t for t in threading.enumerate() if t.name.startswith("clm-adam")]


def _overlap_lines(log):
    return [ln for ln in log.splitlines() if ln.startswith("clm overlap: ")]


def test_main_matches_reference(scene, tmp_path):
    """8 iterations at bsz 4 without densification, a checkpoint after the
    first batch: logged losses within 2e-6, eval PSNRs within 1e-4 dB, L1s
    within 1e-5 relative (test_torch_cli.py's bounds); the same overlap-line
    grammar; the checkpoints hold the same files and keys, the stripped
    chkpnt.npz the same shapes, and the host SH rows and moments agree
    within 1e-5 of each array's largest value."""
    argv = ["-s", scene, "--clm_offload", "--eval", "--llffhold", "5", "--bsz", "4",
            "--iterations", "8", "--disable_auto_densification",
            "--test_iterations", "8", "--log_interval", "1", "--isect_cap", "65536",
            "--checkpoint_iterations", "4", "--do_not_save"]
    from clm_gs_tpu.train import main as jmain

    reference_native()
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    with _unpacked_reference_grads():
        jmain(argv + ["-m", jout])
    state, opt = tmain(argv + ["-m", tout], device="cpu")
    assert tuple(state.params.sh.shape) == (state.capacity, 48)
    assert tuple(opt.mu.sh.shape) == (1, 48)
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
    jo, to = _overlap_lines(_log(jout)), _overlap_lines(_log(tout))
    assert len(to) == len(jo) == 2
    for ln in to + jo:
        assert re.fullmatch(r"clm overlap: host work \d+\.\d ms/batch, trailing "
                            r"\d+\.\d ms/batch, comm-hidden \d+%", ln), ln
    jck, tck = (os.path.join(o, "checkpoints", "5") for o in (jout, tout))
    assert sorted(os.listdir(tck)) == sorted(os.listdir(jck)) == [
        "chkpnt.npz", "meta.json", "strategy_extra.npz"]
    t_arr, j_arr = (_npz(os.path.join(d, "chkpnt.npz")) for d in (tck, jck))
    assert sorted(t_arr) == sorted(j_arr)
    for k in t_arr:
        if k != "rng_key":
            assert t_arr[k].shape == j_arr[k].shape, k
    assert t_arr["params.sh"].shape == t_arr["nu.sh"].shape == (1, 48)
    t_extra = _npz(os.path.join(tck, "strategy_extra.npz"))
    j_extra = _npz(os.path.join(jck, "strategy_extra.npz"))
    assert sorted(t_extra) == sorted(j_extra)
    for k, want in j_extra.items():
        got = t_extra[k]
        assert (got.shape, got.dtype) == (want.shape, want.dtype), k
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale, err_msg=k)
    assert int(t_extra["clm.step_count"]) == 1
    assert not _worker_threads()


def _clm_argv(scene, out, iters=12, extra=()):
    """test_torch_naive_cli.py's _naive_argv, clm_offload."""
    return [
        "-s", scene, "-m", out, "--clm_offload", "--eval", "--llffhold", "5",
        "--bsz", "4", "--iterations", str(iters), "--test_iterations", str(iters),
        "--save_iterations", str(iters), "--densify_from_iter", "4",
        "--densification_interval", "8", "--densify_grad_threshold", "0.0000001",
        "--opacity_reset_interval", "8", "--checkpoint_iterations", "4", "8",
        "--prealloc_capacity", "130", "--log_interval", "4", "--lr_scale_mode", "sqrt",
    ] + list(extra)


def test_growth_reset_checkpoint_and_resume(scene, tmp_path, monkeypatch):
    out = str(tmp_path / "run")
    state, opt = tmain(_clm_argv(scene, out, extra=["--enable_timer", "--pinned_host"]),
                       device="cpu")
    log = _log(out)
    assert "capacity 130 -> 65536" in log and "iteration[5,9) reset_opacity" in log
    assert "densify_and_prune" in log and "Saving Checkpoint" in log
    assert "end2end total_time:" in log and log.count("pinned_host: ") == 1
    assert len(_overlap_lines(log)) == 3
    evals = _events(out, "eval")
    assert evals and all(np.isfinite(e["psnr"]) and e["psnr"] > 5 for e in evals)
    assert state.capacity == 65536 and state.n_alive > 120
    assert tuple(opt.mu.sh.shape) == tuple(opt.nu.sh.shape) == (1, 48)
    assert opt.mu.xyz.shape == (65536, 3)
    ply = os.path.join(out, "point_cloud", "iteration_12", "point_cloud.ply")
    assert int(jG.load_ply(ply).n_alive) == state.n_alive
    got, want = _rows(tG.load_ply(ply, device="cpu")), _rows(state)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], want[f])
    # --enable_timer: one span per call of the loop; the clm spans per
    # camera (4 a batch), per transition (3 a batch) and per drain
    spans = {ln.split(": sum ")[0]: int(ln.split(" ms over ")[1].split()[0])
             for ln in log.splitlines() if ": sum " in ln and " ms over " in ln}
    assert spans == {"data_next": 3, "stack_cameras": 3, "train_step": 3, "log": 4,
                     "eval": 1, "count_densify": 1, "grow_capacity": 1, "densify": 1,
                     "reset_opacity": 1, "save": 1, "checkpoint": 2,
                     "clm.filters": 3, "clm.order": 3, "clm.fetch_h2d": 3,
                     "clm.micro": 12, "clm.advance": 9, "clm.d2h_scatter": 9,
                     "clm.grow_pin": 1, "clm.grow_copy": 1}

    # checkpoints after the first batch and after the second (its growth and
    # reset): the stripped state and its card moments, the host SH rows and
    # moments beside them
    for it, cap, steps in ((5, 130, 1), (9, 65536, 2)):
        ck = os.path.join(out, "checkpoints", str(it))
        arrays = _npz(os.path.join(ck, "chkpnt.npz"))
        extra = _npz(os.path.join(ck, "strategy_extra.npz"))
        assert arrays["params.xyz"].shape == (cap, 3)
        assert arrays["params.sh"].shape == arrays["mu.sh"].shape == (1, 48)
        assert float(arrays["steps"]) == steps
        assert json.load(open(os.path.join(ck, "meta.json")))["iteration"] == it
        for k in ("clm.sh_host", "clm.exp_avg", "clm.exp_avg_sq"):
            assert extra[k].shape == (cap, 48)
        assert int(extra["clm.step_count"]) == steps
        if it == 5:  # one step moved the SH rows (dc only, at degree 0)
            assert extra["clm.exp_avg_sq"][:, :3].any()
            assert not extra["clm.exp_avg_sq"][:, 3:].any()
    # every live row was written by the round (split children fill the
    # sources' slots), so its moments restart; the reset zeroed every
    # opacity moment on the card
    assert not extra["clm.exp_avg"].any()
    assert not arrays["mu.opacity"].any() and not arrays["nu.opacity"].any()

    restored = []
    real = t_clm.restore_extra

    def spy(ctx, arrs):
        restored.append(arrs)
        return real(ctx, arrs)

    monkeypatch.setattr(t_clm, "restore_extra", spy)
    out2 = str(tmp_path / "resume")
    state2, _ = tmain(["-s", scene, "-m", out2, "--bsz", "4", "--iterations", "12",
                       "--start_checkpoint", ck, "--do_not_save",
                       "--disable_auto_densification", "--log_interval", "1"],
                      device="cpu")
    log2 = _log(out2)
    assert f"Resumed from {ck} at iteration 9" in log2 and "end2end total_time:" in log2
    assert len(restored) == 1 and sorted(restored[0]) == sorted(extra)
    for k, v in extra.items():
        np.testing.assert_array_equal(restored[0][k], v)
    assert state2.capacity == 65536 and len(_losses(out2)) == 1
    assert np.isfinite(_losses(out2)).all() and len(_overlap_lines(log2)) == 1
    assert not _worker_threads()


def test_resize_on_resume(scene, tmp_path):
    """--drop_duplicate_gaussians_coeff on a clm checkpoint: the SH rows come
    back from strategy_extra.npz before the rows are chosen, and the run goes
    on with a fresh context; coefficient 1 resumes the moments as saved."""
    out = str(tmp_path / "clm_resize")
    tmain(_clm_argv(scene, out, iters=8, extra=["--do_not_save",
                                                "--disable_auto_densification"]),
          device="cpu")
    ck = os.path.join(out, "checkpoints", "5")
    for coeff, want_rows in (("1.0", None), ("1.5", 180)):
        out2 = str(tmp_path / f"resume_{coeff}")
        state, opt = tmain([
            "-s", scene, "-m", out2, "--clm_offload", "--bsz", "4",
            "--iterations", "8", "--start_checkpoint", ck, "--do_not_save",
            "--disable_auto_densification", "--drop_duplicate_gaussians_coeff", coeff,
        ], device="cpu")
        log = _log(out2)
        assert f"Resumed from {ck} at iteration 5" in log
        assert "end2end total_time:" in log and "iterations: 4," in log
        assert tuple(opt.mu.sh.shape) == (1, 48)
        if want_rows is not None:
            assert f"drop_duplicate_gaussians: resized to {want_rows} rows" in log
            assert state.n_alive == want_rows and float(opt.steps) == 1.0
        else:
            assert float(opt.steps) == 2.0


def test_default_strategy_is_clm(scene, tmp_path):
    """No strategy flag: clm_offload trains, densifies, evaluates and saves."""
    out = str(tmp_path / "default")
    state, opt = tmain(["-s", scene, "-m", out, "--eval", "--llffhold", "5",
                        "--bsz", "4", "--iterations", "8", "--test_iterations", "8",
                        "--save_iterations", "8", "--densify_from_iter", "4",
                        "--densification_interval", "4",
                        "--densify_grad_threshold", "0.0000001", "--log_interval", "4"],
                       device="cpu")
    log = _log(out)
    assert "clm_offload=True" in log and _overlap_lines(log)
    assert "densify_and_prune" in log and "Saving Gaussians" in log
    assert tuple(opt.mu.sh.shape) == (1, 48) and state.n_alive > 120
    evals = _events(out, "eval")
    assert evals and all(np.isfinite(e["psnr"]) for e in evals)


def test_cli_ab_reads_a_clm_log(scene, tmp_path):
    """utils/cli_ab.py's reader on a timed clm run's python.log: end2end
    seconds and it/s as logged, a mean a call for every clm span, and the
    last overlap line's two numbers."""
    from clm_gs_tpu_torch.utils.cli_ab import parse_log

    out = str(tmp_path / "timed")
    tmain(["-s", scene, "-m", out, "--clm_offload", "--bsz", "4", "--iterations", "8",
           "--enable_timer", "--log_interval", "4", "--do_not_save"], device="cpu")
    log = _log(out)
    got = parse_log(log)
    e2e = [ln for ln in log.splitlines() if ln.startswith("end2end total_time:")][-1]
    assert e2e.startswith(f"end2end total_time: {got['end2end_s']:.3f} s")
    assert e2e.endswith(f"throughput {got['it_per_s']:.2f} it/s")
    spans = ("clm.filters", "clm.order", "clm.fetch_h2d", "clm.micro", "clm.advance",
             "train_step")
    assert all(got["span_ms"][k] > 0 for k in spans)
    last = _overlap_lines(log)[-1]
    assert f"host work {got['overlap_ms']['host_work']:.1f} ms/batch" in last
    assert f"trailing {got['overlap_ms']['trailing']:.1f} ms/batch" in last
