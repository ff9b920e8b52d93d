"""Port vs reference: the training CLI under --naive_offload.

Both packages' `main` on one synthetic COLMAP scene below the first capacity
(the port on the CPU, through its plain kernel versions), compared as
test_torch_cli.py::test_main_matches_reference compares the no_offload runs.
Then the port's own run through a capacity growth, an opacity reset, a PLY,
a checkpoint and a resume; the reference's training loop raises on that growth
(its `_grow_opt` dereferences the `None` optimizer state of naive_offload).
"""

import json
import os

import numpy as np
import pytest
import torch

from clm_gs_tpu.models import gaussians as jG
from clm_gs_tpu_torch.models import gaussians as tG
from clm_gs_tpu_torch.strategies import naive_offload as t_naive
from clm_gs_tpu_torch.train import main as tmain
from tests.make_synthetic_colmap import make_dataset
from tests.test_torch_cli import (FIELDS, _events, _log, _losses, _rows,
                                  _unpacked_reference_grads)
from tests.test_torch_native import reference_native

torch.set_num_threads(1)
COLS = {"xyz": 3, "opacity": 1, "log_scale": 3, "quat": 4, "sh": 48}
GROUPS = tuple(COLS)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_dataset(str(tmp_path_factory.mktemp("scene")))


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_main_matches_reference(scene, tmp_path):
    """8 iterations at bsz 4 without densification, a checkpoint after the
    first batch: logged losses within 2e-6, eval PSNRs within 1e-4 dB, L1s
    within 1e-5 relative (test_torch_cli.py's bounds); the checkpoints hold
    the same files and keys, and the host moments agree within 1e-5 of each
    group's largest value (the gradients are summed in another order)."""
    argv = ["-s", scene, "--naive_offload", "--eval", "--llffhold", "5", "--bsz", "4",
            "--iterations", "8", "--disable_auto_densification",
            "--test_iterations", "8", "--log_interval", "1", "--isect_cap", "65536",
            "--checkpoint_iterations", "4", "--do_not_save"]
    from clm_gs_tpu.train import main as jmain

    reference_native()
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    with _unpacked_reference_grads():
        jmain(argv + ["-m", jout])
    state, opt = tmain(argv + ["-m", tout], device="cpu")
    assert opt is None and not t_naive._is_stripped(state)
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
    jck, tck = (os.path.join(o, "checkpoints", "5") for o in (jout, tout))
    assert sorted(os.listdir(tck)) == sorted(os.listdir(jck)) == [
        "chkpnt.npz", "meta.json", "strategy_extra.npz"]
    assert sorted(_npz(os.path.join(tck, "chkpnt.npz"))) == sorted(
        _npz(os.path.join(jck, "chkpnt.npz")))
    t_extra = _npz(os.path.join(tck, "strategy_extra.npz"))
    j_extra = _npz(os.path.join(jck, "strategy_extra.npz"))
    assert sorted(t_extra) == sorted(j_extra)
    for k, want in j_extra.items():
        got = t_extra[k]
        assert (got.shape, got.dtype) == (want.shape, want.dtype), k
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale, err_msg=k)
    assert all(int(t_extra[f"naive.{g}.step_count"]) == 1 for g in GROUPS)


def _naive_argv(scene, out, iters=12, extra=()):
    """test_torch_cli.py's _argv, naive_offload."""
    return [
        "-s", scene, "-m", out, "--naive_offload", "--eval", "--llffhold", "5",
        "--bsz", "4", "--iterations", str(iters), "--test_iterations", str(iters),
        "--save_iterations", str(iters), "--densify_from_iter", "4",
        "--densification_interval", "8", "--densify_grad_threshold", "0.0000001",
        "--opacity_reset_interval", "8", "--checkpoint_iterations", "4", "8",
        "--prealloc_capacity", "130", "--log_interval", "4", "--lr_scale_mode", "sqrt",
    ] + list(extra)


def test_reference_run_raises_on_growth(scene, tmp_path):
    """The reference's naive_offload run stops at its first capacity growth
    (clm_gs_tpu/train.py:239 -> :517 -> :65); the port's run of the same
    arguments is the next test."""
    from clm_gs_tpu.train import main as jmain

    out = str(tmp_path / "jax")
    with pytest.raises(AttributeError, match="mu"):
        jmain(_naive_argv(scene, out) + ["--isect_cap", "65536"])
    assert "capacity 130 -> " in _log(out)


def test_growth_reset_checkpoint_and_resume(scene, tmp_path, monkeypatch):
    out = str(tmp_path / "run")
    state, opt = tmain(_naive_argv(scene, out, extra=["--enable_timer"]), device="cpu")
    log = _log(out)
    assert opt is None
    assert "capacity 130 -> 65536" in log and "iteration[5,9) reset_opacity" in log
    assert "densify_and_prune" in log and "Saving Checkpoint" in log
    assert "end2end total_time:" in log
    evals = _events(out, "eval")
    assert evals and all(np.isfinite(e["psnr"]) and e["psnr"] > 5 for e in evals)
    assert state.capacity == 65536 and state.n_alive > 120
    ply = os.path.join(out, "point_cloud", "iteration_12", "point_cloud.ply")
    assert int(jG.load_ply(ply).n_alive) == state.n_alive
    got, want = _rows(tG.load_ply(ply, device="cpu")), _rows(state)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], want[f])
    # --enable_timer: one span per call of the loop, the two naive spans
    # once per batch
    spans = {ln.split(": sum ")[0]: int(ln.split(" ms over ")[1].split()[0])
             for ln in log.splitlines() if ": sum " in ln and " ms over " in ln}
    assert spans == {"data_next": 3, "stack_cameras": 3, "train_step": 3, "log": 4,
                     "eval": 1, "count_densify": 1, "grow_capacity": 1, "densify": 1,
                     "reset_opacity": 1, "save": 1, "checkpoint": 2,
                     "naive.grads": 3, "naive.d2h_adam": 3}

    # checkpoints after the first batch and after the second (its growth and
    # reset): self-contained parameters, zero moments in chkpnt.npz, the
    # host moments beside it
    for it, cap, steps in ((5, 130, 1), (9, 65536, 2)):
        ck = os.path.join(out, "checkpoints", str(it))
        arrays = _npz(os.path.join(ck, "chkpnt.npz"))
        extra = _npz(os.path.join(ck, "strategy_extra.npz"))
        assert arrays["params.xyz"].shape == (cap, 3)
        assert not any(arrays[f"{m}.{g}"].any() for m in ("mu", "nu") for g in GROUPS)
        assert json.load(open(os.path.join(ck, "meta.json")))["iteration"] == it
        for g in GROUPS:
            assert extra[f"naive.{g}.exp_avg"].shape == (cap, COLS[g])
            assert int(extra[f"naive.{g}.step_count"]) == steps
        if it == 5:  # one step moved every group but quat: the initial
            # scales are isotropic, so it has no gradient yet
            assert all(extra[f"naive.{g}.exp_avg_sq"].any() == (g != "quat")
                       for g in GROUPS)
        else:  # the reset zeroed every opacity moment
            assert not (extra["naive.opacity.exp_avg"].any()
                        or extra["naive.opacity.exp_avg_sq"].any())

    restored = []
    real = t_naive.restore_extra

    def spy(ctx, arrs):
        restored.append(arrs)
        return real(ctx, arrs)

    monkeypatch.setattr(t_naive, "restore_extra", spy)
    out2 = str(tmp_path / "resume")
    state2, _ = tmain(["-s", scene, "-m", out2, "--naive_offload", "--bsz", "4",
                       "--iterations", "12", "--start_checkpoint", ck, "--do_not_save",
                       "--disable_auto_densification", "--log_interval", "1"], device="cpu")
    log2 = _log(out2)
    assert f"Resumed from {ck} at iteration 9" in log2 and "end2end total_time:" in log2
    assert len(restored) == 1 and sorted(restored[0]) == sorted(extra)
    for k, v in extra.items():
        np.testing.assert_array_equal(restored[0][k], v)
    assert state2.capacity == 65536 and len(_losses(out2)) == 1
    assert np.isfinite(_losses(out2)).all()
