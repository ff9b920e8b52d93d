"""clm_offload's card memory: the in-place Adam tail, the row-chunked
visibility pass and the streaming PLY writer, each against the form it
replaces and against the JAX package.

- `optim.adam_update_` equals `adam_step` to the bit (dense and sparse
  masks, chunks of 1 row, of 7 rows, which do not divide C, and larger than
  C), leaves the masked rows and the rateless (1, 48) placeholder as they
  were, advances `steps` once, and keeps every tensor's storage.
- `offload_common.calculate_filters` in row chunks equals the unchunked pass
  (`fully_fused_projection` over every row, a camera at a time) bit for bit
  (ids, counts, sample; sample phase 0 and 7, a partial `alive`), and the
  JAX package's on the valid entries of its padded ids.
- A clm batch updates the state's four card groups, both statistics and the
  moments in their own storage and returns the objects it was given.
- `save_ply` streaming in blocks writes the JAX `save_ply`'s bytes, as one
  file and as `_rk{i}_ws{n}` files, with the SH rows on the host.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clm_gs_tpu.data.cameras import stack_cameras as j_stack
from clm_gs_tpu.models import gaussians as jG
from clm_gs_tpu.strategies import offload_common as j_oc
from clm_gs_tpu_torch import optim as toptim
from clm_gs_tpu_torch.data.cameras import stack_cameras as t_stack
from clm_gs_tpu_torch.models import gaussians as tG
from clm_gs_tpu_torch.ops.projection import fully_fused_projection
from clm_gs_tpu_torch.strategies import clm_offload as t_clm
from clm_gs_tpu_torch.strategies import offload_common as t_oc
from clm_gs_tpu_torch.utils.bench_scene import make_camera as t_make_camera
from tests.test_torch_clm import GPU, _port_start
from tests.test_torch_cli import _states
from tests.test_torch_naive import T_BG, T_LRS, _cams
from tests.test_torch_native import reference_native
from tests.test_torch_train_step import _inputs
from tests.test_train_synthetic import H, W
from tests.utils3d import make_camera

torch.set_num_threads(1)

C = 1000  # rows; not a multiple of the sample stride
COLS = {"xyz": 3, "opacity": None, "log_scale": 3, "quat": 4}


def _adam_inputs(mask_kind):
    """Parameters, gradients, moments at step 10 with the (1, 48) SH
    placeholder, the four card groups' rates and the update mask: `alive`
    (dense) or `alive & vis_any` (sparse)."""
    rng = np.random.RandomState(11)

    def group(make):
        return tG.GaussianParams(
            *(torch.from_numpy(make((C,) if c is None else (C, c)).astype(np.float32))
              for c in COLS.values()),
            torch.from_numpy(make((1, 48)).astype(np.float32)))

    params = group(lambda s: rng.normal(size=s))
    grads = group(lambda s: 1e-3 * rng.normal(size=s))
    state = toptim.AdamState(group(lambda s: 1e-3 * rng.normal(size=s)),
                             group(lambda s: rng.uniform(1e-4, 1e-2, s)),
                             torch.tensor(10.0))
    lrs = {"xyz": torch.tensor(1.6e-4), "opacity": torch.tensor(0.05),
           "log_scale": torch.tensor(0.005), "quat": torch.tensor(0.001)}
    mask = torch.from_numpy(rng.rand(C) < 0.8)
    if mask_kind == "sparse":
        mask &= torch.from_numpy(rng.rand(C) < 0.3)
    return params, grads, state, lrs, mask


def _clone(p: tG.GaussianParams) -> tG.GaussianParams:
    return tG.GaussianParams(*(t.clone() for t in p.astuple()))


def _tensors(params, state):
    return params.astuple() + state.mu.astuple() + state.nu.astuple() + (state.steps,)


@pytest.mark.parametrize("chunk_rows", [1, 7, 4 * C])
@pytest.mark.parametrize("mask_kind", ["dense", "sparse"])
def test_in_place_update_equals_adam_step(mask_kind, chunk_rows):
    params, grads, state, lrs, mask = _adam_inputs(mask_kind)
    cfg = toptim.AdamConfig().scaled(64, "sqrt")
    want_p, want_s = toptim.adam_step(params, grads, state, lrs, cfg, mask)
    got_p = _clone(params)
    got_s = toptim.AdamState(_clone(state.mu), _clone(state.nu), state.steps.clone())
    before = [t.clone() for t in _tensors(got_p, got_s)]
    ptrs = [t.data_ptr() for t in _tensors(got_p, got_s)]
    out_p, out_s = toptim.adam_update_(got_p, grads, got_s, lrs, cfg, mask, chunk_rows)
    assert out_p is got_p and out_s is got_s
    assert [t.data_ptr() for t in _tensors(out_p, out_s)] == ptrs
    for f in tG.PARAM_FIELDS:
        for got, want in ((out_p, want_p), (out_s.mu, want_s.mu), (out_s.nu, want_s.nu)):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert float(out_s.steps) == float(want_s.steps) == 11.0
    # the masked rows and the rateless placeholder keep every bit
    frozen = ~mask
    for k, (got, old) in enumerate(zip(_tensors(out_p, out_s)[:-1], before[:-1])):
        if got.shape[0] == C:
            assert torch.equal(got[frozen], old[frozen]), k
        else:
            assert torch.equal(got, old), k
    assert not torch.equal(out_p.xyz[mask], before[0][mask])


def _filter_scene(alive_frac=0.85, seed=3):
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-3.0, 3.0, (C, 3)).astype(np.float32)
    quat = rng.normal(size=(C, 4)).astype(np.float32)
    log_scale = np.log(rng.uniform(0.005, 0.08, (C, 3))).astype(np.float32)
    alive = rng.rand(C) < alive_frac
    return xyz, quat, log_scale, alive


def _unchunked(xyz, quat, log_scale, alive, cb, sample_phase):
    """The visibility pass the chunked one replaced: every row projected
    for one camera at a time."""
    scales = torch.exp(log_scale)
    ids, samples = [], []
    for b in range(cb.viewmats.shape[0]):
        proj = fully_fused_projection(xyz, quat, scales, cb.viewmats[b:b + 1],
                                      cb.Ks[b:b + 1], W, H, radius_clip=0.0, alive=alive)
        vis = proj.radii[0] > 0
        ids.append(torch.nonzero(vis).flatten().to(torch.int32))
        samples.append(vis[sample_phase::t_oc.SAMPLE_STRIDE])
    return ids, torch.stack(samples)


@pytest.mark.parametrize("sample_phase", [0, 7])
@pytest.mark.parametrize("chunk_rows", [64, 96, 4 * C])
def test_chunked_filters_equal_the_unchunked_pass_and_reference(chunk_rows, sample_phase):
    xyz, quat, log_scale, alive = _filter_scene()
    cb = _cams()
    args = [torch.from_numpy(a) for a in (xyz, quat, log_scale, alive)]
    F = t_oc.calculate_filters(*args, cb.viewmats, cb.Ks, W, H, 0.0,
                               sample_phase=sample_phase, chunk_rows=chunk_rows)
    ids, sample = _unchunked(*args, cb, sample_phase)
    assert all(torch.equal(a, b) for a, b in zip(F.ids, ids))
    assert F.counts.tolist() == [len(i) for i in ids]
    assert 0 < min(F.counts.tolist()) and max(F.counts.tolist()) < alive.sum()
    assert torch.equal(F.sample, sample)
    assert all(i.dtype == torch.int32 for i in F.ids)
    if sample_phase:
        return
    jcb = j_stack([make_camera(uid=i, width=W, height=H, angle=0.8 * i) for i in range(4)])
    J = j_oc.calculate_filters(*(jnp.asarray(a) for a in (xyz, quat, log_scale, alive)),
                               jcb.viewmats, jcb.Ks, W, H, 0.0, v_cap=C,
                               sample_stride=t_oc.SAMPLE_STRIDE)
    jcounts = np.asarray(J.counts)
    np.testing.assert_array_equal(F.counts.numpy(), jcounts)
    for b, got in enumerate(F.ids):
        np.testing.assert_array_equal(got.numpy(), np.asarray(J.idx)[b, :jcounts[b]])
    np.testing.assert_array_equal(F.sample.numpy(), np.asarray(J.sample))


def test_chunked_filters_single_camera_and_no_alive():
    """Eval's single-camera call, and `alive` None (every row)."""
    xyz, quat, log_scale, _ = _filter_scene()
    args = [torch.from_numpy(a) for a in (xyz, quat, log_scale)]
    cb = t_stack([t_make_camera(uid=0, width=W, height=H, angle=0.3)], device="cpu")
    F = t_oc.calculate_filters(*args, None, cb.viewmats, cb.Ks, W, H, 0.0, chunk_rows=128)
    ids, sample = _unchunked(*args, torch.ones(C, dtype=torch.bool), cb, 0)
    assert torch.equal(F.ids[0], ids[0]) and torch.equal(F.sample, sample)
    with pytest.raises(ValueError, match="multiple"):
        t_oc.calculate_filters(*args, None, cb.viewmats, cb.Ks, W, H, 0.0, chunk_rows=100)


@pytest.mark.parametrize("sparse", [False, True])
def test_clm_batch_updates_in_place(sparse):
    """The donation contract: a batch returns the objects it was given, their
    card groups, moments, steps and statistics updated in their own
    storage (and changed)."""
    reference_native()
    state_np, opt_np, gts = _inputs()
    cfg, state, opt, ctx = _port_start(state_np, sparse=sparse, opt_np=opt_np)
    held = ([getattr(state.params, f) for f in GPU] + [state.xyz_grad_accum, state.denom]
            + [getattr(g, f) for g in (opt.mu, opt.nu) for f in GPU] + [opt.steps])
    ptrs = [t.data_ptr() for t in held]
    before = [t.clone() for t in held]
    try:
        s2, o2, ctx, out = t_clm.train_one_batch(state, opt, ctx, _cams(),
                                                 torch.from_numpy(gts), 3, T_LRS,
                                                 toptim.AdamConfig(), T_BG, W, H, cfg)
    finally:
        ctx.close()
    assert s2 is state and o2 is opt
    now = ([getattr(s2.params, f) for f in GPU] + [s2.xyz_grad_accum, s2.denom]
           + [getattr(g, f) for g in (o2.mu, o2.nu) for f in GPU] + [o2.steps])
    assert [t.data_ptr() for t in now] == ptrs
    assert all(not torch.equal(a, b) for a, b in zip(now, before))
    assert tuple(s2.params.sh.shape) == tuple(o2.mu.sh.shape) == (1, 48)


@pytest.mark.parametrize("block_rows", [7, 64, tG.PLY_BLOCK_ROWS])
@pytest.mark.parametrize("chunk_rows", [None, 20])
def test_streaming_ply_equals_reference_bytes(tmp_path, chunk_rows, block_rows):
    """The JAX `save_ply`'s files byte for byte, one file or `_rk{i}_ws{n}`
    files; the SH field a separate host tensor as clm's `materialize_host`
    gives it, the rest of the state beside it."""
    state_np, _, js, ts = _states()
    ts = tG.GaussianState(
        params=tG.GaussianParams(*ts.params.astuple()[:4],
                                 torch.from_numpy(state_np["params"]["sh"].copy())),
        alive=ts.alive, n_alive=ts.n_alive, xyz_grad_accum=ts.xyz_grad_accum,
        denom=ts.denom, max_radii2d=ts.max_radii2d)
    tG.save_ply(ts, str(tmp_path / "t.ply"), chunk_rows=chunk_rows, block_rows=block_rows)
    jG.save_ply(js, str(tmp_path / "j.ply"), chunk_rows=chunk_rows)
    names = sorted(os.listdir(tmp_path))
    t_names = [n for n in names if n.startswith("t")]
    assert [n.replace("t", "j", 1) for n in t_names] == [n for n in names
                                                         if n.startswith("j")]
    assert len(t_names) == (1 if chunk_rows is None else -(-ts.n_alive // chunk_rows))
    for n in t_names:
        with open(tmp_path / n, "rb") as a, open(tmp_path / n.replace("t", "j", 1),
                                                 "rb") as b:
            assert a.read() == b.read(), n


def test_eval_context_holds_no_training_state():
    """The renderer's context (adam_cfg None) keeps the SH rows alone, no
    gradient buffer and no moments, and renders what a training context
    renders."""
    state_np, _, _ = _inputs()
    cfg, state, _, train_ctx = _port_start(state_np)
    eval_ctx = t_clm.make_context_from_host(cfg, train_ctx.sh_host.clone(), None, "cpu")
    try:
        assert eval_ctx.sh_grad_host is None and eval_ctx.adam is None
        cb = _cams()
        train_img, eval_img = (
            t_clm.eval_one_cam((state, ctx), cb.viewmats[1], cb.Ks[1], cb.camtoworlds[1],
                               3, T_BG, W, H)[0] for ctx in (train_ctx, eval_ctx))
        assert torch.equal(train_img, eval_img)
    finally:
        train_ctx.close()
        eval_ctx.close()
