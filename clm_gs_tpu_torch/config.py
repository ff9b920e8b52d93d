"""Configuration (clm_gs_tpu/config.py; the port's own copy).

Typed dataclasses with auto-generated argparse flags: the same seven groups,
flag names, defaults and validation as the JAX package, so the same command
lines run either package. Knobs that exist for the TPU or for several chips
(`mesh_shape`, `shard_gaussians`, `dist_*`, `pinned_host`, `gather_cap`,
`isect_cap`, `isect_margin`) are accepted and ignored by the port, which runs
on one card and sizes its instance buffers to the true count; so are the
reference's CUDA knobs that the JAX package ignores too.

The parsed `Config` is passed explicitly; there is no process-global state.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class AuxiliaryParams:
    # strategy selection (exactly one; arguments/__init__.py:75-83)
    no_offload: bool = False
    naive_offload: bool = False
    clm_offload: bool = False
    prealloc_capacity: int = -1  # -1 = next_capacity of the initial count
    sparse_adam: bool = False
    dataset_cache_and_stream_mode: str = "load_from_disk_on_demand"
    decode_dataset_path: str = ""
    multiprocesses_decode_dataset_to_disk: bool = True
    num_workers: int = 0
    llffhold: int = 8
    initial_point_cloud_downsampled_ratio: float = 1.0
    load_ply_path: str = ""
    load_pt_path: str = ""
    # alternative init point cloud for COLMAP scenes (dataset_readers.py:221-225)
    dense_ply_file: str = ""
    start_checkpoint: str = ""
    auto_start_checkpoint: bool = False
    log_folder: str = "/tmp/clm_gs_tpu"
    log_interval: int = 250
    quiet: bool = False
    test_iterations: List[int] = field(default_factory=lambda: [7_000, 30_000])
    save_iterations: List[int] = field(default_factory=list)
    checkpoint_iterations: List[int] = field(default_factory=list)
    matrixcity_ocean_mask: bool = False
    num_save_images_during_eval: int = 0
    # clm_offload: the priority of its copy stream, and the sparsest
    # camera of a batch last in the TSP order
    comm_stream_priority: int = -1
    reorder_by_min_sparsity_at_end: bool = True
    # knobs of the reference's CUDA code, accepted and ignored:
    grid_size_H: int = 32
    grid_size_D: int = 128
    gpu: int = 0
    # torch-DataLoader knobs, ignored: the loader is a prefetching thread
    # pool (num_workers) over the raw predecode cache
    multiprocesses_image_loading: bool = False
    sharing_strategy: str = "default"
    # image-load timing is the enable_timer `data_next` key
    time_image_loading: bool = False


@dataclass
class ModelParams:
    sh_degree: int = 3
    radius_clip: float = 0.0
    source_path: str = ""
    model_path: str = "/tmp/clm_gs_tpu"
    images: str = "images"
    white_background: bool = False
    eval: bool = False
    # declared and unused, as in the reference
    load_ply_max: int = 1_000_000
    reinit_ply: bool = False


@dataclass
class PipelineParams:
    debug: bool = False
    # packed (nnz-list) projection, ignored: culling is a dense radius mask
    # over the fixed-capacity rows
    packed: bool = False


@dataclass
class OptimizationParams:
    iterations: int = 30_000
    position_lr_init: float = 1.6e-4
    position_lr_final: float = 1.6e-6
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 2.5e-3
    opacity_lr: float = 0.05
    scaling_lr: float = 5e-3
    rotation_lr: float = 1e-3
    # uniform multiplier on the photometric loss (and so on all gradients)
    lr_scale_loss: float = 1.0
    lr_scale_pos_and_scale: float = 1.0
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 2e-4
    disable_auto_densification: bool = False
    random_background: bool = False
    min_opacity: float = 0.005
    lr_scale_mode: str = "sqrt"  # "linear" | "sqrt" | "accumu"
    bsz: int = 1
    num_train_cameras: int = -1
    num_test_cameras: int = -1
    max_num_images_to_evaluate: int = 1000


@dataclass
class BenchmarkParams:
    enable_timer: bool = False
    end2end_time: bool = True
    check_gpu_memory: bool = False
    check_cpu_memory: bool = False
    # clm_offload's overlap meter every batch, not only at log lines
    log_cpu_adam_trailing_overhead: bool = False
    # memory debug knobs, ignored: --check_gpu_memory logs the peak and live
    # bytes, --profile traces with torch.profiler
    log_memory_summary: bool = False
    reset_each_iter: bool = False


@dataclass
class DebugParams:
    stop_update_param: bool = False
    profile: bool = False  # torch.profiler trace (the --nsys_profile analogue)
    profile_start_iter: int = 1
    profile_end_iter: int = 1_000_000
    do_not_save: bool = False
    save_tensors: bool = False
    seed: int = 0
    drop_initial_3dgs_p: float = 0.0  # randomly drop this fraction of init points
    # resize on resume: rows arange(n * coeff) % n
    drop_duplicate_gaussians_coeff: float = 1.0
    stop_update_param_assert: bool = True
    # NaN tripwire: torch.autograd anomaly detection
    detect_anomaly: bool = False
    # declared and unused, as in the reference
    debug_from: int = -1
    exact_filter: bool = True
    # memory-history snapshots, ignored; use --profile
    trace_cuda_mem: bool = False
    # reference profiler window flags — aliases of --profile{,_start_iter,_end_iter}
    nsys_profile: bool = False
    nsys_profile_start_iter: int = 1
    nsys_profile_end_iter: int = 1_000_000


@dataclass
class TpuParams:
    """The JAX package's own knobs. The port uses `capacity_granule`,
    `eval_res_cap`, `gt_device_cache_mb` and clm_offload's `retention`; it
    accepts and ignores the multi-chip and TPU ones (`mesh_shape`,
    `shard_gaussians`, `dist_*`, `isect_cap`, `isect_margin`, `gather_cap`)
    and `pinned_host` (the host SH buffer is pinned already; the card-side
    gather from mapped memory is not ported, and the run's log says so)."""

    mesh_shape: str = ""
    shard_gaussians: bool = True
    dist_coordinator: str = ""
    dist_num_processes: int = 0
    dist_process_id: int = -1
    isect_cap: int = 2 ** 20
    isect_margin: float = 1.05
    gather_cap: int = 2 ** 20
    capacity_granule: int = 65_536  # capacity lattice of next_capacity
    retention: bool = True
    pinned_host: bool = False
    # cap the longer image side during eval renders (integer downsample of
    # render and GT); 0 = full resolution
    eval_res_cap: int = 0
    # uint8 ground-truth cache on the card (MB): when the whole train set
    # fits, it is uploaded once and each batch is gathered and normalised on
    # the card. 0 disables it; batches then come from the loader's threads.
    gt_device_cache_mb: int = 2048


@dataclass
class Config:
    aux: AuxiliaryParams = field(default_factory=AuxiliaryParams)
    model: ModelParams = field(default_factory=ModelParams)
    pipeline: PipelineParams = field(default_factory=PipelineParams)
    opt: OptimizationParams = field(default_factory=OptimizationParams)
    bench: BenchmarkParams = field(default_factory=BenchmarkParams)
    debug: DebugParams = field(default_factory=DebugParams)
    tpu: TpuParams = field(default_factory=TpuParams)

    @property
    def strategy(self) -> str:
        if self.aux.no_offload:
            return "no_offload"
        if self.aux.naive_offload:
            return "naive_offload"
        return "clm_offload"


_SHORTHAND = {"source_path": "-s", "model_path": "-m", "images": "-i"}


def add_group_args(parser: argparse.ArgumentParser, cls) -> None:
    for f in dataclasses.fields(cls):
        default = (
            f.default
            if f.default is not dataclasses.MISSING
            else f.default_factory()
        )
        flags = [f"--{f.name}"]
        if f.name in _SHORTHAND:
            flags.append(_SHORTHAND[f.name])
        if f.type in ("bool", bool):
            parser.add_argument(
                *flags, action=argparse.BooleanOptionalAction, default=default
            )
        elif isinstance(default, list):
            parser.add_argument(*flags, nargs="+", type=int, default=default)
        elif f.type in ("int", int):
            parser.add_argument(*flags, type=int, default=default)
        elif f.type in ("float", float):
            parser.add_argument(*flags, type=float, default=default)
        else:
            parser.add_argument(*flags, type=str, default=default)


def _extract(cls, ns: argparse.Namespace):
    return cls(**{f.name: getattr(ns, f.name) for f in dataclasses.fields(cls)})


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("clm_gs_tpu_torch training")
    for cls in (
        AuxiliaryParams, ModelParams, PipelineParams, OptimizationParams,
        BenchmarkParams, DebugParams, TpuParams,
    ):
        add_group_args(parser, cls)
    return parser


def parse_config(argv: Optional[List[str]] = None) -> Config:
    ns = build_parser().parse_args(argv)
    cfg = Config(
        aux=_extract(AuxiliaryParams, ns),
        model=_extract(ModelParams, ns),
        pipeline=_extract(PipelineParams, ns),
        opt=_extract(OptimizationParams, ns),
        bench=_extract(BenchmarkParams, ns),
        debug=_extract(DebugParams, ns),
        tpu=_extract(TpuParams, ns),
    )
    init_config(cfg)
    return cfg


def init_config(cfg: Config) -> Config:
    """Validation and derived fields."""
    n_strategies = sum(
        [cfg.aux.no_offload, cfg.aux.naive_offload, cfg.aux.clm_offload]
    )
    if n_strategies == 0:
        cfg.aux.clm_offload = True
    elif n_strategies > 1:
        raise ValueError("exactly one of --no_offload/--naive_offload/--clm_offload")
    if cfg.aux.dataset_cache_and_stream_mode != "load_from_disk_on_demand":
        # the raw-disk-cache mode is the only one implemented
        raise ValueError(
            "only dataset_cache_and_stream_mode=load_from_disk_on_demand "
            f"is supported (got {cfg.aux.dataset_cache_and_stream_mode!r})"
        )
    if cfg.debug.nsys_profile:
        # the reference's profiler flags alias the --profile window, unless
        # --profile_start/end_iter narrowed it already
        cfg.debug.profile = True
        if cfg.debug.profile_start_iter == 1:
            cfg.debug.profile_start_iter = cfg.debug.nsys_profile_start_iter
        if cfg.debug.profile_end_iter == 1_000_000:
            cfg.debug.profile_end_iter = cfg.debug.nsys_profile_end_iter
    cfg.aux.test_iterations = sorted(cfg.aux.test_iterations)
    cfg.aux.save_iterations = sorted(set(cfg.aux.save_iterations))
    if cfg.opt.iterations not in cfg.aux.save_iterations and not cfg.debug.do_not_save:
        cfg.aux.save_iterations.append(cfg.opt.iterations)
    cfg.aux.log_folder = cfg.model.model_path
    if not cfg.aux.decode_dataset_path:
        cfg.aux.decode_dataset_path = os.path.join(cfg.model.model_path, "decoded")
    return cfg


def save_config(cfg: Config, path: str) -> None:
    """args.json of the run's configuration."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)


def load_config(path: str) -> Config:
    with open(path) as f:
        d = json.load(f)

    def mk(cls, sub):
        # tolerate args.json written by other versions (extra or renamed knobs)
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in sub.items() if k in names})

    return Config(
        aux=mk(AuxiliaryParams, d["aux"]), model=mk(ModelParams, d["model"]),
        pipeline=mk(PipelineParams, d["pipeline"]), opt=mk(OptimizationParams, d["opt"]),
        bench=mk(BenchmarkParams, d["bench"]), debug=mk(DebugParams, d["debug"]),
        tpu=mk(TpuParams, d["tpu"]),
    )
