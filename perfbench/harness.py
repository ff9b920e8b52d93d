"""One run of one cell: set-up, the measured window (or, traced, a bounded
number of profiled batches), the check against the plain reference, and
the result line.

Everything a cell needs is found by name: the cell in BENCHMARK.json, its
configuration in configs/<config>.json, its traffic in
traffic/<traffic>.json, the check's limits in limits/<cell>.json, each
per-layer metric's reader in metrics/<metric>.py, and the scene generator a
configuration names in scenes/<kind>.py.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import statistics
import sys
import threading
import time
from pathlib import Path

import torch

from perfbench import check
from perfbench.cameras import make_cameras
from perfbench.reference import gs3d

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
RSS_SAMPLE_S = 0.05
FORBIDDEN = ("jax", "jaxlib", "flax", "clm_gs_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench: dict = None):
    """(the cell's entry, its configuration, its traffic) by name."""
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = load_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return cell, config, traffic


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metric_module(name: str):
    """metrics/<name>.py, loaded by path (names hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    """Loaded modules whose top-level name is a JAX package's, whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class RssSampler:
    """The process's resident set, sampled every RSS_SAMPLE_S on a thread."""

    def __init__(self):
        self.peak = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    @staticmethod
    def rss() -> int:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
        return 0

    def _run(self):
        while True:
            self.peak = max(self.peak, self.rss())
            if self._stop.wait(RSS_SAMPLE_S):
                return

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self.rss())


class Scene:
    """The configuration's Gaussians, cameras and targets, from the seed."""

    def __init__(self, config: dict, seed: int, device):
        self.config, self.seed, self.device = config, seed, torch.device(device)
        self.gen = importlib.import_module(f"perfbench.scenes.{config['scene']['kind']}")
        self.cams = make_cameras(config["cameras"], self.device)
        params, surfaces = self.gaussians()
        self.targets = self.gen.targets(config["scene"], surfaces, self.cams,
                                        self.cams["train"], self.device)
        self.first = params
        granule = config["capacity_granule"]
        self.capacity = -(-config["scene"]["n"] // granule) * granule
        # camera id -> its row of the target cache
        self.row = {int(c): r for r, c in enumerate(self.cams["train"].tolist())}

    def gaussians(self):
        g = torch.Generator(device=self.device).manual_seed(self.seed)
        return self.gen.gaussians(self.config["scene"], g, self.device)

    def gt(self, cam: int):
        return self.targets[self.row[cam]].float() / 255.0


class Feed:
    """Training batches: random cameras without replacement, epoch after
    epoch, drawn from the seed; each batch's learning rates follow the
    trainer's schedule from the traffic's first iteration."""

    def __init__(self, scene: Scene, traffic: dict, bsz: int, seed: int):
        self.scene, self.traffic, self.bsz = scene, traffic, bsz
        self.g = torch.Generator().manual_seed(seed)
        self.queue = []
        self.extent = scene.cams["extent"]

    def next_ids(self):
        while len(self.queue) < self.bsz:
            train = self.scene.cams["train"]
            self.queue += train[torch.randperm(len(train), generator=self.g)].tolist()
        ids, self.queue = self.queue[:self.bsz], self.queue[self.bsz:]
        return ids

    def rates(self, k: int) -> dict:
        """Learning rates of batch k (from 0), scaled by sqrt(bsz)."""
        lr = self.traffic["lr"]
        it = self.traffic["first_iteration"] + k * self.bsz
        t = min(max(it / lr["position_max_steps"], 0.0), 1.0)
        xyz = math.exp(math.log(lr["position_init"] * self.extent) * (1 - t)
                       + math.log(lr["position_final"] * self.extent) * t)
        s = math.sqrt(self.bsz)
        return {"xyz": xyz * s, "opacity": lr["opacity"] * s, "log_scale": lr["scaling"] * s,
                "quat": lr["rotation"] * s, "feature": lr["feature"] * s}

    def batch(self, ids):
        """(the port's CameraBatch, targets (B, 3, H, W) in [0, 1])."""
        from clm_gs_tpu_torch.data.cameras import CameraBatch

        c = self.scene.cams
        dev = self.scene.device
        i = torch.tensor(ids, dtype=torch.int64, device=dev)
        rows = torch.tensor([self.scene.row[x] for x in ids], dtype=torch.int64, device=dev)
        cb = CameraBatch(c["viewmats"][i], c["Ks"][i], c["camtoworlds"][i], c["width"],
                         c["height"])
        return cb, self.scene.targets[rows].float() / 255.0


def reference_lrs(rates: dict, device) -> dict:
    sh = torch.full((48,), rates["feature"] / 20.0, dtype=torch.float32, device=device)
    sh[:3] = rates["feature"]
    return {"xyz": rates["xyz"], "opacity": rates["opacity"],
            "log_scale": rates["log_scale"], "quat": rates["quat"], "sh": sh}


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def start(scene: Scene, traffic: dict, seed: int, device):
    """The program on the scene's first parameters, its feed, and `step(k,
    timers)`: batch k through the program, returning (the cameras the feed
    drew, the batch's rates, the port's StepOut)."""
    from perfbench.program import Program

    prog = Program(traffic, scene.first, scene.capacity, scene.cams["width"],
                   scene.cams["height"], device)
    feed = Feed(scene, traffic, prog.bsz, seed)

    def step(k, timers=None):
        ids = feed.next_ids()
        cb, gt = feed.batch(ids)
        rates = feed.rates(k)
        return ids, rates, prog.step(cb, gt, prog.lrs(rates), timers)

    return prog, feed, step


def check_steps(prog, step, p0: dict, n: int) -> check.ProgramReadings:
    """The check's first n steps, through the window's own call and feed."""
    seen = check.ProgramReadings(prog, p0, n)
    for k in range(n):
        ids, rates, o = step(k)
        seen.after_step(k + 1, ids, rates, o)
    return seen


def reference(scene: Scene, seen: check.ProgramReadings, bsz: int, traffic: dict,
              device, dtype=torch.float32) -> dict:
    """The reference over the check's steps, from the parameters the seed
    gives (drawn again)."""
    p0, _ = scene.gaussians()
    return gs3d.train(p0, [(ids, reference_lrs(r, device)) for ids, r in seen.steps],
                      scene.cams, scene.gt, torch.zeros(3, device=device), bsz,
                      "--sparse_adam" in traffic["flags"], dtype)


def free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run_cell(name: str, seed: int, seconds: float, traced: bool, device="cuda",
             config=None, traffic=None, t_start=None, bench=None, out=sys.stderr):
    """One run; returns the result dict (the line the benchmark prints).
    `config` and `traffic` override the cell's files (the tests' small
    sizes)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    _, cfg_file, trf_file = load_cell(name, bench)
    config = config or cfg_file
    traffic = traffic or trf_file
    dev = torch.device(device)

    marks = {"imports": time.perf_counter() - t_start}
    scene = Scene(config, seed, dev)
    sync(dev)
    marks["scene"] = time.perf_counter() - t_start
    prog, feed, step = start(scene, traffic, seed, dev)
    marks["program"] = time.perf_counter() - t_start
    W, H = scene.cams["width"], scene.cams["height"]
    n_check = traffic["check_steps"]
    seen = check_steps(prog, step, scene.first, n_check)
    scene.first = None
    marks["check_steps"] = time.perf_counter() - t_start
    k = n_check
    for _ in range(traffic["warm_batches"]):
        step(k)
        k += 1
    sync(dev)
    gc.collect()
    setup_s = time.perf_counter() - t_start
    marks["warm"] = setup_s

    metrics, device_info, extra = {}, {}, {}
    if dev.type == "cuda":
        device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                       "count": 1}
        torch.cuda.reset_peak_memory_stats()
    if not traced:
        times, isects = [], []
        with RssSampler() as rss:
            t0 = last = time.perf_counter()
            while True:
                _, _, o = step(k)
                float(o.losses.mean())  # train.py reads each batch's loss
                k += 1
                now = time.perf_counter()
                times.append(now - last)
                last = now
                isects.append(sum(o.n_isects) / len(o.n_isects))
                if now - t0 >= seconds:
                    break
            sync(dev)
            window_s = time.perf_counter() - t0
        pixels = len(times) * prog.bsz * W * H
        peak_dev = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        values = {"train_mpix_s": (pixels / window_s / 1e6, "Mpix/s"),
                  "peak_device_gb": (peak_dev / 1e9, "GB"),
                  "peak_host_gb": (rss.peak / 1e9, "GB"),
                  "setup_s": (setup_s, "s")}
        for m in bench["end_to_end"]:
            # a metric split by family of cells (`train_mpix_s.card`) is
            # the quantity its name starts with
            base = m["name"].split(".")[0]
            if applies(m, name) and base in values:
                v, unit = values[base]
                metrics[m["name"]] = {"value": v, "unit": unit}
        attempted = len(times)
        extra = {"batches": len(times), "batch_s_median": statistics.median(times),
                 "batch_s_min": min(times), "batch_s_max": max(times),
                 "isects_per_camera_first": isects[0], "isects_per_camera_last": isects[-1]}
    else:
        from perfbench import layers

        res = layers.traced(prog, step, k, traffic, bench, name)
        metrics = res["metrics"]
        device_info.update(res["device"])
        attempted = res["batches"]
        extra = {"breakdown": res["breakdown"]}
    # the peak since warm-up, over the window in either mode
    device_info["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                        if dev.type == "cuda" else 0)
    prog.close()
    del prog, step
    free(dev)

    t_ref = time.perf_counter()
    readings = check.readings(seen.result(), reference(scene, seen, feed.bsz, traffic, dev))
    marks["reference_s"] = time.perf_counter() - t_ref
    checks, correct = check.judge(readings, check.limits(name))
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of a JAX package are loaded: {found}")
    result = {"correct": correct, "attempted": attempted, "failed": 0, "metrics": metrics,
              "device": device_info}
    if "breakdown" in extra:
        result["breakdown"] = extra.pop("breakdown")
    result["checks"] = checks
    extra["setup_marks_s"] = marks
    extra["losses"] = seen.losses
    for key, v in extra.items():
        print(f"info {key} {v!r}", file=out)
    for key, c in checks.items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}", file=out)
    return result
