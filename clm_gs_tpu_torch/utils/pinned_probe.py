"""How the pinned transport's kernels scale with the table and their grid,
and what they take from the card's other work.

    python3 -m clm_gs_tpu_torch.utils.pinned_probe [--rows R ...] [--sweep_rows R ...] [--n N]

Tables are pinned (R, 48) float32 tables, as clm's `sh_host` and
`sh_grad_host` are. Kernels: the gather (csrc/pinned_gather.cu), the scatter
adding and storing (csrc/pinned_scatter.cu), each timed with CUDA events on
N ids: `spread`, N distinct ids drawn over the whole table and sorted (a
camera's visible ids are ascending), or `block`, N consecutive rows. The
probe

- sweeps each kernel's grid (SWEEP_BLOCKS blocks, hostmem.pinned_grid) and
  per-lane depth (DEPTHS: each source built again with -DPINNED_DEPTH=d,
  `variants`) on the spread ids of each --sweep_rows table
  (`hostmem.pinned_zeros`, as clm makes its tables), and names the smallest
  grid within 10% of the best time on every table (`choice`;
  hostmem.GATHER_BLOCKS and SCATTER_BLOCKS weigh it with other hosts'
  sweeps and `beside_grids`, PERF.md §6);
- times the kernels as clm launches them (`hostmem`'s wrappers) on each
  --rows table, both layouts, on a table of 4 KiB pages and on one of 2 MiB
  pages (`hostmem._huge_zeros`, which `pinned_zeros` takes from 1 GiB up),
  with the process's `AnonHugePages` (/proc/self/smaps_rollup, -1 where the
  host has none) before and after each;
- times a stream of float32 matmuls (the card's own work) alone and beside
  each kernel on another stream (`beside`): `once`, one launch just before
  the matmuls, and `stream`, the kernel launched back to back through the
  matmuls' whole time. `beside_grids`: on the smallest table, at
  BESIDE_GRIDS and at 8 blocks of 256 threads on every SM (the previous
  design's grid); `beside`: as clm launches them, on the smallest and the
  largest table, with either page size.

Prints one JSON line: the card and its power limit, the bus bound, and the
above. On the card only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

ROWS = (1_048_576, 25_034_752, 102_236_160)
SWEEP_ROWS = (1_048_576, 25_034_752)
SWEEP_BLOCKS = (2, 4, 8, 16, 32, 66, 132)
DEPTHS = (1, 2, 4, 8)
IDS = 800_000
ROW_BYTES = 192
PEAK_PCIE = 64e9  # PCIe Gen5 x16, a direction (NVIDIA data sheet)
WITHIN = 1.10  # the sweep's choice: the smallest grid within 10% of the best
SOURCES = ("pinned_gather", "pinned_scatter")
# (blocks, depth) of `beside_grids` besides 8 blocks of 256 threads an SM (the
# previous design's grid)
BESIDE_GRIDS = ((4, 1), (4, 2), (8, 2), (8, 4), (16, 2), (16, 8))
BESIDE_ROUNDS = 5


def _time_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _ids(rows: int, n: int, layout: str, gen) -> torch.Tensor:
    if layout == "block":
        first = int(torch.randint(0, rows - n + 1, (1,), generator=gen))
        return torch.arange(first, first + n, dtype=torch.int32, device="cuda")
    return torch.randperm(rows, generator=gen)[:n].sort().values.int().cuda()


_variants: dict = {}


def variants(depths=DEPTHS) -> dict:
    """{(source, depth): library} of both kernels built at each depth
    (-DPINNED_DEPTH=d) into csrc/build/lib<source>_d<d>.so, one nvcc a
    library, all started together; a library is built once a process."""
    from clm_gs_tpu_torch import _build

    todo = [(s, d) for s in SOURCES for d in depths if (s, d) not in _variants]
    if todo:
        _build.BUILD.mkdir(parents=True, exist_ok=True)
        nvcc = _build._nvcc()
        procs = {}
        for s, d in todo:
            so = _build.BUILD / f"lib{s}_d{d}.so"
            cmd = [nvcc, *_build.NVCC_FLAGS, f"-DPINNED_DEPTH={d}", "-I", str(_build.CSRC),
                   "-o", str(so), str(_build.CSRC / f"{s}.cu")]
            procs[s, d] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True))
        failed = []
        for key, (so, p) in procs.items():
            out, _ = p.communicate()
            if p.returncode:
                failed.append(f"{key}:\n{out}")
            else:
                _variants[key] = ctypes.CDLL(str(so))
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {(s, d): _variants[s, d] for s in SOURCES for d in depths}


def variant_kernels(table, src, ids, blocks: int, depth: int, n_store: int = 0) -> dict:
    """name -> a launch of that kernel on `ids` in at most `blocks` blocks
    of the depth-`depth` build (`variants`), on the current stream; the
    scatter adds `src`, its first n_store rows stored."""
    from clm_gs_tpu_torch import _build
    from clm_gs_tpu_torch.utils import hostmem

    libs = variants((depth,))
    n = ids.numel()
    grid = hostmem.pinned_grid(n, blocks)
    dev = ids.device
    table_ptr = ctypes.c_void_p(hostmem._device_address(table, dev))
    head = (table_ptr, table.shape[0], _build.ptr(ids), int(ids.dtype == torch.int64), n)
    gather = libs["pinned_gather", depth].clmgs_pinned_gather
    gather.argtypes, gather.restype = hostmem._ARGTYPES, ctypes.c_int
    scatter = libs["pinned_scatter", depth].clmgs_pinned_scatter
    scatter.argtypes, scatter.restype = hostmem._SCATTER_ARGTYPES, ctypes.c_int

    def call(f, *args):
        err = f(*head, *args, *grid, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        if err:
            raise RuntimeError(f"launch of {f.__name__} failed: cudaError {err}")

    def do_gather():
        out = torch.empty((n, hostmem.COLS), device=dev)
        call(gather, _build.ptr(out))
        return out

    return {
        "gather": do_gather,
        "scatter_add": lambda: call(scatter, _build.ptr(src), 1, n_store),
        "scatter_store": lambda: call(scatter, _build.ptr(src), 0, 0),
    }


def _kernels(table, src, ids) -> dict:
    """name -> a call of that kernel on `ids` as clm launches it."""
    from clm_gs_tpu_torch.utils import hostmem

    return {
        "gather": lambda: hostmem.gather_rows_pinned_cuda(table, ids),
        "scatter_add": lambda: hostmem.scatter_add_rows_pinned_cuda(table, src, ids),
        "scatter_store": lambda: hostmem.scatter_add_rows_pinned_cuda(table, src, ids, False),
    }


def _table(rows: int, pages: str) -> torch.Tensor:
    """A registered (rows, 48) zero table of 4 KiB pages (`4k_pages`) or of
    2 MiB-aligned memory advised as huge pages (`huge_pages`)."""
    from clm_gs_tpu_torch.utils import hostmem

    if pages == "huge_pages":
        arr = hostmem._huge_zeros(rows * ROW_BYTES).view(np.float32).reshape(rows, 48)
    else:
        arr = np.zeros((rows, 48), np.float32)
    return hostmem.register(arr)


def _anon_huge_kb() -> int:
    try:
        with open("/proc/self/smaps_rollup") as f:
            for line in f:
                if line.startswith("AnonHugePages:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return -1


def _thp_mode() -> str:
    try:
        with open("/sys/kernel/mm/transparent_hugepage/enabled") as f:
            return f.read().strip()
    except OSError:
        return "unknown"


def sweep(rows, n: int, src, gen) -> dict:
    """Each kernel's ms over SWEEP_BLOCKS x DEPTHS on the spread ids of each
    table, and the choice: the smallest blocks, then depth, within WITHIN
    of the best time on every table."""
    from clm_gs_tpu_torch.utils import hostmem

    variants()
    times = {}
    for r in rows:
        table = hostmem.pinned_zeros((r, 48))
        ids = _ids(r, n, "spread", gen)
        res = times[str(r)] = {}
        for blocks in SWEEP_BLOCKS:
            for depth in DEPTHS:
                for name, fn in variant_kernels(table, src, ids, blocks, depth).items():
                    res.setdefault(name, {})[f"{blocks}x{depth}"] = _time_ms(fn)
        del table
    choice = {}
    for name in ("gather", "scatter_add", "scatter_store"):
        best = {r: min(t[name].values()) for r, t in times.items()}
        ok = [(b, d) for b in SWEEP_BLOCKS for d in DEPTHS
              if all(t[name][f"{b}x{d}"] <= WITHIN * best[r] for r, t in times.items())]
        b, d = ok[0]
        choice[name] = {"blocks": b, "depth": d, "best_ms": best,
                        "ms": {r: t[name][f"{b}x{d}"] for r, t in times.items()}}
    return {"ms": times, "choice": choice}


def probe(rows=ROWS, n: int = IDS, matmuls: int = 40, sweep_rows=SWEEP_ROWS) -> dict:
    from clm_gs_tpu_torch import _build
    from clm_gs_tpu_torch.utils import hostmem
    from clm_gs_tpu_torch.utils.general import check_device, nvidia_smi

    check_device("cuda")
    _build.build(SOURCES)
    gen = torch.Generator().manual_seed(0)
    src = torch.rand((n, 48), device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {"card": nvidia_smi(), "sms": sms, "ids": n,
           "bound_ms": n * ROW_BYTES / PEAK_PCIE * 1e3,
           # (blocks, rows_per_block) of clm's launches; the depths are the
           # sources' PINNED_DEPTH
           "grid": {"gather": hostmem.pinned_grid(n, hostmem.launch_blocks(
                        sms, hostmem.GATHER_BLOCKS)),
                    "scatter": hostmem.pinned_grid(n, hostmem.launch_blocks(
                        sms, hostmem.SCATTER_BLOCKS))},
           "thp": _thp_mode(), "tables": {}}
    if sweep_rows:
        out["sweep"] = sweep(sweep_rows, n, src, gen)
    out["beside"] = {}
    for r in rows:
        res = out["tables"][str(r)] = {}
        for pages in ("4k_pages", "huge_pages"):
            before = _anon_huge_kb()
            table = _table(r, pages)
            res[pages] = {"anon_huge_kb": [before, _anon_huge_kb()]}
            for layout in ("spread", "block") if pages == "4k_pages" else ("spread",):
                ids = _ids(r, n, layout, gen)
                ms = {k: _time_ms(fn) for k, fn in _kernels(table, src, ids).items()}
                res[pages][layout] = {**{f"{k}_ms": v for k, v in ms.items()},
                                      **{f"{k}_ns_a_row": v * 1e6 / n for k, v in ms.items()}}
            ids = _ids(r, n, "spread", gen)
            if r == min(rows) and pages == "4k_pages":
                # the card's other work beside each grid: the tradeoff the
                # scatter's grid was chosen on
                out["beside_grids"] = {
                    f"{b}x{d}": beside(variant_kernels(table, src, ids, b, d), matmuls)
                    for b, d in BESIDE_GRIDS + ((8 * sms, 1),)}
            if r in (min(rows), max(rows)):
                out["beside"][f"{r}_{pages}"] = beside(_kernels(table, src, ids), matmuls)
            del table
    return out


def beside(kernels: dict, matmuls: int, names=None) -> dict:
    """The matmuls' ms on the current stream alone and beside each of
    `kernels` (name -> launch; `names`, default all) on a side stream:
    `once` (one launch first) and `stream` (launches back to back through
    the matmuls' time), in BESIDE_ROUNDS rounds of alone, once, stream.
    Each ratio is the median beside over the median alone;
    `stream_kernel_ratio` the side stream's median ms over its launches'
    median ms alone."""
    a = torch.rand((4096, 4096), device="cuda")

    def work():
        for _ in range(matmuls):
            torch.mm(a, a)

    def timed(count, fn):
        """(matmuls' ms, side stream's ms) with `count` launches of `fn`
        on the side stream."""
        t = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        with torch.cuda.stream(side):
            t[2].record(side)
            for _ in range(count):
                fn()
            t[3].record(side)
        t[0].record()
        work()
        t[1].record()
        torch.cuda.synchronize()
        return t[0].elapsed_time(t[1]), t[2].elapsed_time(t[3])

    side = torch.cuda.Stream()
    work_ms = _time_ms(work, reps=1)
    recs = {}
    for name, fn in kernels.items():
        if names is not None and name not in names:
            continue
        k_ms = [_time_ms(fn, reps=1) for _ in range(BESIDE_ROUNDS)]
        recs[name] = {"kernel_alone_ms": k_ms,
                      "stream_launches": max(1, int(work_ms / statistics.median(k_ms))),
                      "once_ms": [], "stream_ms": [], "stream_kernel_ms": []}
    alone_ms = []
    for _ in range(BESIDE_ROUNDS):
        alone_ms.append(timed(0, None)[0])
        for name, rec in recs.items():
            rec["once_ms"].append(timed(1, kernels[name])[0])
            m_ms, s_ms = timed(rec["stream_launches"], kernels[name])
            rec["stream_ms"].append(m_ms)
            rec["stream_kernel_ms"].append(s_ms)
    alone = statistics.median(alone_ms)
    for rec in recs.values():
        rec["once_ratio"] = statistics.median(rec["once_ms"]) / alone
        rec["stream_ratio"] = statistics.median(rec["stream_ms"]) / alone
        rec["stream_kernel_ratio"] = (statistics.median(rec["stream_kernel_ms"])
                                      / (rec["stream_launches"]
                                         * statistics.median(rec["kernel_alone_ms"])))
    return {"matmuls": matmuls, "alone_ms": alone_ms, **recs}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, nargs="+", default=list(ROWS))
    ap.add_argument("--sweep_rows", type=int, nargs="*", default=list(SWEEP_ROWS))
    ap.add_argument("--n", type=int, default=IDS)
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    res = probe(args.rows, args.n, sweep_rows=args.sweep_rows)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
