"""How the pinned transport's kernels scale with the table, and what they
take from the card's other work.

    python3 -m clm_gs_tpu_torch.utils.pinned_probe [--rows R ...] [--n N]

For each table of R rows (a pinned (R, 48) float32 table, `hostmem.pinned_zeros`,
as clm's `sh_host` and `sh_grad_host` are) the gather
(`gather_rows_pinned_cuda`, csrc/pinned_gather.cu) and the adding scatter
(`scatter_add_rows_pinned_cuda`, csrc/pinned_scatter.cu) are timed with CUDA
events on N ids of two layouts: `spread`, N distinct ids drawn over the whole
table and sorted (a camera's visible ids are ascending), and `block`, N
consecutive rows. Then, on the largest table, a stream of float32 matmuls
(the card's own work) is timed alone and with the scatter of the `spread`
ids launched just before it on another stream. Prints one JSON line: the
card and its power limit, each kernel's ms and ns a row by table and layout,
the bus bound, and the matmuls' ms alone and beside the scatter. On the card
only.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

ROWS = (1_048_576, 25_034_752, 102_236_160)
IDS = 800_000
ROW_BYTES = 192
PEAK_PCIE = 64e9  # PCIe Gen5 x16, a direction (NVIDIA data sheet)


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


def probe(rows=ROWS, n: int = IDS, matmuls: int = 40) -> dict:
    from clm_gs_tpu_torch import _build
    from clm_gs_tpu_torch.utils import hostmem
    from clm_gs_tpu_torch.utils.general import check_device, nvidia_smi

    check_device("cuda")
    _build.build(("pinned_gather", "pinned_scatter"))
    gen = torch.Generator().manual_seed(0)
    src = torch.rand((n, 48), device="cuda")
    out = {"card": nvidia_smi(), "ids": n,
           "bound_ms": n * ROW_BYTES / PEAK_PCIE * 1e3, "tables": {}}
    for r in rows:
        table = hostmem.pinned_zeros((r, 48))
        res = {}
        for layout in ("spread", "block"):
            ids = _ids(r, n, layout, gen)
            g = _time_ms(lambda: hostmem.gather_rows_pinned_cuda(table, ids))
            s = _time_ms(lambda: hostmem.scatter_add_rows_pinned_cuda(table, src, ids))
            res[layout] = {"gather_ms": g, "scatter_ms": s,
                           "gather_ns_a_row": g * 1e6 / n, "scatter_ns_a_row": s * 1e6 / n}
        out["tables"][str(r)] = res
        if r == max(rows):
            out["beside_scatter"] = _beside(table, src, _ids(r, n, "spread", gen), matmuls)
        del table
    return out


def _beside(table, src, ids, matmuls: int) -> dict:
    """The matmuls' ms on the current stream alone, then with the scatter
    launched first on a side stream."""
    from clm_gs_tpu_torch.utils import hostmem

    a = torch.rand((4096, 4096), device="cuda")

    def work():
        for _ in range(matmuls):
            torch.mm(a, a)

    alone = _time_ms(work, reps=3)
    side = torch.cuda.Stream()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        with torch.cuda.stream(side):
            hostmem.scatter_add_rows_pinned_cuda(table, src, ids)
        start.record()
        work()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    scatter = _time_ms(lambda: hostmem.scatter_add_rows_pinned_cuda(table, src, ids), reps=3)
    return {"matmuls": matmuls, "alone_ms": alone, "beside_scatter_ms": times,
            "scatter_alone_ms": scatter}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, nargs="+", default=list(ROWS))
    ap.add_argument("--n", type=int, default=IDS)
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    res = probe(args.rows, args.n)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
