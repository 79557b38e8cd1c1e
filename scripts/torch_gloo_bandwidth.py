#!/usr/bin/env python3
"""Seconds of the port's collectives between two gloo ranks sharing one CUDA
card (what chip_smoke.py phase 14 runs on): all_gather_into_tensor,
reduce_scatter_tensor and all_reduce of one InfiniteVL-3B decoder layer's
bf16 weights (77 M elements, 154 MB a rank), and the all_gather of CPU
tensors for comparison. Prints one JSON line per rank.

    python3 scripts/torch_gloo_bandwidth.py [--reps 3]
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LAYER_ELEMENTS = 77 * 1024 * 1024


def _timed(fn, reps: int) -> float:
    import torch.distributed as dist

    fn()
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def _rank(rank: int, world: int, reps: int) -> dict:
    import torch.distributed as dist

    n = LAYER_ELEMENTS
    x = torch.ones(n, device="cuda", dtype=torch.bfloat16)
    out = torch.empty(n * world, device="cuda", dtype=torch.bfloat16)
    part = torch.empty(n // world, device="cuda", dtype=torch.bfloat16)
    xc, oc = x.cpu(), out.cpu()
    return {
        "rank": rank, "mb_per_rank": n * 2 / 1e6, "reps": reps,
        "all_gather_cuda_s": _timed(lambda: dist.all_gather_into_tensor(out, x), reps),
        "reduce_scatter_cuda_s": _timed(lambda: dist.reduce_scatter_tensor(part, x), reps),
        "all_reduce_cuda_s": _timed(lambda: dist.all_reduce(x), reps),
        "all_gather_cpu_s": _timed(lambda: dist.all_gather_into_tensor(oc, xc), reps),
        "card": torch.cuda.get_device_name(0),
    }


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_gloo_bandwidth: needs a CUDA card", file=sys.stderr)
        return 2
    from infinitevl_tpu_torch.parallel.launch import spawn_ranks

    reps = int(argv[argv.index("--reps") + 1]) if "--reps" in argv else 3
    for res in spawn_ranks(_rank, 2, (reps,), device="cuda:0", timeout=600.0):
        print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
