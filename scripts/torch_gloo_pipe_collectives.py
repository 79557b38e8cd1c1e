"""The first and later gloo collectives on CUDA tensors of three ranks
sharing cuda:0, as chip_smoke.py phase 16's world runs them: a 16 MB
hand-off between adjacent stages (parallel/sharding.pipe_handoff), and
all_reduces over the pipe group of 256 MB and of the 1.24 GB fp32
embedding gradient (whole and in 64 MB pieces), each timed between
barriers.

    python scripts/torch_gloo_pipe_collectives.py   # on a machine with an NVIDIA GPU
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from infinitevl_tpu_torch.parallel.launch import spawn_ranks  # noqa: E402


def body(rank, world):
    import torch.distributed as dist
    from infinitevl_tpu_torch.parallel import sharding as sh
    dev = torch.device("cuda", 0)
    out = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out[name] = round(time.perf_counter() - t0, 3)

    def handoffs():  # stage 0 -> 1, then 1 -> 2
        if rank < 2:
            sh.pipe_handoff(small, 0, 0)
        if rank > 0:
            sh.pipe_handoff(small, 1, 1)

    def chunked():
        flat = big.view(-1)
        for i in range(0, flat.numel(), 16 * 2**20):
            sh.all_reduce_sum(flat[i:i + 16 * 2**20], sh.PIPE)

    mesh = sh.create_pp_mesh(3)
    with sh.use_mesh(mesh):
        small = torch.ones(4 * 2**20, device=dev)  # 16 MB
        timed("pair_bcast_16MB_1", handoffs)
        timed("pair_bcast_16MB_2", handoffs)
        mid = torch.ones(64 * 2**20, device=dev)  # 256 MB
        timed("allreduce_256MB_1", lambda: sh.all_reduce_sum(mid, sh.PIPE))
        timed("allreduce_256MB_2", lambda: sh.all_reduce_sum(mid, sh.PIPE))
        big = torch.ones(151936 * 2048, device=dev)  # 1.24 GB fp32
        timed("allreduce_1.24GB_1", lambda: sh.all_reduce_sum(big, sh.PIPE))
        timed("allreduce_1.24GB_2", lambda: sh.all_reduce_sum(big, sh.PIPE))
        timed("allreduce_1.24GB_chunks_64MB_1", chunked)
        timed("allreduce_1.24GB_chunks_64MB_2", chunked)
        t0 = time.perf_counter()
        torch.empty(2**30, dtype=torch.uint8).pin_memory()
        out["pin_1GB"] = round(time.perf_counter() - t0, 3)
    return out


if __name__ == "__main__":
    print(os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip())
    t0 = time.perf_counter()
    res = spawn_ranks(body, 3, device="cuda:0", timeout=600)
    for r in res:
        print(r)
    print("world", round(time.perf_counter() - t0, 1))
