"""Spawn a world of ranks on one machine and join them with a deadline.

`spawn_ranks(fn, world)` starts `world` processes (multiprocessing spawn),
each with its torch.distributed group over a file:// rendezvous, runs
`fn(rank, world, *args)` in each and returns their results in rank order.
A rank that raises, exits non-zero or is still running at the deadline
fails the launch: every rank still alive is killed and the error names the
rank and carries its traceback. Nothing is retried or run in fewer ranks.

torchrun is the launch for a training run (`torchrun --nproc_per_node N -m
infinitevl_tpu_torch.cli train recipe.yaml`, N = data_parallel x
model_parallel); this is for programs that drive several worlds in one run
(the tests, chip_smoke.py). A world of `data x model` ranks makes its
(data, model) mesh with parallel/sharding.create_mesh."""

from __future__ import annotations

import multiprocessing as mp
import os
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch


def _rank_main(fn, rank: int, world: int, init: str, backend: str, device: str,
               threads: Optional[int], out_dir: str, args: Sequence[Any]) -> None:
    import torch.distributed as dist

    from . import sharding

    try:
        if threads:
            torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init, world_size=world, rank=rank)
        sharding._distributed_initialized = True
        result = fn(rank, world, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn_ranks(fn: Callable, world: int, args: Sequence[Any] = (), *, backend: str = "gloo",
                device: str = "cpu", timeout: float = 600.0, threads: Optional[int] = None,
                workdir: Optional[str] = None) -> List[Any]:
    """fn(rank, world, *args) in `world` spawned processes on `device` (every
    rank on the same device: a CPU, or one card shared under gloo), each
    with a process group of `backend`; their results (torch.save-able) in
    rank order. `fn` must be importable from its module. `threads` sets
    each rank's torch thread count. Raises RuntimeError where a rank fails
    or the world outlasts `timeout` seconds."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=workdir) as out_dir:
        init = f"file://{os.path.join(out_dir, 'rendezvous')}"
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world, init, backend, device, threads, out_dir,
                                   tuple(args)))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while any(p.exitcode is None for p in procs):
                failed = next((r for r, p in enumerate(procs)
                               if p.exitcode not in (None, 0)), None)
                if failed is not None:
                    break
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"spawn_ranks: {sum(p.exitcode is None for p in procs)} of {world} "
                        f"ranks still running after {timeout:.0f} s (a hung collective?)")
                procs[0].join(0.05)
            if failed is None:  # every rank has exited
                failed = next((r for r, p in enumerate(procs) if p.exitcode != 0), None)
            if failed is not None:
                err = os.path.join(out_dir, f"rank{failed}.err")
                tb = open(err).read() if os.path.exists(err) else ""
                raise RuntimeError(f"spawn_ranks: rank {failed} of {world} exited with code "
                                   f"{procs[failed].exitcode}\n{tb}")
            return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                    for r in range(world)]
        finally:
            for p in procs:
                if p.exitcode is None:
                    p.kill()
            for p in procs:
                p.join(10)
