"""Start-up of a spawned world of two ranks sharing cuda:0, without and with
chip_smoke.py's bytecode cache: each rank's seconds from the spawn to the end
of its imports (torch and chip_smoke.py), its first run of phase 4's two-rank
job (two run_sft steps of the small fp32 model under fsdp) and its second, and
the world's seconds. Without the cache a rank compiles what it imports from
source, as every process does where site-packages holds no usable bytecode.

    python scripts/torch_rank_start.py   # on a machine with an NVIDIA GPU
"""
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_T_IMPORT = time.time()

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

_IMPORTED = time.time()


def rank_job(rank, world, job):
    from infinitevl_tpu_torch.train import trainer as T

    t0 = time.perf_counter()
    cs._par_small(job, T)
    t1 = time.perf_counter()
    cs._par_small({"args": dict(job["args"], out_dir=job["args"]["out_dir"] + "_again")}, T)
    t2 = time.perf_counter()
    return dict(imports=_IMPORTED - _T_IMPORT, since_spawn=_IMPORTED - float(os.environ["SPAWNED_AT"]),
                first=t1 - t0, second=t2 - t1)


def world(name, small):
    from infinitevl_tpu_torch.parallel.launch import spawn_ranks

    os.environ["SPAWNED_AT"] = str(time.time())
    t0 = time.perf_counter()
    out = spawn_ranks(rank_job, 2, ({"args": dict(small["two"], out_dir=small["two"]["out_dir"]
                                                  + name)},), device="cuda:0", timeout=600)
    took = time.perf_counter() - t0
    for r, res in enumerate(out):
        print(f"[rank start] {name}: rank {r} imports {res['imports']:.2f} s (done "
              f"{res['since_spawn']:.2f} s after the spawn), first job {res['first']:.2f} s, "
              f"second {res['second']:.2f} s", flush=True)
    print(f"[rank start] {name}: the world of two took {took:.2f} s on '{cs.card_line()}'",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_rank_start: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    cs.phase_build()
    small = cs._par_small_job(tempfile.mkdtemp(prefix="ivl_rank_start_"))
    # no cache: an empty prefix the ranks may not write
    os.environ["PYTHONPYCACHEPREFIX"] = tempfile.mkdtemp(prefix="ivl_no_pycache_")
    os.environ["PYTHONDONTWRITEBYTECODE"] = "1"
    world("no bytecode cache", small)
    os.environ.pop("PYTHONDONTWRITEBYTECODE")
    t0 = time.perf_counter()
    warm = cs.start_bytecode_cache()
    warm.communicate()
    print(f"[rank start] the bytecode cache filled in {time.perf_counter() - t0:.2f} s (exit "
          f"code {warm.returncode})", flush=True)
    world("bytecode cache", small)
    return 0


if __name__ == "__main__":
    sys.exit(main())
