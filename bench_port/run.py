"""Run one cell of the port's benchmark once, on the card this process sees.

    python3 bench_port/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, traffic mix, limits, metrics and kernels' work
counts are found by name (BENCHMARK.json and the files under bench_port/).
Set-up builds everything from the seed and warms every shape the window
uses; the window runs for --seconds; with --trace 1 a profiled stretch
follows it and the per-layer metrics are read from it. Once the window has
closed the run checks what the program produced against the plain fp32
reference, and prints one JSON line last on standard output.

Caches stay inside the checkout at fixed paths: Python's bytecode under
bench_port/.cache/pycache, the port's kernels under infinitevl_tpu_torch/_build/."""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CACHE = BENCH_DIR / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "infinitevl_tpu")


def _caches() -> None:
    """Every cache of this process and its children at a fixed path in the checkout."""
    sys.pycache_prefix = str(CACHE / "pycache")
    os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules():
    """Loaded modules whose top-level name is one the port must never load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def execute(cell, seed: int, seconds: float, trace: bool, device, t_process: float):
    """Drive the cell once; returns (result dict, lines for standard error).
    The result's last key is `checks`: each number compared, its limit."""
    from harness.context import RunContext
    from harness.spec import metric_reader, work_module

    res = cell.driver().run(RunContext(cell, seed, seconds, trace, device, t_process))
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(res.end_to_end[m["name"]]), "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = metric_reader(cell, m["name"]).read(res.readings)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    checks = {k: {"value": float(v), "limit": float(cell.limits[k])}
              for k, v in res.checks.items()}
    missing = set(cell.limits) - set(checks)
    if missing:
        raise RuntimeError(f"the driver compared no {sorted(missing)}")
    correct = res.failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": _device_kind(device), "count": cell.chips,
           "memory_peak_bytes": int(res.memory_peak_bytes)}
    out = {"correct": bool(correct), "attempted": int(res.attempted), "failed": int(res.failed),
           "metrics": metrics, "device": dev}
    tr = res.readings.trace
    lines = list(res.notes)
    if trace and tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
        for kernel in sorted(res.readings.calls):
            dev_s, n = tr.kernel_time_s(work_module(cell.bench_dir, kernel).TRACE_NAMES)
            lines.append(f"kernel {kernel}: {len(res.readings.calls[kernel])} calls declared, "
                         f"{n} launches traced, {dev_s!r} s")
    out["checks"] = checks
    lines += [f"check {k}: {c['value']!r} (limit {c['limit']!r})" for k, c in checks.items()]
    return out, lines


def _device_kind(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path[:0] = [str(BENCH_DIR), str(ROOT)]

    import torch
    from harness.spec import read_json, resolve

    cell = resolve(read_json(ROOT / "BENCHMARK.json"), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run.py: the cell needs {cell.chips} CUDA card(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(f"card: {card_line()}", file=sys.stderr)
    out, lines = execute(cell, args.seed, args.seconds, bool(args.trace), device, T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"run.py: the process loaded {bad}, which the port must never load", file=sys.stderr)
        return 3
    for ln in lines:
        print(ln, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
