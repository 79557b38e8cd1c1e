"""The readings that a cell's limits are set from, in one process on the card.

    python3 bench_port/calibrate.py --workload <name> --seeds 1,2,... \
        --control-seeds 1,2,3 [--seconds 3]

For every seed of --seeds the cell's driver runs as a benchmark run does
(a short window) and prints the numbers it compares: sound runs of the
program give the lower readings. For every seed of --control-seeds it
prints the control's readings: the reference computed with the linear
layers' operands in float8 e4m3 (per-tensor scales), the step below the
configuration's bf16, put in the program's place and compared the same
way. A limit lies between the largest lower reading and the smallest
control reading. The benchmark's own runs never run the control."""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import BENCH_DIR, ROOT, _caches, forbidden_modules  # noqa: E402


def readings(cell, seeds, control_seeds, seconds: float, device):
    """Yield one dict per reading: {"seed", "side", <number>: value, ...}."""
    from harness.context import RunContext
    from reference import infinitevl as ref

    drv = cell.driver()
    for seed in seeds:
        res = drv.run(RunContext(cell, seed, seconds, False, device, time.perf_counter()))
        row = {"seed": seed, "side": "program", **res.checks, "notes": res.notes}
        if seed in control_seeds:
            yield row
            yield {"seed": seed, "side": "control",
                   **drv.control(cell, seed, device, ref.mm_fp8, res.checked)}
        else:
            yield row
    for seed in control_seeds:
        if seed not in seeds:
            res = drv.run(RunContext(cell, seed, seconds, False, device, time.perf_counter()))
            yield {"seed": seed, "side": "control",
                   **drv.control(cell, seed, device, ref.mm_fp8, res.checked)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--dtype", default=None,
                    help="serve in this dtype instead of the configuration's (a diagnosis: "
                         "float32 shows whether the program and the reference agree to rounding)")
    args = ap.parse_args(argv)
    _caches()
    sys.path[:0] = [str(BENCH_DIR), str(ROOT)]
    import torch
    from harness.spec import read_json, resolve

    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA card", file=sys.stderr)
        return 2
    cell = resolve(read_json(ROOT / "BENCHMARK.json"), args.workload)
    if args.dtype:
        cell.config["dtype"] = args.dtype
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    rows = []
    for row in readings(cell, seeds, control, args.seconds, torch.device("cuda", 0)):
        rows.append(row)
        print(json.dumps(row), flush=True)
    for key in cell.limits:
        low = max(r[key] for r in rows if r["side"] == "program")
        high = min((r[key] for r in rows if r["side"] == "control"), default=float("nan"))
        print(json.dumps({"number": key, "lower": low, "upper": high,
                          "limit": cell.limits[key]}), flush=True)
    if forbidden_modules():
        print(f"calibrate.py: loaded {forbidden_modules()}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
