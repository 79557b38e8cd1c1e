#!/usr/bin/env python3
"""Device times of the DeltaNet kernels B and C on one CUDA card, for
comparing two trees of the port in one call.

    python scripts/torch_delta_timings.py                  # this tree
    python scripts/torch_delta_timings.py --tree DIR       # the port in DIR
                                                           # (e.g. an unpacked
                                                           # `git archive` of a parent)

The measurements are chip_smoke.py's own (`_b_timings`, `_c_timings`:
B's device kernels per call and its device time with the state L2-cold at
B 1 and 4; C's device times in a CUDA graph at the DeltaNet layer's shapes,
its passes by the profiler, the scan's V-tile sweep where the tree has one),
taken from the chip_smoke.py beside this script and run on the
`infinitevl_tpu_torch` package of DIR. No check is made: the parity checks
are chip_smoke.py's. Prints the card's line and one JSON object."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv) -> int:
    tree = ROOT
    if "--tree" in argv:
        tree = Path(argv[argv.index("--tree") + 1]).resolve()
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke_here", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    if not torch.cuda.is_available():
        print("torch_delta_timings: no CUDA card", file=sys.stderr)
        return 2
    import infinitevl_tpu_torch

    pkg = Path(infinitevl_tpu_torch.__file__).resolve().parent
    if pkg.parent != tree:
        print(f"torch_delta_timings: imported {pkg}, not the package of {tree}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    b = cs._b_timings(dev, gen)
    c = cs._c_timings(dev, gen)
    print(cs.card_line())
    print(json.dumps(dict(
        tree=str(tree),
        b={B: dict(kernels=r["kernels"], device_ms=r["device_ms"],
                   by_kernel=[(nm[:60], t) for t, _, nm in r["rows"]]) for B, r in b.items()},
        c=c)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
