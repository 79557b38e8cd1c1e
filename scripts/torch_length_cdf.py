"""Token-length distribution of a registered dataset (torch port of
scripts/length_cdf.py; reference scripts/stat_utils/length_cdf.py).

    python scripts/torch_length_cdf.py examples/sft_tiny.yaml
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(config_path: str) -> dict:
    import numpy as np

    from infinitevl_tpu_torch.cli import _tokenizer
    from infinitevl_tpu_torch.hparams import load_yaml_args
    from infinitevl_tpu_torch.train.trainer import build_config, build_dataset

    args = load_yaml_args(config_path)
    args.data.packing = False
    data = build_dataset(args, _tokenizer(args, build_config(args)))
    lens = np.asarray([len(e["input_ids"]) for e in data])
    print(f"n={len(lens)} mean={lens.mean():.1f} max={lens.max()}")
    pct = {}
    for q in (50, 75, 90, 95, 99, 100):
        pct[q] = float(np.percentile(lens, q))
        print(f"  p{q:<3d} {pct[q]:.0f}")
    return {"n": len(lens), "mean": float(lens.mean()), "max": int(lens.max()),
            "percentiles": pct}


if __name__ == "__main__":
    main(sys.argv[1])
