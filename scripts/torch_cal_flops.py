"""Analytic FLOPs / MACs / params for an InfiniteVL config (torch port of
scripts/cal_flops.py, on the PyTorch package).

The reference traces a CUDA model with the deepspeed flops profiler
(scripts/stat_utils/cal_flops.py); this prints the closed-form per-token
and per-pass counts from the config (utils/profiling.decoder_flops_per_token
covers projections, the hybrid attention/delta mix and the MLPs). The
parameters are counted on the meta device: nothing is allocated.

Usage:
  python scripts/torch_cal_flops.py                       # deployed 3B
  python scripts/torch_cal_flops.py --config cfg.yaml     # from a train yaml
  python scripts/torch_cal_flops.py --batch_size 4 --seq_length 8192
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(config=None, batch_size: int = 1, seq_length: int = 512,
         include_backward: bool = False) -> dict:
    import json

    from infinitevl_tpu_torch import infinitevl_3b
    from infinitevl_tpu_torch.models.params import init_params, param_count
    from infinitevl_tpu_torch.utils.profiling import decoder_flops_per_token

    cfg = infinitevl_3b()
    if config:
        from infinitevl_tpu_torch.hparams import load_yaml_args

        aa = load_yaml_args(config)
        if aa.model.model_name_or_path:
            p = os.path.join(aa.model.model_name_or_path, "config.json")
            if os.path.exists(p):
                from infinitevl_tpu_torch.config import from_hf_dict

                with open(p) as f:
                    cfg = from_hf_dict(json.load(f))

    n_params = param_count(init_params(cfg, None, "meta"))
    ft = decoder_flops_per_token(cfg)
    tokens = batch_size * seq_length
    total = ft * tokens * (3 if include_backward else 1)
    print(f"params: {n_params/1e9:.3f} B")
    print(f"decoder FLOPs/token (fwd): {ft/1e9:.3f} GF  "
          f"(MACs {ft/2e9:.3f} G)")
    print(f"pass FLOPs (B={batch_size}, T={seq_length}"
          f"{', fwd+bwd' if include_backward else ', fwd'}): "
          f"{total/1e12:.3f} TF")
    return {"params": n_params, "flops_per_token": ft, "pass_flops": total}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None, help="train yaml (model section)")
    ap.add_argument("--batch_size", type=int, default=1)
    ap.add_argument("--seq_length", type=int, default=512)
    ap.add_argument("--include_backward", action="store_true")
    main(**vars(ap.parse_args()))
