"""LLaMA-Pro block expansion over an HF checkpoint (torch port of
scripts/llama_pro.py; reference scripts/llama_pro.py): load, insert
identity blocks, re-export. Runs on the CUDA card unless --device cpu.

Usage:
  python scripts/torch_llama_pro.py <checkpoint_dir> <output_dir> <num_expand> [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(src: str, dst: str, num_expand: int, device=None) -> None:
    import dataclasses

    import torch

    from infinitevl_tpu_torch.config import from_hf_json
    from infinitevl_tpu_torch.models.convert import llama_pro_expand
    from infinitevl_tpu_torch.models.params import load_hf_checkpoint
    from infinitevl_tpu_torch.utils.checkpoint import export_hf_safetensors

    cfg = from_hf_json(os.path.join(src, "config.json"))
    params = load_hf_checkpoint(src, cfg, dtype=torch.bfloat16, device=device)
    new_text, new_tcfg = llama_pro_expand(params["text"], cfg.text, num_expand)
    params["text"] = new_text
    new_cfg = dataclasses.replace(cfg, text=new_tcfg)
    export_hf_safetensors(params, new_cfg, dst)
    print(
        f"expanded {cfg.text.num_hidden_layers} -> "
        f"{new_tcfg.num_hidden_layers} layers; wrote {dst}"
    )


if __name__ == "__main__":
    argv = sys.argv[1:]
    device = None
    if "--device" in argv[:-1]:
        i = argv.index("--device")
        device, argv = argv[i + 1], argv[:i] + argv[i + 2:]
    if len(argv) != 3:
        print(__doc__)
        sys.exit(2)
    main(argv[0], argv[1], int(argv[2]), device=device)
