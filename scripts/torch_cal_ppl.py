"""Perplexity over a registered dataset (torch port of scripts/cal_ppl.py;
reference scripts/stat_utils/cal_ppl.py). Runs on the CUDA card unless
--device cpu.

    python scripts/torch_cal_ppl.py examples/sft_tiny.yaml [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(config_path: str, device=None) -> dict:
    import numpy as np
    import torch

    from infinitevl_tpu_torch.cli import _tokenizer
    from infinitevl_tpu_torch.device import resolve_device
    from infinitevl_tpu_torch.hparams import load_yaml_args
    from infinitevl_tpu_torch.models.params import init_text_params, load_hf_checkpoint
    from infinitevl_tpu_torch.train.step import IGNORE_INDEX, batch_to_device, sft_loss_fn
    from infinitevl_tpu_torch.train.trainer import build_config, build_dataset, collate

    device = resolve_device(device)
    args = load_yaml_args(config_path)
    cfg = build_config(args)
    dtype = torch.bfloat16 if args.train.bf16 else torch.float32
    if args.model.model_name_or_path:
        params = load_hf_checkpoint(args.model.model_name_or_path, cfg, dtype,
                                    device=device)["text"]
    else:
        params = init_text_params(cfg.text, torch.Generator(device=device).manual_seed(0),
                                  device, dtype)
    data = build_dataset(args, _tokenizer(args, cfg), cfg=cfg)

    total, count = 0.0, 0
    with torch.no_grad():
        for batch in collate(
            data, args.train.per_device_train_batch_size, args.data.cutoff_len,
            epochs=1.0,
        ):
            batch = batch_to_device(batch, device)
            n = int((batch["labels"] != IGNORE_INDEX).sum())
            # the mean CE over the supervised positions, times their count
            loss = sft_loss_fn(params, cfg.text, batch["input_ids"], batch["labels"],
                               batch["position_ids"], batch.get("segment_ids"),
                               segment_layout=batch.get("segment_layout"))
            total += float(loss) * n
            count += n
    ppl = np.exp(total / max(count, 1))
    print(f"tokens: {count}  nll/token: {total/max(count,1):.4f}  ppl: {ppl:.3f}")
    return {"tokens": count, "nll": total / max(count, 1), "ppl": float(ppl)}


if __name__ == "__main__":
    argv = sys.argv[1:]
    device = None
    if "--device" in argv[:-1]:
        i = argv.index("--device")
        device, argv = argv[i + 1], argv[:i] + argv[i + 2:]
    main(argv[0], device=device)
