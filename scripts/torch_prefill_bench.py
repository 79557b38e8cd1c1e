"""Long-sequence prefill / training-step throughput (tok/s, MFU) of the
3B decoder on the CUDA card (torch port of scripts/prefill_bench.py).

Counterpart of the reference's throughput accounting
(train/dt/workflow.py:133-136 effective_tokens_per_sec + stat_utils
cal_mfu). Random bf16 weights from seed 0; the step is timed with CUDA
events after warm-up (utils/profiling.device_time_ms), and the card's name
and power limit are printed beside the numbers. It needs the card: without
one it raises.

    python scripts/torch_prefill_bench.py --seqlen 8192 --train [--layers 4]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(seqlen: int = 8192, batch: int = 1, train: bool = False, layers=None) -> dict:
    import dataclasses

    import torch

    from infinitevl_tpu_torch import infinitevl_3b
    from infinitevl_tpu_torch.models.params import init_text_params
    from infinitevl_tpu_torch.models.text import text_forward
    from infinitevl_tpu_torch.utils.profiling import (
        card_line,
        device_time_ms,
        mfu,
        require_card,
    )

    dev = require_card("prefill_bench")
    cfg = infinitevl_3b()
    if layers:  # depth cut: the first `layers` of the hybrid pattern
        cfg = dataclasses.replace(cfg, text=dataclasses.replace(
            cfg.text, num_hidden_layers=layers, layer_types=cfg.text.layer_types[:layers]))
    B, T = batch, seqlen
    params = init_text_params(cfg.text, torch.Generator(device=dev).manual_seed(0), dev,
                              torch.bfloat16)
    ids = torch.zeros((B, T), dtype=torch.long, device=dev)
    pos = torch.arange(T, device=dev)[None, None].expand(3, B, T).contiguous()

    if train:
        # LoRA step: full-parameter AdamW on 3.7B needs ~30 GB of optimizer
        # state beside the weights. The one-card long-context recipe is
        # LoRA + per-layer remat + the stateless SWA kernel (H), the
        # reference's stage 3.
        from infinitevl_tpu_torch.train.lora import init_lora, make_lora_sft_step
        from infinitevl_tpu_torch.train.step import make_optimizer

        tx = make_optimizer(1e-4, weight_decay=0.0)
        full = {"text": params}
        lora = init_lora(full, torch.Generator(device=dev).manual_seed(1), rank=8)
        opt_state = tx.init(lora)
        step = make_lora_sft_step(cfg.text, tx, remat=True)
        data = {"input_ids": ids, "labels": ids, "position_ids": pos}

        def fn(carry):
            lra, opt = carry
            lra, opt, _ = step(lra, opt, full, data)
            return (lra, opt)

        ms = device_time_ms(fn, (lora, opt_state), warmup=2, iters=4)
        label = "LoRA train step (remat)"
        flops_mult = 3.0  # fwd + bwd
    else:
        def fn(e):
            with torch.no_grad():
                return text_forward(params, cfg.text, e, pos, None)[0].to(torch.bfloat16)

        e0 = torch.zeros((B, T, cfg.text.hidden_size), dtype=torch.bfloat16, device=dev)
        ms = device_time_ms(fn, e0, warmup=3, iters=6)
        label = "prefill"
        flops_mult = 1.0

    tps = B * T / (ms / 1e3)
    eff = mfu(tps * flops_mult, cfg)
    card = card_line(dev)
    print(
        f"{label} B={B} T={T} layers={cfg.text.num_hidden_layers}: {ms:.1f} ms = "
        f"{tps:,.0f} tok/s, ~{eff*100:.1f}% MFU (decoder matmuls only) on '{card}'"
    )
    return {"ms": ms, "tokens_per_sec": tps, "mfu": eff, "card": card}


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--seqlen", type=int, default=8192)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--train", action="store_true", help="time a train step")
    p.add_argument("--layers", type=int, default=None,
                   help="decoder depth (default: the 3B model's 36)")
    main(**vars(p.parse_args()))
