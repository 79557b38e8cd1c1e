"""MFU calculator: measured (or given) training tok/s -> model FLOPs
utilization on the H100 (torch port of scripts/cal_mfu.py).

Counterpart of scripts/stat_utils/cal_mfu.py in the reference (which
launches a torch train run and divides by the A100's peak): pass
--tokens_per_sec from a training log, or let it time one LoRA step at 8K
on the CUDA card with CUDA events after warm-up (random bf16 weights from
seed 0; the card's name and power limit printed beside the time). The
peak defaults to the H100's dense bf16 rate (utils/profiling.H100_PEAK_BF16).

Usage:
  python scripts/torch_cal_mfu.py --tokens_per_sec 4294
  python scripts/torch_cal_mfu.py --measure [--layers 4]   # one LoRA step on the card
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from infinitevl_tpu_torch.utils.profiling import H100_PEAK_BF16  # noqa: E402


def main(tokens_per_sec=None, measure: bool = False, seq_length: int = 8192,
         peak_tflops: float = H100_PEAK_BF16 / 1e12, include_backward: bool = True,
         layers=None) -> dict:
    import dataclasses

    from infinitevl_tpu_torch import infinitevl_3b
    from infinitevl_tpu_torch.utils.profiling import decoder_flops_per_token

    cfg = infinitevl_3b()
    if layers:  # depth cut: the first `layers` of the hybrid pattern
        cfg = dataclasses.replace(cfg, text=dataclasses.replace(
            cfg.text, num_hidden_layers=layers, layer_types=cfg.text.layer_types[:layers]))
    tok_s = tokens_per_sec
    if tok_s is None and measure:
        import torch

        from infinitevl_tpu_torch.models.params import init_text_params
        from infinitevl_tpu_torch.train.lora import init_lora, make_lora_sft_step
        from infinitevl_tpu_torch.train.step import make_optimizer
        from infinitevl_tpu_torch.utils.profiling import card_line, device_time_ms, require_card

        dev = require_card("cal_mfu --measure")
        T = seq_length
        base = init_text_params(cfg.text, torch.Generator(device=dev).manual_seed(0), dev,
                                torch.bfloat16)
        r = torch.Generator(device="cpu").manual_seed(0)
        batch = {
            "input_ids": torch.randint(3, 1000, (1, T), generator=r).to(dev),
            "labels": torch.randint(3, 1000, (1, T), generator=r).to(dev),
            "segment_ids": torch.ones((1, T), dtype=torch.int32),
            "position_ids": torch.arange(T, device=dev)[None, None].expand(3, 1, T).contiguous(),
        }
        tx = make_optimizer(1e-4, weight_decay=0.0)
        lora = init_lora(base, torch.Generator(device=dev).manual_seed(1))
        opt_state = tx.init(lora)
        step_fn = make_lora_sft_step(cfg.text, tx, remat=True, remat_group=1)

        def tstep(carry):
            l, o = carry
            l, o, _ = step_fn(l, o, base, batch)
            return (l, o)

        ms = device_time_ms(tstep, (lora, opt_state), warmup=2, iters=4)
        tok_s = T / ms * 1000
        print(f"measured: {ms:.0f} ms/step = {tok_s:.0f} tok/s "
              f"({cfg.text.num_hidden_layers} layers, T {T}) on '{card_line(dev)}'",
              file=sys.stderr)
    if tok_s is None:
        raise ValueError("pass --tokens_per_sec or --measure")

    ft = decoder_flops_per_token(cfg)
    mult = 3.0 if include_backward else 1.0
    mfu = mult * tok_s * ft / (peak_tflops * 1e12)
    print(f"tok/s: {tok_s:.0f}")
    print(f"model FLOPs/token (fwd): {ft/1e9:.2f} GF, pass multiplier "
          f"{mult:g} (remat recompute excluded — useful FLOPs only)")
    print(f"MFU vs {peak_tflops:.0f} TFLOP/s peak: {100*mfu:.1f}%")
    return {"tokens_per_sec": tok_s, "flops_per_token": ft, "mfu": mfu}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--tokens_per_sec", type=float, default=None)
    ap.add_argument("--measure", action="store_true")
    ap.add_argument("--seq_length", type=int, default=8192)
    ap.add_argument("--peak_tflops", type=float, default=H100_PEAK_BF16 / 1e12,
                    help="bf16 peak of the target card (H100 SXM: 989)")
    ap.add_argument("--include_backward", action="store_true", default=True)
    ap.add_argument("--layers", type=int, default=None,
                    help="decoder depth (default: the 3B model's 36)")
    a = ap.parse_args()
    if a.tokens_per_sec is None and not a.measure:
        ap.error("pass --tokens_per_sec or --measure")
    main(**vars(a))
