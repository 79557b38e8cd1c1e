"""Offline batch inference over a registered dataset -> predictions jsonl
(torch port of scripts/batch_infer.py).

Counterpart of the reference's vLLM batch scorer (scripts/vllm_infer.py):
renders each example's prompt with a chat template, generates through
serve.batching.BatchingEngine (length-bucketed batched decode, the
throughput path batched serving uses), and writes {"prompt", "predict",
"label"} lines like the reference's generated_predictions.jsonl. Runs on
the CUDA card unless --device cpu.

Usage:
  python scripts/torch_batch_infer.py --dataset demo --save_name preds.jsonl \
      [--checkpoint out/export] [--template qwen2_vl] [--max_new_tokens 128]

Without --checkpoint it runs the tiny random-init config + SimpleTokenizer
(offline smoke; same flow, fixture-scale). A checkpoint without tokenizer
files is read with SimpleTokenizer too (the port's tokenizer rule,
data/loader.resolve_tokenizer).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="demo")
    ap.add_argument("--dataset_dir", default="data")
    ap.add_argument("--template", default="qwen2_vl")
    ap.add_argument("--checkpoint", default=None,
                    help="HF-layout checkpoint dir (config + safetensors)")
    ap.add_argument("--save_name", default="generated_predictions.jsonl")
    ap.add_argument("--max_new_tokens", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top_p", type=float, default=1.0)
    ap.add_argument("--top_k", type=int, default=0)
    ap.add_argument("--quant", default=None, choices=(None, "int8"))
    ap.add_argument("--max_samples", type=int, default=None)
    ap.add_argument("--device", default=None, help="cpu: the plain versions on the CPU")
    return ap


def main(argv=None) -> list:
    args = _parser().parse_args(argv)

    import numpy as np
    import torch

    from infinitevl_tpu_torch.data.loader import (
        SimpleTokenizer,
        load_dataset_info,
        load_examples,
    )
    from infinitevl_tpu_torch.data.template import get_template
    from infinitevl_tpu_torch.device import resolve_device
    from infinitevl_tpu_torch.serve.batching import BatchingEngine

    device = resolve_device(args.device)
    registry = load_dataset_info(
        os.path.join(args.dataset_dir, "dataset_info.json")
    )
    examples = load_examples(registry[args.dataset], args.dataset_dir)
    if args.max_samples:
        examples = examples[: args.max_samples]

    if args.checkpoint:
        from infinitevl_tpu_torch.config import from_hf_dict
        from infinitevl_tpu_torch.data.loader import resolve_tokenizer
        from infinitevl_tpu_torch.hparams import parse_args
        from infinitevl_tpu_torch.models.params import load_hf_checkpoint

        with open(os.path.join(args.checkpoint, "config.json")) as f:
            cfg = from_hf_dict(json.load(f))
        params = load_hf_checkpoint(args.checkpoint, cfg, device=device)
        tokenizer = resolve_tokenizer(parse_args({"model_name_or_path": args.checkpoint}))
    else:
        from infinitevl_tpu_torch.config import tiny_config
        from infinitevl_tpu_torch.models.params import init_params

        cfg = tiny_config()
        params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
        tokenizer = SimpleTokenizer()

    template = get_template(args.template)
    engine = BatchingEngine(params, cfg, quant=args.quant, device=device)
    t0 = time.time()
    prompts, labels, encodings = [], [], []
    for ex in examples:
        msgs = ex["messages"]
        label = ""
        if msgs and msgs[-1]["role"] == "assistant":
            label = msgs[-1]["content"]
            msgs = msgs[:-1]
        prompt = template.render_prompt(msgs)
        prompts.append(prompt)
        labels.append(label)
        encodings.append(
            np.asarray(
                tokenizer.encode(prompt, add_special_tokens=False), np.int64
            )
        )
    # concurrent submission: the engine groups same-length requests into
    # one batched decode (serial submission would defeat the ladder)
    from concurrent.futures import ThreadPoolExecutor

    try:
        with ThreadPoolExecutor(max_workers=32) as pool:
            futures = [
                pool.submit(
                    engine.generate,
                    ids,
                    max_new_tokens=args.max_new_tokens,
                    temperature=args.temperature,
                    top_p=args.top_p,
                    top_k=args.top_k,
                )
                for ids in encodings
            ]
            outs = [f.result() for f in futures]
    finally:
        engine.shutdown()
    rows = [
        {
            "prompt": prompt,
            "predict": tokenizer.decode(out, skip_special_tokens=True),
            "label": label,
        }
        for prompt, label, out in zip(prompts, labels, outs)
    ]

    with open(args.save_name, "w", encoding="utf-8") as f:
        for row in rows:
            f.write(json.dumps(row, ensure_ascii=False) + "\n")
    dt = time.time() - t0
    print(
        f"{len(rows)} generated results saved at {args.save_name} "
        f"({dt:.1f}s; batches={engine.stats['batches']}, "
        f"rows={engine.stats['rows']})"
    )
    return rows


if __name__ == "__main__":
    main()
