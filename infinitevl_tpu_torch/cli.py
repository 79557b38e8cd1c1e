"""Command-line interface (torch port of infinitevl_tpu/cli.py):
subcommands train / chat / api / eval / export / version.

Every command runs on the CUDA card; the `cmd_*` functions take
`device="cpu"` for the plain versions on the CPU (what the tests do).
`board` serves the training web board (serve/webui.py) on the same
device. `bench` (the port has no benchmark yet) raises by name. `train`
runs one process per rank under torchrun:
  torchrun --nproc_per_node N -m infinitevl_tpu_torch.cli train recipe.yaml
with `data_parallel` x `model_parallel` = N in the recipe."""

from __future__ import annotations

import json
import os
import sys

USAGE = """infinitevl-tpu (PyTorch + CUDA) CLI
  python -m infinitevl_tpu_torch.cli train <config.yaml>   # pt/sft/dt stages
  torchrun --nproc_per_node N -m infinitevl_tpu_torch.cli train <config.yaml>
                                               # data_parallel x model_parallel = N, one
                                               # process per rank
  python -m infinitevl_tpu_torch.cli chat <config.yaml>    # interactive CLI chat
  python -m infinitevl_tpu_torch.cli api <config.yaml>     # OpenAI-compatible server
  python -m infinitevl_tpu_torch.cli eval <config.yaml>    # MCQ evaluator
  python -m infinitevl_tpu_torch.cli export <config.yaml>  # HF safetensors export
  python -m infinitevl_tpu_torch.cli board [port]          # training web board (7860)
  python -m infinitevl_tpu_torch.cli version
  (add --device cpu to run a command on the CPU's plain versions; under torchrun
   the ranks then join over gloo)
"""


def _load(config_path: str):
    from .hparams import load_yaml_args

    return load_yaml_args(config_path)


def _load_params(args, device=None):
    """(params, cfg, dtype): the checkpoint at `model_name_or_path`, or
    random weights from seed 0, on `device`."""
    import torch

    from .device import resolve_device
    from .models.params import init_params, load_hf_checkpoint
    from .train.trainer import build_config

    device = resolve_device(device)
    cfg = build_config(args)
    dtype = torch.bfloat16 if args.train.bf16 else torch.float32
    if args.model.model_name_or_path:
        params = load_hf_checkpoint(args.model.model_name_or_path, cfg, dtype, device=device)
    else:
        params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device, dtype)
    return params, cfg, dtype


def _build_generator(args, device=None):
    """(Generator, cfg) of the yaml's model, quantised for serving when
    `quantization_bit` asks for it."""
    from .generation import Generator

    params, cfg, dtype = _load_params(args, device)
    quant = {8: "int8", 4: "int4"}.get(args.model.quantization_bit)
    gen = Generator(params, cfg, dtype=dtype, quant=quant,
                    quant_group_size=args.model.quantization_group_size,
                    quant_embed=args.model.quantization_embed, device=device)
    return gen, cfg


def _tokenizer(args, cfg=None):
    """The HF tokenizer where tokenizer files exist (through `transformers`;
    its import error stands where it is missing), SimpleTokenizer otherwise."""
    from .data.loader import resolve_tokenizer

    if cfg is None:
        from .train.trainer import build_config

        cfg = build_config(args)
    return resolve_tokenizer(args, cfg)


def cmd_train(config_path: str, device=None):
    """Train the yaml's stage. Under torchrun (WORLD_SIZE > 1) each process
    joins the group first (parallel/sharding.maybe_init_distributed, on
    cuda:LOCAL_RANK) and trains its rank of the (data_parallel,
    model_parallel) mesh."""
    from .parallel.sharding import maybe_init_distributed
    from .train.trainer import run_exp

    maybe_init_distributed(device=device)
    args = _load(config_path)
    return run_exp(args, tokenizer=_tokenizer(args), device=device)


def cmd_chat(config_path: str, device=None):
    import numpy as np

    from .data.template import get_template

    args = _load(config_path)
    gen, cfg = _build_generator(args, device)
    tok = _tokenizer(args, cfg)
    template = get_template(args.data.template)
    history = []
    print("Interactive chat. Type 'exit' to quit, 'clear' to reset history.")
    while True:
        try:
            user = input("\nUser: ").strip()
        except EOFError:
            break
        if user == "exit":
            break
        if user == "clear":
            history = []
            continue
        history.append({"role": "user", "content": user})
        prompt = template.render_prompt(history)
        ids = np.asarray([tok.encode(prompt, add_special_tokens=False)])
        greedy = not args.gen.do_sample or args.gen.temperature == 0.0
        if args.gen.num_beams > 1:
            if not greedy or args.gen.repetition_penalty != 1.0:
                raise ValueError("num_beams > 1 is greedy beam search; disable "
                                 "do_sample / repetition_penalty")
            out = gen.generate_beam(ids, num_beams=args.gen.num_beams,
                                    max_new_tokens=args.gen.max_new_tokens,
                                    length_penalty=args.gen.length_penalty)
        elif args.gen.draft_k > 0 and greedy and args.gen.repetition_penalty == 1.0:
            from .speculative import SpecStats

            spec_stats = SpecStats()
            out = gen.generate_speculative(ids, max_new_tokens=args.gen.max_new_tokens,
                                           draft_k=args.gen.draft_k, stats=spec_stats)
            if spec_stats.forwards:
                print(f"[{spec_stats.summary()}]")
        else:
            out = gen.generate(
                ids,
                max_new_tokens=args.gen.max_new_tokens,
                temperature=args.gen.temperature if args.gen.do_sample else 0.0,
                top_k=args.gen.top_k,
                top_p=args.gen.top_p,
                repetition_penalty=args.gen.repetition_penalty,
            )
        text = tok.decode(out[0], skip_special_tokens=True)
        history.append({"role": "assistant", "content": text})
        print(f"Assistant: {text}")


def cmd_api(config_path: str, port: int = 8000, device=None):
    from .serve.api import ChatBackend, run_api

    args = _load(config_path)
    gen, cfg = _build_generator(args, device)
    backend = ChatBackend(gen, _tokenizer(args, cfg), args.data.template,
                          draft_k=args.gen.draft_k)
    run_api(backend, port=port)


def cmd_eval(config_path: str, device=None):
    from .eval.mcq import MCQEvaluator

    args = _load(config_path)
    gen, cfg = _build_generator(args, device)
    evaluator = MCQEvaluator(gen, _tokenizer(args, cfg), batch_size=args.eval.eval_batch_size,
                             lang=args.eval.lang)
    with open(os.path.join(args.data.dataset_dir, f"{args.data.dataset}.json")) as f:
        task = json.load(f)
    if isinstance(task, dict):
        # MMLU-style {subject: {dev, test}} benchmark with few-shot support
        metrics = evaluator.evaluate_task(task, n_shot=args.eval.n_shot)
    else:
        metrics = evaluator.evaluate(task)
    out = json.dumps(metrics, indent=2)
    print(out)
    if args.eval.eval_save_dir:
        os.makedirs(args.eval.eval_save_dir, exist_ok=True)
        with open(os.path.join(args.eval.eval_save_dir, "results.json"), "w") as f:
            f.write(out)
    return metrics


def cmd_export(config_path: str, device=None):
    """The yaml's model (unquantised) as an HF safetensors checkpoint and an
    ollama Modelfile in `output_dir`."""
    from .data.template import get_ollama_modelfile, get_template
    from .utils.checkpoint import export_hf_safetensors

    args = _load(config_path)
    params, cfg, _ = _load_params(args, device)
    out = args.train.output_dir
    export_hf_safetensors(params, cfg, out)
    with open(os.path.join(out, "Modelfile"), "w") as f:
        f.write(get_ollama_modelfile(get_template(args.data.template)))
    print(f"exported HF safetensors + ollama Modelfile to {out}")


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(USAGE)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "version":
        from . import __version__

        print(__version__)
        return 0
    if cmd == "bench":
        raise NotImplementedError(
            "bench: the port has no benchmark yet (the JAX package's runs bench.py)")
    device = None
    if "--device" in rest[:-1]:  # the CPU's plain versions: --device cpu
        i = rest.index("--device")
        device, rest = rest[i + 1], rest[:i] + rest[i + 2:]
    if cmd == "board":
        from .serve.webui import run_board

        run_board(port=int(rest[0]) if rest else 7860, device=device)
        return 0
    if cmd in ("train", "chat", "api", "eval", "export"):
        if not rest:
            print(f"error: {cmd} requires a config.yaml path\n{USAGE}")
            return 2
        {"train": cmd_train, "chat": cmd_chat, "api": cmd_api, "eval": cmd_eval,
         "export": cmd_export}[cmd](rest[0], device=device)
        return 0
    print(f"unknown command {cmd!r}\n{USAGE}")
    return 2


if __name__ == "__main__":
    sys.exit(main())
