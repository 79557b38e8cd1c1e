"""Hyperparameter dataclasses + YAML config parsing (the port's own copy of
infinitevl_tpu/hparams.py: same keys, same defaults, so every yaml of
`examples/` parses here too).

Single-YAML -> dataclass-groups design mirroring the reference's hparams
package (src/llamafactory/hparams: Model / Data / Training / Finetuning /
Generating args parsed by HfArgumentParser from argv[1]); unknown keys are
rejected so config typos fail fast."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass
class ModelArgs:
    model_name_or_path: Optional[str] = None  # HF checkpoint dir
    # Explicit tokenizer dir; defaults to model_name_or_path. Whenever HF
    # tokenizer files are present they are used for every workflow
    # (train/eval/serve); SimpleTokenizer is only the offline-smoke fallback.
    tokenizer_path: Optional[str] = None
    config_preset: str = "infinitevl_3b"  # or "tiny"
    dtype: str = "bfloat16"
    use_pallas_swa: bool = True
    conv_carry: bool = False
    # rope scaling (reference model_utils/rope.py configure_rope):
    # linear | dynamic | yarn | llama3; factor derived from model_max_length
    rope_scaling: Optional[str] = None
    model_max_length: Optional[int] = None
    # on-the-fly weight quantization (reference model_args.py:191
    # quantization_bit via bitsandbytes NF4 — here models/quant.py, which
    # the dense helpers read directly so no dequantized copy lands in HBM).
    # 8 = int8 per-channel: QLoRA frozen base for training, or serving.
    # 4 = int4 group-wise (bit-packed s4): serving only (chat/api/export).
    quantization_bit: Optional[int] = None
    # int4 group size override (models/quant.py group_size). Large values
    # (>= hidden size) collapse to per-column scales — the measured-faster
    # int4 decode variant (121 vs 75 tok/s; generation.py:302). None keeps
    # the memory-optimal grouped default. Ignored unless quantization_bit=4.
    quantization_group_size: Optional[int] = None
    # also quantize the embed/tied-lm_head table row-wise int8 when
    # quantization_bit is set (models/quant.quantize_embed_rows — the tied
    # head reads the full vocab x hidden bytes every decoded token).
    # Serving default on; set false to keep the bf16 table.
    quantization_embed: bool = True


@dataclasses.dataclass
class DataArgs:
    dataset: Optional[str] = None  # registry name, or comma-separated list
    dataset_dir: str = "data"
    # multi-dataset mixing (reference data_args.py:66-73 / merge_dataset)
    mix_strategy: str = "concat"  # concat | interleave_under | interleave_over
    interleave_probs: Optional[Tuple[float, ...]] = None
    template: str = "qwen2_vl"
    # user-defined template slots (data/template.register_custom_template);
    # a dict of Template fields in yaml, selected with `template: custom`
    custom_template: Optional[Dict[str, Any]] = None
    cutoff_len: int = 2048
    max_samples: Optional[int] = None
    packing: bool = False
    # dataset streaming (reference data_args.py:58-65): examples are read,
    # mixed, encoded, shuffled (buffer_size reservoir) and packed lazily —
    # nothing materializes. Requires max_steps; incompatible with
    # max_samples (parser.py:232-233, data_args.py:157-158). Text-only.
    streaming: bool = False
    buffer_size: int = 16384
    # held-out split for eval loss during training (reference
    # data_args.py:144-156): fraction of the dataset in (0, 1) or an
    # absolute example count >= 1; fractional val_size is incompatible
    # with streaming (same constraint as the reference)
    val_size: float = 0.0
    image_max_pixels: int = 14 * 14 * 4 * 1280
    image_min_pixels: int = 56 * 56
    video_fps: float = 2.0
    video_min_pixels: int = 128 * 28 * 28
    video_max_pixels: int = 768 * 28 * 28


@dataclasses.dataclass
class TrainArgs:
    output_dir: str = "output"
    per_device_train_batch_size: int = 1
    gradient_accumulation_steps: int = 1
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    warmup_steps: int = 0
    num_train_epochs: float = 1.0
    max_steps: Optional[int] = None
    lr_scheduler_type: str = "cosine"
    logging_steps: int = 10
    save_steps: int = 5000
    seed: int = 42
    # a checkpoint dir, or "auto": resume from the latest checkpoint under
    # output_dir/checkpoints if one exists (elastic restart — relaunch the
    # same yaml after a preemption and training continues)
    resume_from_checkpoint: Optional[str] = None
    max_grad_norm: float = 1.0
    bf16: bool = True
    data_parallel: int = 1
    model_parallel: int = 1
    param_mode: str = "fsdp"  # tp | fsdp | replicated
    # pipeline parallelism (parallel/pipeline.py, GPipe over a `pipe` mesh
    # axis; the reference only DECLARES pp via base_model_pp_plan,
    # configuration_infinitevl.py:202-206). pipeline_stages must divide the
    # layer-pattern period count (9 at the deployed 36-layer config);
    # n_microbatches splits the global batch (B % M == 0). Composes with
    # data_parallel/model_parallel: mesh = (pipe, data, model). Text-only
    # full finetuning (SFT/PT).
    pipeline_stages: int = 1
    n_microbatches: int = 1
    # gpipe: differentiate through the pipelined forward (activation memory
    # grows with n_microbatches). 1f1b: hand-scheduled forward+backward with
    # a bounded 2S-1 saved-input ring per stage; same numbers, same bubble.
    pipeline_schedule: str = "gpipe"
    # which axis n_microbatches splits: "batch" (GPipe/1F1B over batch
    # rows, B % M == 0) or "sequence" (TeraPipe-style wavefront over
    # contiguous T/M-token chunks with the recurrent layer carries as
    # pipeline state, parallel/pipeline_seq.py — the B=1 long-context
    # case batch microbatching cannot serve; requires (cutoff_len/M) %
    # sliding_window == 0 and schedule gpipe)
    pp_microbatch_axis: str = "batch"
    # gradient checkpointing (reference model_utils/checkpointing.py role):
    # remat recomputes layer internals in the backward; remat_group > 1
    # checkpoints groups of layers (fewer live boundary activations; the
    # group's interior is recomputed as a whole in the backward)
    remat: bool = False
    remat_group: int = 1
    # orders the backward recomputes of the JAX package's layer loop; the
    # torch layer loop recomputes one layer at a time by construction, so
    # the knob is parsed and changes nothing
    remat_barrier: bool = False
    # scan-over-layers (a stacked parameter layout) in the JAX package. In
    # torch the Python layer loop with per-layer checkpointing already frees
    # each layer's recompute before the next, so the knob is parsed and
    # accepted and the stacked layout is not built: it changes memory in
    # the JAX package and numbers in neither
    scan_layers: Optional[bool] = None
    # partial unroll of the JAX package's scan-over-layers; parsed, unused
    scan_unroll: int = 1
    # checkpoint placement inside the JAX package's scan-over-layers
    # (auto | layer | scan | nested | none); parsed and accepted like
    # scan_layers: it changes memory there, and numbers nowhere
    remat_mode: str = "auto"
    # predict_with_generate analogue: after training, greedy-generate the
    # first predict_samples examples' prompts and score BLEU-4/ROUGE vs the
    # gold completions (reference train/sft/workflow.py predict path)
    do_predict: bool = False
    predict_samples: int = 16
    # eval-loss cadence over the val_size split (reference
    # eval_strategy="steps" + eval_steps); None = evaluate once at the end
    # of training (only when val_size > 0)
    eval_steps: Optional[int] = None
    per_device_eval_batch_size: Optional[int] = None  # None = train batch
    # external metric trackers (reference ReporterCallback,
    # train/callbacks.py:356-385): tensorboard | wandb | swanlab | none;
    # a str or list. The JSONL trainer_log stays the durable record.
    report_to: Optional[str] = None


@dataclasses.dataclass
class FinetuneArgs:
    stage: str = "sft"  # pt | sft | dt | rm | dpo | kto | ppo
    finetuning_type: str = "full"  # full | freeze | lora | customize
    # --- distillation (dt) fields, finetuning_args.py:390-418 ---
    mixer: str = "GatedDeltaNet"
    mse_factor: float = 1000.0
    distill_temperature: float = 2.0
    distill_stage: int = 1
    distill_weights: Tuple[str, ...] = ("self_attn",)
    softmax_attention: Tuple[int, ...] = tuple(range(0, 36, 4))
    mixer_config: Optional[Dict[str, Any]] = None
    checkpoint_path: Optional[str] = None
    teacher_model_path: Optional[str] = None
    # --- custom optimizers (trainer_utils.py galore/apollo/loraplus/badam) ---
    use_optimizer: Optional[str] = None  # galore | apollo | loraplus | badam
    optimizer_rank: int = 8  # galore/apollo projection rank
    optimizer_update_gap: int = 200  # projection refresh interval
    loraplus_lr_ratio: float = 16.0
    badam_num_blocks: int = 4
    badam_switch_interval: int = 50
    # --- preference stages (rm/dpo/kto/ppo), finetuning_args RLHF group ---
    pref_beta: float = 0.1
    pref_loss: str = "sigmoid"  # sigmoid | ipo | simpo | orpo
    # --- ppo ---
    ppo_epochs: int = 1
    ppo_clip_range: float = 0.2
    ppo_kl_coef: float = 0.05
    ppo_vf_coef: float = 0.1
    ppo_gamma: float = 1.0
    ppo_lam: float = 0.95
    ppo_rollout_len: int = 32
    reward_model_path: Optional[str] = None
    # --- freeze ---
    freeze_trainable_layers: int = 2
    # --- lora ---
    lora_rank: int = 8
    lora_alpha: int = 16
    lora_dropout: float = 0.0
    lora_target: Tuple[str, ...] = ("q_proj", "k_proj", "v_proj", "o_proj")
    # reference finetuning_args.py:100-107 peft kwargs
    use_rslora: bool = False  # scale alpha/sqrt(r) instead of alpha/r
    use_dora: bool = False  # weight-decomposed LoRA (magnitude + direction)


@dataclasses.dataclass
class GenArgs:
    max_new_tokens: int = 512
    temperature: float = 0.7
    top_k: int = 50
    top_p: float = 0.9
    repetition_penalty: float = 1.0
    do_sample: bool = True
    # > 0 enables lossless prompt-lookup speculative decoding for GREEDY
    # text-only requests (speculative.py; chat/api)
    draft_k: int = 0
    # > 1 switches text-only chat to beam search (beam.py; reference
    # generating_args.py:45). Greedy scoring — do_sample knobs are refused.
    num_beams: int = 1
    length_penalty: float = 1.0


@dataclasses.dataclass
class EvalArgs:
    """MCQ evaluation knobs (reference hparams/evaluation_args.py)."""

    n_shot: int = 5
    eval_batch_size: int = 4
    eval_save_dir: Optional[str] = None
    lang: str = "en"


@dataclasses.dataclass
class AllArgs:
    model: ModelArgs
    data: DataArgs
    train: TrainArgs
    finetune: FinetuneArgs
    gen: GenArgs
    eval: "EvalArgs" = dataclasses.field(default_factory=lambda: EvalArgs())


def _fill(cls, src: Dict[str, Any], used: set) -> Any:
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in src.items():
        if k in fields:
            if isinstance(v, list):
                v = tuple(v)
            kwargs[k] = v
            used.add(k)
    return cls(**kwargs)


def parse_args(config: Dict[str, Any]) -> AllArgs:
    """Parse a flat YAML dict into the five groups; unknown keys raise."""
    used: set = set()
    out = AllArgs(
        model=_fill(ModelArgs, config, used),
        data=_fill(DataArgs, config, used),
        train=_fill(TrainArgs, config, used),
        finetune=_fill(FinetuneArgs, config, used),
        gen=_fill(GenArgs, config, used),
        eval=_fill(EvalArgs, config, used),
    )
    unknown = set(config) - used
    if unknown:
        raise ValueError(f"unknown config keys: {sorted(unknown)}")
    if out.data.custom_template:
        # every entry point parses args through here, so registering the
        # user template at parse time makes `template: custom` resolvable
        # from any workflow (train/chat/api/eval/export)
        from .data.template import register_custom_template

        register_custom_template(dict(out.data.custom_template))
    return out


def load_yaml_args(path: str) -> AllArgs:
    import yaml

    with open(path) as f:
        return parse_args(yaml.safe_load(f) or {})
