"""Training loop and the workflows of every stage (torch port of the
one-device part of infinitevl_tpu/train/trainer.py): build config and
params -> dataset -> optimizer -> step loop with JSONL logging, checkpoints
and resume. `run_exp` dispatches pt / sft (`run_sft`), dt (`run_dt`), rm,
dpo, kto (`run_rm`, `run_dpo`, `run_kto`) and ppo (train/ppo.py).

Each workflow runs on the CUDA card unless `device="cpu"` is passed.
Collators are numpy (their batches equal the JAX package's arrays); the
step functions move each batch to the parameters' device. Stages and
options that are not ported yet raise NotImplementedError naming
themselves; none is silently ignored.

`run_sft` and `run_dt` train on a (data_parallel x model_parallel) mesh
as one process per rank (torchrun, or parallel/launch.spawn_ranks): every
rank collates the same global batch (per_device_train_batch_size x
data_parallel rows, as JAX's) and trains the rows of its data coordinate,
under `param_mode` tp (the rules' model axis: tensor parallelism),
fsdp (the model axis and, besides, the leaves sharded over data) or
replicated (parallel/sharding.py). Rank 0 alone writes the log, the
reporters' files and the checkpoints, which hold the state gathered over
both axes in the one-process format; a resume loads each rank's slices.
`streaming: true` reads, mixes and encodes the datasets lazily
(`build_dataset_stream`, `collate_stream`)."""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import InfiniteVLConfig, infinitevl_3b, tiny_config
from ..data.loader import (
    encode_kto,
    encode_pairwise,
    encode_supervised,
    encode_supervised_mm,
    encode_supervised_stream,
    load_dataset_info,
    load_mixed_examples,
    pack_examples,
    resolve_tokenizer,
    shift_labels,
    stream_mixed_examples,
)
from ..device import Device, resolve_device
from ..hparams import AllArgs
from ..models.convert import convert_attention, trainable_mask
from ..models.params import init_params, init_text_params, load_hf_checkpoint
from ..parallel.sharding import (
    Mesh,
    create_mesh,
    gather_full,
    gather_opt_state,
    global_sum,
    load_into,
    load_opt_state,
    rank_rows,
    rank_rows_mm,
    shard_params,
    use_mesh,
    whole_batch,
    world_rank,
    world_size,
)
from ..utils.checkpoint import (
    filter_softmax_layers,
    merge_params,
    restore_train_state,
    save_train_state,
    tree_map,
)
from ..utils.logging import TrainerLog, get_logger, make_reporter
from .distill import apply_trainable_mask, make_stage1_step, make_stage2_step, stage2_mask
from .step import (
    full_finetune_leaf,
    make_mm_sft_train_step,
    make_optimizer,
    make_sft_eval_fn,
    make_sft_train_step,
    set_trainable,
    trainable_leaves,
)

logger = get_logger(__name__)

# Optional cooperative abort: an Event checked once per step.
ABORT_EVENT = None


def build_config(args: AllArgs) -> InfiniteVLConfig:
    ckpt_cfg = (
        os.path.join(args.model.model_name_or_path, "config.json")
        if args.model.model_name_or_path
        else None
    )
    if ckpt_cfg and os.path.exists(ckpt_cfg):
        from ..config import from_hf_json

        cfg = from_hf_json(ckpt_cfg)
    elif args.model.config_preset == "tiny":
        cfg = tiny_config()
    else:
        cfg = infinitevl_3b()
    text = dataclasses.replace(
        cfg.text,
        use_pallas_swa=args.model.use_pallas_swa,
        conv_carry=args.model.conv_carry,
    )
    if args.model.rope_scaling:
        # enlarge the context window and derive the scaling factor from it
        cur = text.max_position_embeddings
        mml = args.model.model_max_length
        kw = {"rope_type": args.model.rope_scaling}
        if mml and mml > cur:
            kw["rope_factor"] = float(int(np.ceil(mml / cur)))
            kw["max_position_embeddings"] = mml
            if args.model.rope_scaling in ("dynamic", "yarn", "llama3"):
                kw["rope_original_max_position_embeddings"] = cur
        else:
            if mml:
                logger.warning(
                    "model_max_length <= max_position_embeddings; using rope factor 2.0"
                )
            kw["rope_factor"] = 2.0
        text = dataclasses.replace(text, **kw)
    return dataclasses.replace(cfg, text=text)


def _load_examples(args: AllArgs) -> List[Dict[str, Any]]:
    """The rows of the datasets `dataset` names (comma-separated, mixed by
    mix_strategy), cut at max_samples."""
    registry = load_dataset_info(os.path.join(args.data.dataset_dir, "dataset_info.json"))
    names = [n.strip() for n in args.data.dataset.split(",") if n.strip()]
    examples = load_mixed_examples(
        names, registry, args.data.dataset_dir,
        mix_strategy=args.data.mix_strategy,
        interleave_probs=(
            list(args.data.interleave_probs) if args.data.interleave_probs else None
        ),
        seed=args.train.seed,
    )
    if args.data.max_samples:
        examples = examples[: args.data.max_samples]
    return examples


def build_dataset_stream(args: AllArgs, tokenizer=None) -> Iterator[Dict[str, np.ndarray]]:
    """Lazy dataset pipeline for streaming mode: the registry's local files
    read line by line, mixed and encoded on the fly; collate_stream adds the
    shuffle reservoir and windowed packing. The reference's constraint set
    raises ValueError."""
    if args.finetune.stage not in ("sft", "pt"):
        raise ValueError("streaming is only supported for the sft/pt stages")
    if args.train.max_steps is None:
        raise ValueError("streaming datasets have no length — set `max_steps` to bound the run")
    if args.data.max_samples:
        raise ValueError("`max_samples` cannot cap a streaming dataset; drop it or disable "
                         "`streaming`")
    if 0 < args.data.val_size < 1:
        raise ValueError("fractional `val_size` is incompatible with `streaming`")
    registry = load_dataset_info(os.path.join(args.data.dataset_dir, "dataset_info.json"))
    names = [n.strip() for n in args.data.dataset.split(",") if n.strip()]
    examples = stream_mixed_examples(
        names, registry, args.data.dataset_dir,
        mix_strategy=args.data.mix_strategy,
        interleave_probs=(
            list(args.data.interleave_probs) if args.data.interleave_probs else None
        ),
        seed=args.train.seed,
    )
    tokenizer = resolve_tokenizer(args, None, tokenizer)
    return encode_supervised_stream(examples, tokenizer, args.data.template,
                                    args.data.cutoff_len)


def build_dataset(
    args: AllArgs, tokenizer=None, cfg: Optional[InfiniteVLConfig] = None
) -> List[Dict[str, np.ndarray]]:
    if args.data.streaming:
        return build_dataset_stream(args, tokenizer)
    examples = _load_examples(args)
    has_media = any(ex.get("images") or ex.get("videos") for ex in examples)
    if has_media:
        cfg = cfg or build_config(args)
        tokenizer = resolve_tokenizer(args, cfg, tokenizer)
        if args.data.packing:
            logger.warning("packing is not supported for multimodal datasets; disabled")
        return encode_supervised_mm(
            examples, tokenizer, cfg, args.data.template, args.data.cutoff_len,
            dataset_dir=args.data.dataset_dir,
            min_pixels=args.data.image_min_pixels,
            max_pixels=args.data.image_max_pixels,
            video_fps=args.data.video_fps,
            video_min_pixels=args.data.video_min_pixels,
            video_max_pixels=args.data.video_max_pixels,
        )
    tokenizer = resolve_tokenizer(args, None, tokenizer)
    enc = encode_supervised(examples, tokenizer, args.data.template, args.data.cutoff_len)
    if args.data.packing:
        return pack_examples(enc, args.data.cutoff_len)
    return enc


def is_multimodal(data: List[Dict[str, Any]]) -> bool:
    return any(
        e.get("pixel_values") is not None or e.get("pixel_values_videos") is not None
        for e in data
    )


def _rows_to_batch(
    rows: List[Dict[str, np.ndarray]],
    batch_size: int,
    cutoff_len: int,
    pad_id: int = 0,
) -> Dict[str, np.ndarray]:
    """Build one fixed-shape [B, cutoff_len] text batch from <= B rows."""
    ids = np.full((batch_size, cutoff_len), pad_id, np.int64)
    labels = np.full((batch_size, cutoff_len), -100, np.int64)
    seg = np.zeros((batch_size, cutoff_len), np.int32)
    for r, e in enumerate(rows):
        L = min(len(e["input_ids"]), cutoff_len)
        ids[r, :L] = e["input_ids"][:L]
        labels[r, :L] = e["labels"][:L]
        seg[r, :L] = e.get("segment_ids", np.ones(len(e["input_ids"]), np.int32))[:L]
    # rope positions restart at every packed-segment boundary
    pos = np.zeros((batch_size, cutoff_len), np.int64)
    ar = np.arange(cutoff_len)
    for r in range(batch_size):
        boundary = np.zeros(cutoff_len, bool)
        boundary[0] = True
        boundary[1:] = seg[r, 1:] != seg[r, :-1]
        starts = np.where(boundary, ar, 0)
        pos[r] = ar - np.maximum.accumulate(starts)
    pos3 = np.ascontiguousarray(np.broadcast_to(pos[None], (3, batch_size, cutoff_len)))
    shifted = shift_labels(labels)
    # never supervise across a packed-segment boundary
    cross = np.zeros_like(seg, dtype=bool)
    cross[:, :-1] = seg[:, 1:] != seg[:, :-1]
    shifted[cross] = -100
    return {
        "input_ids": ids,
        "labels": shifted,
        "position_ids": pos3,
        "segment_ids": seg,
        "_n_tokens": np.int64((seg > 0).sum()),
    }


def _epoch_order(n: int, batch_size: int, seed: int, epochs: float):
    rng = np.random.RandomState(seed)
    total = int(np.ceil(epochs * n / batch_size))
    order: List[int] = []
    for _ in range(int(np.ceil(total * batch_size / n)) + 1):
        order.extend(rng.permutation(n).tolist())
    return total, order


def collate(
    examples: List[Dict[str, np.ndarray]],
    batch_size: int,
    cutoff_len: int,
    pad_id: int = 0,
    seed: int = 0,
    epochs: float = 1.0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield fixed-shape [B, cutoff_len] batches up to `epochs`."""
    total, order = _epoch_order(len(examples), batch_size, seed, epochs)
    for b in range(total):
        idxs = order[b * batch_size : (b + 1) * batch_size]
        yield _rows_to_batch([examples[i] for i in idxs], batch_size, cutoff_len, pad_id)


def collate_stream(
    encoded: Iterable[Dict[str, np.ndarray]],
    batch_size: int,
    cutoff_len: int,
    pad_id: int = 0,
    seed: int = 0,
    buffer_size: int = 16384,
    packing: bool = False,
) -> Iterator[Dict[str, np.ndarray]]:
    """Streaming collator: consume a lazy encoded-example iterator, shuffle
    through a `buffer_size` reservoir, optionally greedy-knapsack-pack each
    refill window, and yield fixed-shape batches until the stream is
    exhausted (max_steps bounds training in streaming mode)."""
    rng = np.random.RandomState(seed)
    it = iter(encoded)
    exhausted = False
    carry: List[Dict[str, np.ndarray]] = []  # post-pack tail rows
    while not exhausted:
        window: List[Dict[str, np.ndarray]] = []
        for _ in range(max(buffer_size, batch_size)):
            try:
                window.append(next(it))
            except StopIteration:
                exhausted = True
                break
        if packing and window:
            window = pack_examples(window, cutoff_len, pad_token_id=pad_id)
        rows = carry + window
        if not rows:
            return
        order = rng.permutation(len(rows))
        n_full = len(rows) // batch_size
        for b in range(n_full):
            picked = [rows[i] for i in order[b * batch_size : (b + 1) * batch_size]]
            yield _rows_to_batch(picked, batch_size, cutoff_len, pad_id)
        # tail rows (< batch_size) carry into the next window; the final
        # window's tail rides out as one padded short batch
        carry = [rows[i] for i in order[n_full * batch_size :]]
    if carry:
        yield _rows_to_batch(carry, batch_size, cutoff_len, pad_id)


def _grids_key(grids) -> Optional[tuple]:
    """Hashable grid signature (the key of the vision plan cache)."""
    if grids is None or len(grids) == 0:
        return None
    return tuple(tuple(int(x) for x in g) for g in grids)


def collate_mm(
    examples: List[Dict[str, Any]],
    cfg: InfiniteVLConfig,
    batch_size: int,
    cutoff_len: int,
    pad_id: int = 0,
    seed: int = 0,
    epochs: float = 1.0,
) -> Iterator[tuple]:
    """Multimodal collator: yields (batch, image_grids, video_grids) with the
    batch carrying packed pixel tensors and vision-aware mrope positions
    from get_rope_index."""
    from ..models.infinitevl import get_rope_index

    total, order = _epoch_order(len(examples), batch_size, seed, epochs)
    for b in range(total):
        idxs = order[b * batch_size : (b + 1) * batch_size]
        ids = np.full((batch_size, cutoff_len), pad_id, np.int64)
        labels = np.full((batch_size, cutoff_len), -100, np.int64)
        am = np.zeros((batch_size, cutoff_len), np.int64)
        pvs, igrids, pvvs, vgrids, spgs = [], [], [], [], []
        for r, i in enumerate(idxs):
            e = examples[i]
            L = min(len(e["input_ids"]), cutoff_len)
            ids[r, :L] = e["input_ids"][:L]
            labels[r, :L] = e["labels"][:L]
            am[r, :L] = 1
            if e.get("pixel_values") is not None:
                pvs.append(e["pixel_values"])
                igrids.extend(map(tuple, e["image_grid_thw"].tolist()))
            if e.get("pixel_values_videos") is not None:
                pvvs.append(e["pixel_values_videos"])
                vgrids.extend(map(tuple, e["video_grid_thw"].tolist()))
                spgs.extend(e["second_per_grid_ts"])
        pos, _ = get_rope_index(
            cfg, ids,
            image_grid_thw=np.asarray(igrids) if igrids else None,
            video_grid_thw=np.asarray(vgrids) if vgrids else None,
            second_per_grid_ts=spgs or None,
            attention_mask=am,
        )
        batch = {
            "input_ids": ids,
            "labels": shift_labels(labels),
            "position_ids": np.asarray(pos),
            # 1 = real token, 0 = padding (masked in attention and delta rule)
            "segment_ids": am.astype(np.int32),
            "_n_tokens": np.int64(am.sum()),
        }
        if pvs:
            batch["pixel_values"] = np.concatenate(pvs)
        if pvvs:
            batch["pixel_values_videos"] = np.concatenate(pvvs)
        yield batch, _grids_key(igrids), _grids_key(vgrids)


def build_preference_dataset(
    args: AllArgs, tokenizer=None, kind: str = "pairwise"
) -> List[Dict[str, np.ndarray]]:
    """Pairwise (rm/dpo) or unpaired-feedback (kto) dataset encoding."""
    examples = _load_examples(args)
    tokenizer = resolve_tokenizer(args, None, tokenizer)
    if kind == "pairwise":
        return encode_pairwise(examples, tokenizer, args.data.template, args.data.cutoff_len)
    return encode_kto(examples, tokenizer, args.data.template, args.data.cutoff_len)


def _pad_rows(rows: List[np.ndarray], cutoff_len: int, fill) -> np.ndarray:
    out = np.full((len(rows), cutoff_len), fill, np.int64)
    for r, row in enumerate(rows):
        L = min(len(row), cutoff_len)
        out[r, :L] = row[:L]
    return out


def collate_pairwise(
    examples: List[Dict[str, np.ndarray]],
    batch_size: int,
    cutoff_len: int,
    pad_id: int = 0,
    seed: int = 0,
    epochs: float = 1.0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Chosen/rejected batches for rm/dpo (reference PairwiseDataCollator,
    data/collator.py:219-253). Labels are next-token shifted; pads stay
    right-aligned so causal attention never sees them from real tokens."""
    total, order = _epoch_order(len(examples), batch_size, seed, epochs)
    ar = np.arange(cutoff_len)
    pos3 = np.ascontiguousarray(np.broadcast_to(ar[None, None], (3, batch_size, cutoff_len)))
    for b in range(total):
        idxs = order[b * batch_size : (b + 1) * batch_size]
        batch = {"position_ids": pos3}
        n_tok = 0
        for side in ("chosen", "rejected"):
            ids = _pad_rows([examples[i][f"{side}_ids"] for i in idxs], cutoff_len, pad_id)
            labels = _pad_rows([examples[i][f"{side}_labels"] for i in idxs], cutoff_len, -100)
            batch[f"{side}_ids"] = ids
            batch[f"{side}_labels"] = shift_labels(labels)
            n_tok += sum(len(examples[i][f"{side}_ids"]) for i in idxs)
        batch["_n_tokens"] = np.int64(n_tok)
        yield batch


def collate_kto(
    examples: List[Dict[str, np.ndarray]],
    batch_size: int,
    cutoff_len: int,
    pad_id: int = 0,
    seed: int = 0,
    epochs: float = 1.0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Unpaired feedback batches (reference KTODataCollatorWithPadding)."""
    total, order = _epoch_order(len(examples), batch_size, seed, epochs)
    ar = np.arange(cutoff_len)
    pos3 = np.ascontiguousarray(np.broadcast_to(ar[None, None], (3, batch_size, cutoff_len)))
    for b in range(total):
        idxs = order[b * batch_size : (b + 1) * batch_size]
        ids = _pad_rows([examples[i]["input_ids"] for i in idxs], cutoff_len, pad_id)
        labels = _pad_rows([examples[i]["labels"] for i in idxs], cutoff_len, -100)
        yield {
            "input_ids": ids,
            "labels": shift_labels(labels),
            "position_ids": pos3,
            "is_desirable": np.array([examples[i]["is_desirable"] for i in idxs], bool),
            "_n_tokens": np.int64(sum(len(examples[i]["input_ids"]) for i in idxs)),
        }


def _maybe_resume(trainer: "Trainer", args: AllArgs) -> None:
    """resume_from_checkpoint: a path, or "auto" to pick up the latest
    checkpoint under output_dir/checkpoints (starts fresh when none exists)."""
    rfc = args.train.resume_from_checkpoint
    if not rfc:
        return
    trainer.resume(None if str(rfc).lower() in ("auto", "true", "1") else rfc)


class Trainer:
    """Step loop with logging, checkpoints and resume. `params` (or the
    adapter tree) and `opt_state` are updated in place by `step_fn`.

    Under data parallelism (`mesh`) every rank runs the loop over its rows
    of each global batch: the loss it logs is the global batch's (the
    ranks' parts summed), the eval pass runs on whole batches, and rank 0
    alone writes files. A checkpoint holds the gathered state in the
    one-process format, so a state saved by n ranks resumes in m."""

    def __init__(
        self,
        step_fn: Callable,  # (params, opt_state, *extra, batch, *statics) -> (params, opt_state, loss)
        params,
        opt_state,
        output_dir: str,
        logging_steps: int = 10,
        save_steps: int = 5000,
        extra_step_args: tuple = (),
        eval_hook: Optional[Callable] = None,  # (params) -> eval loss
        eval_steps: Optional[int] = None,  # None = once at the end of training
        report_to=None,
        mesh: Optional[Mesh] = None,
    ):
        self.mesh = mesh
        self.main = world_rank() == 0
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.output_dir = output_dir
        self.logging_steps = logging_steps
        self.save_steps = save_steps
        self.extra = extra_step_args
        self.eval_hook = eval_hook
        self.eval_steps = eval_steps
        self.log = TrainerLog(output_dir)  # writes on rank 0 alone
        self.reporter = make_reporter(report_to if self.main else None, output_dir)
        self.step = 0
        self._eval_at = -1

    def evaluate(self):
        """Eval-loss pass over the held-out split."""
        if self.eval_hook is None or self.step == self._eval_at:
            return None
        self._eval_at = self.step
        with whole_batch():  # every rank evaluates every held-out row
            el = float(self.eval_hook(self.params))
        self.log.log(self.step, eval_loss=round(el, 6))
        self.reporter.log(self.step, eval_loss=el)
        logger.info(f"step {self.step}: eval_loss={el:.4f}")
        return el

    def _trainable(self) -> List[torch.Tensor]:
        return [t for _, t in trainable_leaves(self.params)]

    def resume(self, path: Optional[str] = None):
        ckpt_dir = path or os.path.join(self.output_dir, "checkpoints")
        if self.mesh is not None:
            # the one-process state, each rank taking its slices in place
            step, state = restore_train_state(ckpt_dir)
            if state is not None:
                load_into(self.params, state["params"])
                load_opt_state(self.opt_state, state["opt_state"], self._trainable())
                self.step = step
                logger.info(f"resumed from step {step}")
            return
        step, state = restore_train_state(
            ckpt_dir, template={"params": self.params, "opt_state": self.opt_state}
        )
        if state is not None:
            self.params = state["params"]
            self.opt_state = state["opt_state"]
            self.step = step
            logger.info(f"resumed from step {step}")

    def save(self):
        state = {"params": self.params, "opt_state": self.opt_state}
        if self.mesh is not None:  # every rank gathers; rank 0 writes
            state = {"params": gather_full(self.params),
                     "opt_state": gather_opt_state(self.opt_state, self._trainable())}
        if self.main:
            save_train_state(os.path.join(self.output_dir, "checkpoints"), self.step, state)
        if self.mesh is not None:
            dist.barrier()

    def train(self, batches: Iterable, max_steps: Optional[int] = None):
        """Run the step loop over `batches`. After `resume`, the batches the
        restored steps already consumed are skipped (the collators are
        deterministic in their seed), so a resumed run takes the steps the
        uninterrupted run would have taken."""
        t0 = time.time()
        tokens = 0
        skip = self.step
        for item in batches:
            if skip > 0:
                skip -= 1
                continue
            if max_steps is not None and self.step >= max_steps:
                break
            if ABORT_EVENT is not None and ABORT_EVENT.is_set():
                logger.info(f"abort requested at step {self.step}")
                break
            # collators may yield (batch, *grids) for the multimodal step
            batch, statics = (item[0], item[1:]) if isinstance(item, tuple) else (item, ())
            # honest tokens/sec: collators report real (non-pad) counts
            ntok = batch.pop("_n_tokens", None)
            if ntok is None:
                ids = batch.get("input_ids")
                ntok = np.prod(ids.shape) if ids is not None else 0
            self.params, self.opt_state, loss = self.step_fn(
                self.params, self.opt_state, *self.extra, batch, *statics
            )
            loss = global_sum(loss)  # data parallelism: the global batch's loss
            self.step += 1
            tokens += int(ntok)
            if self.step % self.logging_steps == 0 or self.step == 1:
                lv = float(loss)  # the host waits for the device here
                tps = tokens / (time.time() - t0)
                self.log.log(self.step, loss=lv, tokens_per_sec=round(tps, 1))
                self.reporter.log(self.step, loss=lv, tokens_per_sec=tps)
                logger.info(f"step {self.step}: loss={lv:.4f} tps={tps:.0f}")
            if self.eval_hook is not None and self.eval_steps \
                    and self.step % self.eval_steps == 0:
                self.evaluate()
            if self.step % self.save_steps == 0:
                self.save()
        self.evaluate()
        self.save()
        if self.main:
            self.log.plot_loss()
        self.reporter.close()
        return self.params


def _total_steps(args: AllArgs, data) -> int:
    """max_steps, or the steps of num_train_epochs over the rows of `data`
    at per_device_train_batch_size (JAX's count, whatever data_parallel;
    a stream, which has no length, needs max_steps)."""
    return args.train.max_steps or int(
        np.ceil(args.train.num_train_epochs * len(data) / args.train.per_device_train_batch_size))


def _make_tx(args: AllArgs, steps: int):
    """Optimizer from TrainArgs; gradient_accumulation_steps > 1 takes one
    optimizer update per k micro-batches (the mean of their gradients).
    FinetuneArgs.use_optimizer swaps in a custom optimizer (train/optim.py)
    with JAX's keyword arguments and its constant learning rate, after the
    same global-norm clip."""
    ft, tr = args.finetune, args.train
    if ft.use_optimizer:
        from .optim import make_custom_optimizer

        kw = {}
        if ft.use_optimizer in ("galore", "apollo"):
            kw = dict(rank=ft.optimizer_rank, update_proj_gap=ft.optimizer_update_gap)
        elif ft.use_optimizer == "loraplus":
            kw = dict(lr_ratio=ft.loraplus_lr_ratio, weight_decay=tr.weight_decay)
        elif ft.use_optimizer == "badam":
            kw = dict(num_blocks=ft.badam_num_blocks,
                      switch_interval=ft.badam_switch_interval)
        return make_custom_optimizer(ft.use_optimizer, tr.learning_rate,
                                     grad_clip=tr.max_grad_norm,
                                     accumulation_steps=tr.gradient_accumulation_steps, **kw)
    return make_optimizer(
        args.train.learning_rate,
        args.train.weight_decay,
        grad_clip=args.train.max_grad_norm,
        warmup_steps=args.train.warmup_steps,
        total_steps=steps,
        schedule=args.train.lr_scheduler_type,
        accumulation_steps=args.train.gradient_accumulation_steps,
    )


def _load_or_init_params(args: AllArgs, cfg, mm: bool, dtype, device):
    """Full (text + visual) tree for multimodal training, text-only otherwise:
    the HF checkpoint at `model_name_or_path`, or random weights from the seed."""
    if args.model.model_name_or_path:
        full = load_hf_checkpoint(args.model.model_name_or_path, cfg, dtype, device=device)
        return full if mm else {"text": full["text"]}
    gen = torch.Generator(device=device).manual_seed(args.train.seed)
    if mm:
        return init_params(cfg, gen, device, dtype)
    return {"text": init_text_params(cfg.text, gen, device, dtype)}


def _batches(args: AllArgs, data, cfg, mm: bool, mesh: Optional[Mesh] = None):
    """The global batches, per_device_train_batch_size x data_parallel rows
    each (JAX's), from the seed; with a mesh, this rank's rows of each."""
    B = args.train.per_device_train_batch_size * max(args.train.data_parallel, 1)
    if args.data.streaming:
        batches = collate_stream(data, B, args.data.cutoff_len, seed=args.train.seed,
                                 buffer_size=args.data.buffer_size, packing=args.data.packing)
    elif mm:
        batches = collate_mm(data, cfg, B, args.data.cutoff_len, seed=args.train.seed,
                             epochs=args.train.num_train_epochs)
    else:
        batches = collate(data, B, args.data.cutoff_len, seed=args.train.seed,
                          epochs=args.train.num_train_epochs)
    if mesh is None:
        return batches
    if mm:
        return (rank_rows_mm(item, mesh, cfg) for item in batches)
    return (rank_rows(batch, mesh) for batch in batches)


def _split_val(args: AllArgs, data, mm: bool):
    """Carve the val_size held-out split off the training data: a fraction
    samples a seeded permutation, an integer >= 1 takes an absolute count
    (a stream gives up its first val_size examples). Text-only: multimodal
    data skips it with a warning."""
    vs = args.data.val_size
    if not vs:
        return data, None
    if mm:
        logger.warning("val_size eval is text-only; skipped for multimodal data")
        return data, None
    if args.data.streaming:
        import itertools

        it = iter(data)
        return it, list(itertools.islice(it, int(vs)))
    n = len(data)
    n_val = int(vs) if vs >= 1 else max(1, int(n * vs))
    n_val = min(n_val, n - 1)
    order = np.random.RandomState(args.train.seed).permutation(n)
    return [data[i] for i in order[n_val:]], [data[i] for i in order[:n_val]]


def _eval_hook_factory(args: AllArgs, eval_data, eval_fn, extra: tuple = ()):
    """Token-weighted mean loss over the held-out split; `eval_fn` is
    (params, *extra, batch) -> scalar loss."""
    B = args.train.per_device_eval_batch_size or args.train.per_device_train_batch_size

    def hook(params):
        tot, n = 0.0, 0
        for batch in collate(eval_data, B, args.data.cutoff_len, seed=0):
            ntok = int(batch.pop("_n_tokens"))
            tot += float(eval_fn(params, *extra, batch)) * ntok
            n += ntok
        return tot / max(n, 1)

    return hook


def predict_and_score(params, cfg, data, tokenizer, args: AllArgs, device=None):
    """Greedy-generate each example's prompt through `Generator`, score
    BLEU-4 / ROUGE against the gold completion, and write
    generated_predictions.jsonl and predict_results.json to output_dir."""
    from ..eval.text_metrics import compute_similarity
    from ..generation import Generator

    dtype = torch.bfloat16 if args.train.bf16 else torch.float32
    gen = Generator(params, cfg, dtype=dtype, device=device)
    preds, refs, rows = [], [], []
    for ex in data[: args.train.predict_samples]:
        ids = np.asarray(ex["input_ids"])
        labels = np.asarray(ex["labels"])
        sup = np.where(labels != -100)[0]
        if len(sup) == 0 or sup[0] == 0:
            continue
        cut = int(sup[0])
        # score only the first assistant span: the generation prompt ends
        # before turn 1
        after = labels[cut:]
        span_end = np.argmax(after == -100) if (after == -100).any() else len(after)
        gold = [int(t) for t in after[:span_end]]
        out = gen.generate(
            ids[None, :cut],
            max_new_tokens=min(len(gold) + 8, args.gen.max_new_tokens),
            temperature=0.0,
        )
        pred = tokenizer.decode(out[0].tolist(), skip_special_tokens=True)
        ref = tokenizer.decode(gold, skip_special_tokens=True)
        preds.append(pred)
        refs.append(ref)
        rows.append({"predict": pred, "label": ref})
    scores = compute_similarity(preds, refs)
    scores["samples"] = len(rows)
    os.makedirs(args.train.output_dir, exist_ok=True)
    with open(os.path.join(args.train.output_dir, "generated_predictions.jsonl"), "w") as f:
        for row in rows:
            f.write(json.dumps(row, ensure_ascii=False) + "\n")
    with open(os.path.join(args.train.output_dir, "predict_results.json"), "w") as f:
        json.dump(scores, f, indent=2)
    return scores


def _maybe_mesh(args: AllArgs) -> Optional[Mesh]:
    """The (data, model) mesh of sft / pt / dt, None for one process. The
    process group's world must be data_parallel x model_parallel."""
    t = args.train
    if t.data_parallel * t.model_parallel <= 1 and world_size() == 1:
        return None
    return create_mesh(data=t.data_parallel, model=t.model_parallel)


def _refuse_multi_rank(stage: str) -> None:
    """The preference stages train in one process, as JAX's do (they never
    take a mesh): data_parallel is read and ignored there, and a launch of
    several ranks raises."""
    if world_size() > 1:
        raise NotImplementedError(
            f"stage {stage!r} across {world_size()} ranks: the preference stages train in "
            "one process (data_parallel does not apply to them, as in JAX)")


def run_sft(args: AllArgs, tokenizer=None, device: Optional[Device] = None):
    """SFT / PT workflow: text-only or multimodal, full / freeze / lora
    finetuning, QLoRA with `quantization_bit: 8`, data parallelism over the
    process group's ranks (`data_parallel`, `model_parallel`, `param_mode`),
    pipeline parallelism with `pipeline_stages` > 1 (`_run_sft_pipeline`).
    Runs on the CUDA
    card unless `device="cpu"`. Returns the final params (LoRA: merged),
    whole on every rank."""
    # a pipelined run makes its (pipe, data, model) mesh once its checks pass
    mesh = None if args.train.pipeline_stages > 1 else _maybe_mesh(args)
    with use_mesh(mesh):
        return _run_sft(args, tokenizer, resolve_device(device), mesh)


def _run_sft(args: AllArgs, tokenizer, device: torch.device, mesh: Optional[Mesh]):
    cfg = build_config(args)
    tcfg = cfg.text
    dtype = torch.bfloat16 if args.train.bf16 else torch.float32
    mode = args.train.param_mode
    # one tokenizer instance for the whole workflow: SimpleTokenizer grows
    # its vocab while encoding, so do_predict must decode with the instance
    # that encoded the dataset
    tokenizer = resolve_tokenizer(args, cfg, tokenizer)
    data = build_dataset(args, tokenizer, cfg=cfg)
    # a stream is lazy and text-only: nothing of it is read before training
    mm = False if args.data.streaming else is_multimodal(data)
    data, eval_data = _split_val(args, data, mm)
    predict = args.train.do_predict and not mm and not args.data.streaming
    if args.train.pipeline_stages > 1:
        return _run_sft_pipeline(args, cfg, data, tokenizer, mm, dtype, device, predict)
    params = _load_or_init_params(args, cfg, mm, dtype, device)
    if args.model.quantization_bit is not None:
        # QLoRA: int8 frozen base + rank-r adapters
        if args.model.quantization_bit != 8:
            raise ValueError(
                "only quantization_bit: 8 is supported for TRAINING (QLoRA); int4 "
                "is a serving-only mode (Generator(quant='int4'))"
            )
        if args.finetune.finetuning_type != "lora":
            raise ValueError(
                "quantization_bit requires finetuning_type: lora (the quantized "
                "base is frozen; int8 leaves carry no gradients)"
            )
        from ..models.quant import quantize_params

        params = quantize_params(params)
    steps = _total_steps(args, data)
    tx = _make_tx(args, steps)
    ft = args.finetune.finetuning_type
    common = dict(eval_steps=args.train.eval_steps, report_to=args.train.report_to, mesh=mesh)
    batches = _batches(args, data, cfg, mm, mesh)
    if ft == "lora":
        from .lora import init_lora, make_lora_eval_fn, make_lora_sft_step, merge_lora

        kw = dict(alpha=args.finetune.lora_alpha, rank=args.finetune.lora_rank,
                  use_rslora=args.finetune.use_rslora)
        set_trainable(params, lambda path, leaf: False)
        lora = init_lora(  # from the whole kernels; the adapters stay replicated
            params, torch.Generator(device=device).manual_seed(args.train.seed + 1),
            rank=args.finetune.lora_rank, target=args.finetune.lora_target,
            use_dora=args.finetune.use_dora,
        )
        params = shard_params(params, mesh, mode)
        opt_state = tx.init(lora)
        step_fn = make_lora_sft_step(cfg, tx, remat=args.train.remat,
                                     remat_group=args.train.remat_group, **kw)
        eval_hook = None
        if eval_data:
            eval_fn = make_lora_eval_fn(cfg, **kw)
            eval_hook = _eval_hook_factory(
                args, eval_data, lambda l, b: eval_fn(l, params, b))
        trainer = Trainer(
            step_fn, lora, opt_state, args.train.output_dir,
            args.train.logging_steps, args.train.save_steps,
            extra_step_args=(params,), eval_hook=eval_hook, **common,
        )
        _maybe_resume(trainer, args)
        lora = trainer.train(batches, max_steps=steps)
        merged = merge_lora(gather_full(params), lora, **kw)
        if predict:
            predict_and_score(merged, cfg, data, tokenizer, args, device)
        return merged
    if ft == "freeze":
        # train only the last freeze_trainable_layers decoder layers. Frozen
        # leaves get no gradient here, so the clip norm is taken over the
        # trainable leaves (the JAX package differentiates every leaf, clips
        # by the norm of all of them and zeroes the frozen updates)
        first = tcfg.num_hidden_layers - args.finetune.freeze_trainable_layers
        set_trainable(
            params,
            lambda path, leaf: path.startswith("text/layers/")
            and int(path.split("/")[2]) >= first,
        )
    elif ft == "full":
        set_trainable(params, full_finetune_leaf)
    else:
        raise ValueError(f"unknown finetuning_type {ft!r} (full | freeze | lora)")
    params = shard_params(params, mesh, mode)
    opt_state = tx.init(params)  # the moments of a shard are the shard's
    if mm:
        step_fn = make_mm_sft_train_step(cfg, tx, remat=args.train.remat,
                                         remat_group=args.train.remat_group)
    else:
        step_fn = make_sft_train_step(tcfg, tx, remat=args.train.remat,
                                      remat_group=args.train.remat_group)
    eval_hook = None
    if eval_data:
        eval_hook = _eval_hook_factory(args, eval_data, make_sft_eval_fn(tcfg))
    trainer = Trainer(
        step_fn, params, opt_state, args.train.output_dir,
        args.train.logging_steps, args.train.save_steps, eval_hook=eval_hook, **common,
    )
    _maybe_resume(trainer, args)
    final = gather_full(trainer.train(batches, max_steps=steps))
    if predict:
        # text-only scoring
        predict_and_score(final, cfg, data, tokenizer, args, device)
    return final


class _PipeTrainer(Trainer):
    """The Trainer of a pipelined run: a checkpoint holds the whole model
    in the one-process layout (every stage's layers gathered over the pipe
    group, every slice over the data and model axes), which any run of the
    port resumes; a resume cuts it back into this rank's stage."""

    def resume(self, path: Optional[str] = None):
        from ..parallel.pipeline import load_pipeline_state

        step, state = restore_train_state(path or os.path.join(self.output_dir, "checkpoints"))
        if state is not None:
            load_pipeline_state(self.params, self.opt_state, state)
            self.step = step
            logger.info(f"resumed from step {step}")

    def save(self):
        from ..parallel.pipeline import pipeline_state

        state = pipeline_state(self.params, self.opt_state, self.mesh)  # every rank gathers
        if self.main:
            save_train_state(os.path.join(self.output_dir, "checkpoints"), self.step, state)
        if self.mesh is not None:
            dist.barrier()


def _run_sft_pipeline(args: AllArgs, cfg, data, tokenizer, mm: bool, dtype,
                      device: torch.device, predict: bool):
    """Pipelined SFT / PT (JAX's `_run_sft_pipeline`): `pipeline_stages`
    stages over a (pipe, data, model) world of ranks (parallel/pipeline.py,
    one process per rank), `n_microbatches` microbatches on the batch axis
    (`pipeline_schedule` gpipe or 1f1b) or on the sequence axis
    (`pp_microbatch_axis: sequence`, gpipe; parallel/pipeline_seq.py). In
    one process (a world of one, data and model 1) every stage runs in
    turn. Text-only full finetuning: the stage cut is of the decoder's
    layers. Rank 0 logs the loss (every rank holds it: the last stage's,
    summed over the pipe group) and writes checkpoints of the whole model
    in the one-process layout. Returns the whole per-layer params on every
    rank."""
    from ..parallel.pipeline import (
        create_pp_mesh,
        gather_stages,
        make_pp_sft_train_step,
        shard_stage,
    )
    from ..parallel.pipeline_seq import make_seq_pp_sft_train_step

    tcfg, t = cfg.text, args.train
    if mm:
        raise ValueError(
            "pipeline_stages > 1 is text-only (the ViT is not stage-cut); train multimodal "
            "recipes with data/model parallelism instead")
    if args.finetune.finetuning_type != "full":
        raise ValueError(
            "pipeline_stages > 1 requires finetuning_type: full (the stage cut is of the "
            "decoder's layers; adapters and freezing are not cut with it)")
    if args.model.quantization_bit is not None:
        raise ValueError("pipeline_stages > 1 does not compose with QLoRA")
    S, M, axis = t.pipeline_stages, t.n_microbatches, t.pp_microbatch_axis
    if axis not in ("batch", "sequence"):
        raise ValueError(f"unknown pp_microbatch_axis {axis!r} (batch | sequence)")
    if axis == "sequence":
        if t.pipeline_schedule != "gpipe":
            raise ValueError(
                "pp_microbatch_axis: sequence supports the gpipe schedule only (the 1f1b "
                "hand-schedule is batch-axis)")
        T = args.data.cutoff_len
        if T % M or (T // M) % tcfg.sliding_window:
            raise ValueError(
                f"sequence microbatching needs cutoff_len ({T}) divisible by n_microbatches "
                f"({M}) into chunks that are multiples of the sliding window "
                f"({tcfg.sliding_window})")
    else:
        B = t.per_device_train_batch_size * max(t.data_parallel, 1)
        if B % M:
            raise ValueError(
                f"global batch {B} (= per_device x data_parallel) must be divisible by "
                f"n_microbatches {M}")
        if (B // max(t.data_parallel, 1)) % M:
            raise ValueError(
                f"a data rank's {B // t.data_parallel} rows must be divisible by n_microbatches "
                f"{M} (each rank splits its own rows)")
    one = world_size() == 1 and t.data_parallel * t.model_parallel == 1
    mesh = None if one else create_pp_mesh(S, t.data_parallel, t.model_parallel)
    with use_mesh(mesh):
        params = _load_or_init_params(args, cfg, False, dtype, device)
        set_trainable(params, full_finetune_leaf)
        params = {"text": shard_stage(params["text"], tcfg, S, mesh, t.param_mode)}
        steps = _total_steps(args, data)
        tx = _make_tx(args, steps)
        opt_state = tx.init(params)
        step_fn = (make_seq_pp_sft_train_step(tcfg, tx, M, S, mesh=mesh, remat=t.remat)
                   if axis == "sequence" else
                   make_pp_sft_train_step(tcfg, tx, M, S, mesh=mesh, remat=t.remat,
                                          schedule=t.pipeline_schedule))
        trainer = _PipeTrainer(step_fn, params, opt_state, t.output_dir, t.logging_steps,
                               t.save_steps, report_to=t.report_to, mesh=mesh)
        _maybe_resume(trainer, args)
        final = trainer.train(_batches(args, data, cfg, False, mesh), max_steps=steps)
        merged = gather_stages(final, mesh)
    if predict:
        predict_and_score(merged, cfg, data, tokenizer, args, device)
    return merged


def run_dt(args: AllArgs, tokenizer=None, teacher_params=None, teacher_cfg=None,
           device: Optional[Device] = None):
    """Distillation stage 1 or 2 (`stage: dt`, `distill_stage`). The teacher
    is the dense full-attention model being converted: `teacher_params`, or
    the checkpoint at `teacher_model_path`, or (neither) an
    all-full_attention twin of the config from the seed. On multimodal data
    the teacher's ViT is shared and frozen. `checkpoint_path` hands over a
    previous stage's train state (its preserved softmax layers' attention
    left out). Stage 1 trains the converted layers' mixers; stage 2 every
    leaf of the student's text tree but rope's inv_freq. The teacher stays
    bit-unchanged: the student's leaves that train are its own
    (train/distill.py). With data_parallel > 1 each rank trains its rows
    of the global batch; under fsdp a leaf the student shares with the
    teacher is sharded once. Runs on the CUDA card unless `device="cpu"`.
    Returns the student's text params, whole on every rank."""
    mesh = _maybe_mesh(args)
    # the teacher passes on in a holder: no frame but _run_dt's keeps the whole
    # tree alive once it is sharded
    holder = [teacher_params]
    del teacher_params
    with use_mesh(mesh):
        return _run_dt(args, tokenizer, holder, teacher_cfg, resolve_device(device), mesh)


def _run_dt(args: AllArgs, tokenizer, holder: list, teacher_cfg, device: torch.device,
            mesh: Optional[Mesh]):
    teacher_params = holder.pop()
    cfg = build_config(args)
    dtype = torch.bfloat16 if args.train.bf16 else torch.float32
    # the tokenizer as given: build_dataset picks the text or the multimodal
    # one, as JAX's run_dt does (a text row encodes without the config)
    data = build_dataset(args, tokenizer, cfg=cfg)
    mm = is_multimodal(data)
    if teacher_params is None:
        teacher_cfg = dataclasses.replace(
            cfg.text, layer_types=("full_attention",) * cfg.text.num_hidden_layers)
        full_cfg = dataclasses.replace(cfg, text=teacher_cfg)
        if args.finetune.teacher_model_path:
            full = load_hf_checkpoint(args.finetune.teacher_model_path, full_cfg, dtype,
                                      device=device)
            teacher_params = full if mm else full["text"]
        else:
            gen = torch.Generator(device=device).manual_seed(args.train.seed)
            teacher_params = (init_params(full_cfg, gen, device, dtype) if mm
                              else init_text_params(teacher_cfg, gen, device, dtype))
    t_text = teacher_params["text"] if "text" in teacher_params else teacher_params
    if mm and "visual" not in teacher_params:
        raise ValueError("multimodal distillation needs a teacher with a visual tree; "
                         "pass a full checkpoint via teacher_model_path")
    set_trainable(teacher_params, lambda path, leaf: False)
    student, student_cfg = convert_attention(
        t_text, teacher_cfg,
        torch.Generator(device=device).manual_seed(args.train.seed + 1),
        softmax_attention=args.finetune.softmax_attention, mixer=args.finetune.mixer)
    del t_text
    if args.finetune.checkpoint_path:
        # stage handoff: the previous stage's weights, the preserved softmax
        # layers' attention left as the teacher has it
        _, prev = restore_train_state(args.finetune.checkpoint_path,
                                      template={"params": student})
        if prev is not None:
            student = merge_params(
                student, filter_softmax_layers(prev["params"], args.finetune.softmax_attention))
    steps = _total_steps(args, data)
    tx = _make_tx(args, steps)
    full_cfg = cfg if mm else None
    if args.finetune.distill_stage == 1:
        mask = trainable_mask(student, student_cfg, args.finetune.distill_weights,
                              args.finetune.softmax_attention)
        step_fn = make_stage1_step(student_cfg, teacher_cfg, tx, args.finetune.mse_factor,
                                   full_cfg=full_cfg)
    else:
        mask = stage2_mask(student)
        step_fn = make_stage2_step(student_cfg, teacher_cfg, tx,
                                   args.finetune.distill_temperature, full_cfg=full_cfg,
                                   remat=args.train.remat, remat_group=args.train.remat_group)
    # one memo: a tensor the student shares with the teacher becomes one
    # shard; a text tree is sharded under the paths the rules name
    # (`text/layers/...`), so a converted layer's leaves are all sliced or
    # all whole, its shared q / o_proj (Mamba2's) with them
    memo: Dict[int, Any] = {}
    teacher_params = shard_params(teacher_params, mesh, args.train.param_mode, memo,
                                  "" if "text" in teacher_params else "text")
    student = shard_params(student, mesh, args.train.param_mode, memo, "text")
    del memo
    apply_trainable_mask(student, mask, teacher_params)
    trainer = Trainer(
        step_fn, student, tx.init(student), args.train.output_dir,
        args.train.logging_steps, args.train.save_steps, extra_step_args=(teacher_params,),
        report_to=args.train.report_to, mesh=mesh,
    )
    return gather_full(trainer.train(_batches(args, data, cfg, mm, mesh), max_steps=steps))


def _policy_params(args: AllArgs, cfg, dtype, device) -> Dict[str, Any]:
    """The text tree the preference stages train: the HF checkpoint at
    `model_name_or_path`, or random weights from the seed. Every leaf
    trains but rope's inv_freq (train/step.full_finetune_leaf), whatever
    finetuning_type (and use_dora) say: the JAX package trains the whole
    tree here too."""
    if args.model.model_name_or_path:
        text = load_hf_checkpoint(args.model.model_name_or_path, cfg, dtype,
                                  device=device)["text"]
    else:
        gen = torch.Generator(device=device).manual_seed(args.train.seed)
        text = init_text_params(cfg.text, gen, device, dtype)
    set_trainable(text, full_finetune_leaf)
    return text


def frozen_copy(tree):
    """A frozen reference: the same numbers in tensors of its own. JAX
    passes the initial policy itself (its arrays never change); here the
    optimizer updates the policy's leaves in place, so a shared reference
    would move with it."""
    return tree_map(lambda t: t.detach().clone(), tree)


def _pref_trainer(args: AllArgs, step_fn, params, tx, extra: tuple = ()) -> Trainer:
    trainer = Trainer(
        step_fn, params, tx.init(params), args.train.output_dir,
        args.train.logging_steps, args.train.save_steps, extra_step_args=extra,
        report_to=args.train.report_to,
    )
    _maybe_resume(trainer, args)
    return trainer


def run_rm(args: AllArgs, tokenizer=None, device: Optional[Device] = None):
    """Reward-model training: decoder + scalar value head over pairwise data
    (reference train/rm/workflow.py). Runs on the CUDA card unless
    `device="cpu"`. Returns the text tree with its `value_head`."""
    from .dpo import make_rm_step

    _refuse_multi_rank('rm')
    device = resolve_device(device)
    cfg = build_config(args)
    dtype = torch.bfloat16 if args.train.bf16 else torch.float32
    data = build_preference_dataset(args, tokenizer, kind="pairwise")
    params = _policy_params(args, cfg, dtype, device)
    gen = torch.Generator(device=device).manual_seed(args.train.seed + 2)
    head = torch.randn((cfg.text.hidden_size, 1), generator=gen, device=device) * 0.02
    params["value_head"] = {"kernel": head.to(dtype).requires_grad_(True)}
    steps = _total_steps(args, data)
    tx = _make_tx(args, steps)
    step_fn = make_rm_step(cfg.text, tx, remat=args.train.remat,
                           remat_group=args.train.remat_group)
    trainer = _pref_trainer(args, step_fn, params, tx)
    batches = collate_pairwise(data, args.train.per_device_train_batch_size,
                               args.data.cutoff_len, seed=args.train.seed,
                               epochs=args.train.num_train_epochs)
    return trainer.train(batches, max_steps=steps)


def run_dpo(args: AllArgs, tokenizer=None, device: Optional[Device] = None):
    """DPO-family preference optimization (reference train/dpo/workflow.py).
    The frozen reference is a copy of the initial policy (`frozen_copy`);
    the reference-free losses (simpo, orpo) build none. Runs on the CUDA
    card unless `device="cpu"`. Returns the policy's text tree."""
    from .dpo import make_dpo_step, needs_reference

    _refuse_multi_rank('dpo')
    device = resolve_device(device)
    cfg = build_config(args)
    dtype = torch.bfloat16 if args.train.bf16 else torch.float32
    data = build_preference_dataset(args, tokenizer, kind="pairwise")
    policy = _policy_params(args, cfg, dtype, device)
    ref = frozen_copy(policy) if needs_reference(args.finetune.pref_loss) else None
    steps = _total_steps(args, data)
    tx = _make_tx(args, steps)
    step_fn = make_dpo_step(cfg.text, tx, beta=args.finetune.pref_beta,
                            loss_type=args.finetune.pref_loss, remat=args.train.remat,
                            remat_group=args.train.remat_group)
    trainer = _pref_trainer(args, step_fn, policy, tx, (ref,))
    batches = collate_pairwise(data, args.train.per_device_train_batch_size,
                               args.data.cutoff_len, seed=args.train.seed,
                               epochs=args.train.num_train_epochs)
    return trainer.train(batches, max_steps=steps)


def run_kto(args: AllArgs, tokenizer=None, device: Optional[Device] = None):
    """KTO unpaired-feedback stage (reference train/kto/workflow.py), with
    a frozen copy of the initial policy as the reference. Runs on the CUDA
    card unless `device="cpu"`. Returns the policy's text tree."""
    from .dpo import make_kto_step

    _refuse_multi_rank('kto')
    device = resolve_device(device)
    cfg = build_config(args)
    dtype = torch.bfloat16 if args.train.bf16 else torch.float32
    data = build_preference_dataset(args, tokenizer, kind="kto")
    policy = _policy_params(args, cfg, dtype, device)
    ref = frozen_copy(policy)
    steps = _total_steps(args, data)
    tx = _make_tx(args, steps)
    step_fn = make_kto_step(cfg.text, tx, beta=args.finetune.pref_beta, remat=args.train.remat,
                            remat_group=args.train.remat_group)
    trainer = _pref_trainer(args, step_fn, policy, tx, (ref,))
    batches = collate_kto(data, args.train.per_device_train_batch_size, args.data.cutoff_len,
                          seed=args.train.seed, epochs=args.train.num_train_epochs)
    return trainer.train(batches, max_steps=steps)


def run_ppo(args: AllArgs, tokenizer=None, reward_fn=None, device: Optional[Device] = None):
    from .ppo import run_ppo as _run

    return _run(args, tokenizer, reward_fn, device=device)


def run_exp(args: AllArgs, tokenizer=None, device: Optional[Device] = None):
    """Stage dispatch (tuner.py:53-110). sft / pt / dt train across the
    process group's ranks, whose number must be data_parallel x
    model_parallel (ValueError otherwise); the preference stages train in
    one process."""
    stage = args.finetune.stage
    if stage in ("sft", "pt"):
        return run_sft(args, tokenizer, device)
    if stage == "dt":
        return run_dt(args, tokenizer, device=device)
    if stage == "rm":
        return run_rm(args, tokenizer, device)
    if stage == "dpo":
        return run_dpo(args, tokenizer, device)
    if stage == "kto":
        return run_kto(args, tokenizer, device)
    if stage == "ppo":
        return run_ppo(args, tokenizer, device=device)
    raise NotImplementedError(
        f"unknown stage {stage!r} (pt | sft | dt | rm | dpo | kto | ppo)"
    )
