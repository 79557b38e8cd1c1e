"""Training step: losses, the optimizer and the SFT step factories (torch
port of infinitevl_tpu/train/step.py).

Parameters stay the nested dicts of tensors the rest of the port uses.
Trainable leaves are the tensors with `requires_grad`; a step function is a
plain function `(params, opt_state, batch) -> (params, opt_state, loss)`
that differentiates the loss with respect to those leaves and UPDATES them
and the optimizer state IN PLACE (the returned objects are the ones passed
in). The training forward itself is stateless and updates nothing.

`make_optimizer` reproduces the JAX package's optax chain number for
number: global-norm clip, then Adam moments with bias correction and
`mu_hat / (sqrt(nu_hat) + eps)`, then decoupled weight decay added to the
update (skipped for 1-D leaves, norms, A_log and dt_bias), then the
schedule's learning rate read at the count before the step. Gradient
accumulation keeps the running mean of k micro-batch gradients and takes
one optimizer step on the k-th, as `optax.MultiSteps` does.

Under data parallelism (parallel/sharding.py) every loss divides by the
global batch's count, the optimizer sums the replicated leaves' gradients
over the data ranks and clips by the global norm (a model-axis slice's
squares summed over the model group, a replicated leaf counted once); with
one process both are the one-process numbers. Under tensor parallelism the
losses run on the logits that every rank of a model group holds whole."""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import InfiniteVLConfig, TextConfig
from ..models.text import embed_tokens, head_logits, lm_head, text_forward
from ..parallel.sharding import (
    gather_top,
    global_mean,
    global_sum,
    grad_sq_norm,
    sync_gradients,
)

IGNORE_INDEX = -100

Params = Dict[str, Any]


# ---------------------------------------------------------------- losses


def cross_entropy_loss(
    logits: torch.Tensor,  # [B, T, V] fp32
    labels: torch.Tensor,  # [B, T] with IGNORE_INDEX masking
) -> torch.Tensor:
    """Next-token CE over the supervised positions (labels already shifted
    by the collator), mean over them (over the global batch's, under data
    parallelism: parallel/sharding.global_sum)."""
    mask = labels != IGNORE_INDEX
    safe = torch.where(mask, labels, 0)
    logp = F.log_softmax(logits.float(), dim=-1)
    tok = torch.gather(logp, -1, safe[..., None])[..., 0]
    return -(tok * mask).sum() / global_sum(mask.sum()).clamp(min=1)


def _chunk_logprobs(h_c, lm_w, lb_c, w_is_vd):
    logits = head_logits(h_c, lm_w, w_is_vd).float()
    mask = lb_c != IGNORE_INDEX
    safe = torch.where(mask, lb_c, 0)
    tok = torch.gather(F.log_softmax(logits, dim=-1), -1, safe[..., None])[..., 0]
    return (tok * mask).sum(dim=-1)


def chunked_logprobs(
    hidden: torch.Tensor,  # [B, T, D]
    lm_w: torch.Tensor,  # [D, V], or [V, D] with w_is_vd (the tied table's layout)
    labels: torch.Tensor,  # [B, T]
    chunk: int = 1024,
    w_is_vd: bool = False,
) -> torch.Tensor:
    """Per row, the sum of the supervised positions' log-probs [B] fp32,
    without ever holding the [T, V] logits: the sequence goes through the
    head in chunks of `chunk` positions, each checkpointed when it is
    differentiated so that its logits are recomputed in the backward. Each
    chunk is made contiguous: torch.matmul runs [B, t, D] @ [D, V] as one
    GEMM or as a batched one depending on the operand's layout and on
    whether the weight requires grad, and the two round differently (a
    trainable policy and its frozen copy must give bit-equal log-probs).
    Under tensor parallelism each chunk's logits are the model group's
    partial logits summed (models/text.head_logits): one all_reduce of
    [B, chunk, V] a chunk, again in the chunk's recompute."""
    T = hidden.shape[1]
    track = torch.is_grad_enabled() and (hidden.requires_grad or lm_w.requires_grad)
    total = hidden.new_zeros(hidden.shape[0], dtype=torch.float32)
    for t0 in range(0, T, chunk):
        args = (hidden[:, t0 : t0 + chunk].contiguous(), lm_w, labels[:, t0 : t0 + chunk],
                w_is_vd)
        total = total + (checkpoint(_chunk_logprobs, *args, use_reentrant=False) if track
                         else _chunk_logprobs(*args))
    return total


def fused_linear_cross_entropy(
    hidden: torch.Tensor,  # [B, T, D]
    lm_w: torch.Tensor,  # [D, V], or [V, D] with w_is_vd (the tied table's layout)
    labels: torch.Tensor,  # [B, T]
    chunk: int = 1024,
    w_is_vd: bool = False,
) -> torch.Tensor:
    """CE without ever holding the [T, V] logits (chunked_logprobs), mean
    over the supervised positions. T needs no multiple of the chunk."""
    nll = -chunked_logprobs(hidden, lm_w, labels, chunk, w_is_vd).sum()
    return nll / global_sum((labels != IGNORE_INDEX).sum()).clamp(min=1)


def kl_distill_loss(
    student_logits: torch.Tensor,
    teacher_logits: torch.Tensor,
    temperature: float = 2.0,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """KL(teacher || student) with T^2 scaling."""
    t = temperature
    s = F.log_softmax(student_logits / t, dim=-1)
    p = F.softmax(teacher_logits / t, dim=-1)
    kl = (p * (torch.log(p.clamp(min=1e-9)) - s)).sum(-1)
    kl = ((kl * mask).sum() / global_sum(mask.sum()).clamp(min=1) if mask is not None
          else global_mean(kl))
    return kl * (t * t)


def layerwise_mse_loss(diffs) -> torch.Tensor:
    """Average per-layer MSE over (student, teacher) pairs."""
    losses = [global_mean((a.float() - b.float()) ** 2) for a, b in diffs]
    return sum(losses) / len(losses)


# ---------------------------------------------------------------- trees


def tree_leaves_with_path(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every tensor leaf, paths like `text/layers/0/mlp/up/kernel`."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves_with_path(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, f"{prefix}/{i}" if prefix else str(i))
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree


def trainable_leaves(tree) -> List[Tuple[str, torch.Tensor]]:
    return [(p, t) for p, t in tree_leaves_with_path(tree) if t.requires_grad]


def set_trainable(tree, predicate: Callable[[str, torch.Tensor], bool]) -> int:
    """Mark the floating-point leaves for which `predicate(path, leaf)` holds
    as trainable and every other leaf as frozen. Returns the number of
    trainable leaves."""
    n = 0
    for path, leaf in tree_leaves_with_path(tree):
        on = leaf.is_floating_point() and bool(predicate(path, leaf))
        leaf.requires_grad_(on)
        n += on
    return n


def full_finetune_leaf(path: str, leaf: Optional[torch.Tensor] = None) -> bool:
    """The predicate of full finetuning: every leaf trains but rope's
    `inv_freq`, a constant derived from the config. The reference keeps it
    as a buffer and the HF format does not store it (the loader rebuilds
    it), so a trained one would not survive the export. (The JAX package
    moves it with the rest: a deliberate departure.)"""
    return path.rsplit("/", 1)[-1] != "inv_freq"


def _no_decay(path: str, x: torch.Tensor) -> bool:
    return (
        x.ndim <= 1
        or path.endswith("A_log")
        or path.endswith("dt_bias")
        or "norm" in path.lower()
    )


# ---------------------------------------------------------------- optimizer


def make_schedule(
    learning_rate: Union[float, Callable[[int], float]],
    warmup_steps: int = 0,
    total_steps: Optional[int] = None,
    schedule: str = "cosine",
) -> Callable[[int], float]:
    """step count -> learning rate, as the JAX package builds it from optax:
    `cosine` is a linear warm-up from 0 joined to a cosine decay to 0 that
    ends at `total_steps`; `linear` a warm-up joined to a linear decay;
    anything else, or no `total_steps`, the constant rate."""
    if callable(learning_rate):
        return learning_rate
    peak = float(learning_rate)
    if not total_steps or schedule not in ("cosine", "linear"):
        return lambda count: peak

    def linear(init, end, steps, count):
        if steps <= 0:
            return init
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    if schedule == "cosine":
        decay_steps = total_steps - warmup_steps

        def lr(count):
            if count < warmup_steps:
                return linear(0.0, peak, warmup_steps, count)
            c = min(count - warmup_steps, decay_steps)
            return peak * 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))

        return lr

    def lr(count):
        if count < warmup_steps:
            return linear(0.0, peak, max(warmup_steps, 1), count)
        return linear(peak, 0.0, max(total_steps - warmup_steps, 1), count - warmup_steps)

    return lr


class Optimizer:
    """Clip by global norm, then the subclass's update, with optional
    gradient accumulation: the wrapper the JAX package builds from
    `optax.chain(clip_by_global_norm, ...)` and `optax.MultiSteps`.

    The state is a plain dict (nested lists of tensors and ints, which the
    train-state checkpoint stores): `count` (optimizer steps taken), what
    `_init` adds and, with `accumulation_steps` > 1, `mini_step` and `acc`
    (the running mean of the micro-batch gradients). `update` changes the
    leaves and the state in place. Subclasses give `_init(named)` and
    `_apply(named, grads, state)` over the trainable leaves `named`
    ((path, tensor) in tree order); `grads` is an iterable to be walked
    once, in that order."""

    def __init__(self, grad_clip: Optional[float] = 1.0, accumulation_steps: int = 1):
        self.grad_clip = grad_clip
        self.accumulation_steps = max(int(accumulation_steps), 1)

    def init(self, params) -> Dict[str, Any]:
        named = trainable_leaves(params)
        state = {"count": 0, **self._init(named)}
        if self.accumulation_steps > 1:
            state["mini_step"] = 0
            state["acc"] = [torch.zeros_like(t) for _, t in named]
        return state

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: Dict[str, Any], params) -> None:
        named = trainable_leaves(params)
        if len(named) != len(grads):
            raise ValueError(f"{len(grads)} gradients for {len(named)} trainable leaves")
        # data parallelism: the global batch's gradients (replicated leaves
        # all-reduced; a shard's came summed from its gather's backward)
        leaves = [t for _, t in named]
        grads = sync_gradients(leaves, grads)
        if self.accumulation_steps > 1:
            # running mean over the k micro-batches; one step on the k-th
            m = state["mini_step"]
            for acc, g in zip(state["acc"], grads):
                acc.add_((g.to(acc.dtype) - acc) / (m + 1))
            state["mini_step"] = (m + 1) % self.accumulation_steps
            if state["mini_step"] != 0:
                return
            grads = [acc.clone() for acc in state["acc"]]
            for acc in state["acc"]:
                acc.zero_()
        if self.grad_clip is not None:
            g_norm = torch.sqrt(grad_sq_norm(leaves, grads))
            if bool(g_norm >= self.grad_clip):
                # clipped leaf by leaf as _apply reaches it: a clipped copy of
                # every gradient at once would hold the model's size again
                grads = (g / g_norm.to(g.dtype) * self.grad_clip for g in grads)
        self._apply(named, grads, state)
        state["count"] += 1

    def _init(self, named) -> Dict[str, Any]:
        raise NotImplementedError

    def _apply(self, named, grads, state) -> None:
        raise NotImplementedError


def bias_corrections(b1: float, b2: float, count: int) -> Tuple[float, float]:
    """1 - b1^count and 1 - b2^count in fp32, as optax computes them."""
    one = torch.ones((), dtype=torch.float32)
    return (float(one - torch.tensor(b1, dtype=torch.float32) ** count),
            float(one - torch.tensor(b2, dtype=torch.float32) ** count))


class AdamW(Optimizer):
    """Clip by global norm, then AdamW, with optional gradient accumulation.
    Beside `count` the state holds `mu` and `nu` (lists of moments, one per
    trainable leaf in tree order, in the leaf's dtype)."""

    def __init__(self, lr: Callable[[int], float], weight_decay: float = 0.01,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 grad_clip: float = 1.0, accumulation_steps: int = 1):
        super().__init__(grad_clip, accumulation_steps)
        self.lr, self.weight_decay = lr, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps

    def _init(self, named) -> Dict[str, Any]:
        return {"mu": [torch.zeros_like(t) for _, t in named],
                "nu": [torch.zeros_like(t) for _, t in named]}

    def _apply(self, named, grads, state) -> None:
        if len(named) != len(state["mu"]):
            raise ValueError(f"{len(state['mu'])} moments for {len(named)} trainable leaves")
        c1, c2 = bias_corrections(self.b1, self.b2, state["count"] + 1)
        lr = float(self.lr(state["count"]))
        for (path, p), g, mu, nu in zip(named, grads, state["mu"], state["nu"]):
            g = g.to(mu.dtype)
            mu.mul_(self.b1).add_(g * (1.0 - self.b1))
            nu.mul_(self.b2).add_(g * g * (1.0 - self.b2))
            upd = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if self.weight_decay and not _no_decay(path, p):
                upd = upd + self.weight_decay * p
            p.add_((upd * -lr).to(p.dtype))


def make_optimizer(
    learning_rate=1e-4,
    weight_decay: float = 0.01,
    b1: float = 0.9,
    b2: float = 0.999,
    grad_clip: float = 1.0,
    warmup_steps: int = 0,
    total_steps: Optional[int] = None,
    schedule: str = "cosine",
    accumulation_steps: int = 1,
) -> AdamW:
    return AdamW(make_schedule(learning_rate, warmup_steps, total_steps, schedule),
                 weight_decay, b1, b2, grad_clip=grad_clip,
                 accumulation_steps=accumulation_steps)


# ---------------------------------------------------------------- SFT losses


def read_segment_layout(segment_ids) -> str:
    """What a batch's segment ids [B, T] ask of the layers, read on the host
    from a numpy array or a CPU tensor:
    "single": every row holds one id, so nothing is masked;
    "tail_pad": every row is one sequence followed by id-0 pads (what the
    collators make of unpacked rows shorter than cutoff_len);
    "packed": anything else (several sequences in a row)."""
    seg = np.asarray(segment_ids)
    first = seg[:, :1]
    if (seg == first).all():
        return "single"
    pad = seg == 0
    if (pad | (seg == first)).all() and (pad[:, 1:] >= pad[:, :-1]).all():
        return "tail_pad"
    return "packed"


def _layer_segments(segment_ids, layout: Optional[str], labels):
    """(segment_ids, tail_pads_only, labels) for the decoder. `layout` is
    read_segment_layout's word (the steps read it from the collator's host
    batch); without one, ids on the CPU are read here and ids on a card
    count as packed, so nothing waits for the device. A single id per row
    drops the ids; tail padding keeps them for the SWA mask and the short
    conv and takes them from the DeltaNet rule, whose pads cannot reach the
    tokens before them; the pads carry no label."""
    if segment_ids is None:
        return None, False, labels
    if layout is None:
        on_host = segment_ids.device.type == "cpu"
        layout = read_segment_layout(segment_ids) if on_host else "packed"
    if layout == "single":
        return None, False, labels
    if layout == "tail_pad":
        return segment_ids, True, labels.masked_fill(segment_ids == 0, IGNORE_INDEX)
    if layout != "packed":
        raise ValueError(f"segment layout {layout!r} (single | tail_pad | packed)")
    return segment_ids, False, labels


def head_weight(tp: Params) -> Tuple[torch.Tensor, bool]:
    """The text tree's output head as (weight, w_is_vd): the tied embedding
    table [V, D], or lm_head [D, V]."""
    tied = "lm_head" not in tp
    return (tp["embed"] if tied else tp["lm_head"]), tied


def _head_loss(tp: Params, cfg: TextConfig, hidden, labels, remat: bool) -> torch.Tensor:
    if remat:
        # chunked CE avoids the [T, V] logits tensor (each fp32 chunk of
        # 1024 positions is chunk x V x 4 bytes)
        w, tied = head_weight(tp)
        ce_chunk = 512 if labels.shape[1] >= 16384 else 1024
        return fused_linear_cross_entropy(hidden, w, labels, chunk=ce_chunk, w_is_vd=tied)
    return cross_entropy_loss(lm_head(tp, cfg, hidden), labels)


def sft_loss_fn(
    params: Params,  # the text tree
    cfg: TextConfig,
    input_ids: torch.Tensor,  # [B, T]
    labels: torch.Tensor,  # [B, T]
    position_ids: torch.Tensor,  # [3, B, T]
    segment_ids: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    remat: bool = False,
    remat_group: int = 1,
    segment_layout: Optional[str] = None,  # see _layer_segments
) -> torch.Tensor:
    params = gather_top(params)  # FSDP: the embedding / tied head and the norm, once
    embeds = inputs_embeds if inputs_embeds is not None else embed_tokens(params, input_ids)
    segment_ids, tail_pads_only, labels = _layer_segments(segment_ids, segment_layout, labels)
    hidden, _ = text_forward(
        params, cfg, embeds, position_ids, state=None, segment_ids=segment_ids,
        remat=remat, remat_group=remat_group, tail_pads_only=tail_pads_only,
    )
    return _head_loss(params, cfg, hidden, labels, remat)


def mm_sft_loss_fn(
    params: Params,  # full tree: {"text": ..., "visual": ...}
    cfg: InfiniteVLConfig,
    input_ids: torch.Tensor,
    labels: torch.Tensor,
    position_ids: torch.Tensor,  # [3, B, T] vision-aware mrope indices
    pixel_values: Optional[torch.Tensor] = None,  # [n_patches, in_feat] packed
    grid_thw: Optional[tuple] = None,
    pixel_values_videos: Optional[torch.Tensor] = None,
    video_grid_thw: Optional[tuple] = None,
    segment_ids: Optional[torch.Tensor] = None,
    remat: bool = False,
    remat_group: int = 1,
    segment_layout: Optional[str] = None,  # see _layer_segments
    image_rows: Optional[Tuple[int, int]] = None,  # data parallelism: see below
    video_rows: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Multimodal SFT loss: ViT features scattered into the token embeds.
    Under data parallelism the ViT runs on the global batch's pixels on
    every rank and `image_rows` / `video_rows` slice out the features of
    this rank's rows (parallel/sharding.rank_rows_mm)."""
    from ..models.infinitevl import encode_vision, scatter_vision_embeds

    tp = gather_top(params["text"])
    embeds = embed_tokens(tp, input_ids)
    if pixel_values is not None:
        vis = encode_vision(params, cfg, pixel_values, grid_thw)
        vis = vis if image_rows is None else vis[image_rows[0] : image_rows[1]]
        embeds = scatter_vision_embeds(embeds, vis, input_ids == cfg.image_token_id)
    if pixel_values_videos is not None:
        vis = encode_vision(params, cfg, pixel_values_videos, video_grid_thw)
        vis = vis if video_rows is None else vis[video_rows[0] : video_rows[1]]
        embeds = scatter_vision_embeds(embeds, vis, input_ids == cfg.video_token_id)
    segment_ids, tail_pads_only, labels = _layer_segments(segment_ids, segment_layout, labels)
    hidden, _ = text_forward(
        tp, cfg.text, embeds, position_ids, state=None, segment_ids=segment_ids,
        remat=remat, remat_group=remat_group, tail_pads_only=tail_pads_only,
    )
    return _head_loss(tp, cfg.text, hidden, labels, remat)


# ---------------------------------------------------------------- steps


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """The collators' numpy batch as tensors on `device` (`_n_tokens` and
    other plain numbers pass through). Segment ids still on the host are
    read here, once, into `segment_layout`."""
    out = {}
    seg = batch.get("segment_ids")
    if "segment_layout" not in batch and seg is not None and (
            isinstance(seg, np.ndarray) or seg.device.type == "cpu"):
        out["segment_layout"] = read_segment_layout(seg)
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.ndim > 0:
            v = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = v.to(device) if isinstance(v, torch.Tensor) else v
    return out


def tree_device(tree) -> torch.device:
    return next(tree_leaves_with_path(tree))[1].device


def apply_gradients(loss: torch.Tensor, params, tx: AdamW, opt_state) -> None:
    leaves = [t for _, t in trainable_leaves(params)]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
    tx.update(grads, opt_state, params)


def make_mm_sft_train_step(cfg: InfiniteVLConfig, tx: AdamW, remat: bool = False,
                           remat_group: int = 1):
    """Multimodal train step: (params, opt_state, batch, grid_thw,
    video_grid_thw) -> (params, opt_state, loss). Params and optimizer
    state are updated in place."""

    def step(params, opt_state, batch, grid_thw=None, video_grid_thw=None):
        batch = batch_to_device(batch, tree_device(params))
        loss = mm_sft_loss_fn(
            params, cfg, batch["input_ids"], batch["labels"], batch["position_ids"],
            pixel_values=batch.get("pixel_values"), grid_thw=grid_thw,
            pixel_values_videos=batch.get("pixel_values_videos"),
            video_grid_thw=video_grid_thw, segment_ids=batch.get("segment_ids"),
            remat=remat, remat_group=remat_group,
            segment_layout=batch.get("segment_layout"),
            image_rows=batch.get("image_rows"), video_rows=batch.get("video_rows"),
        )
        apply_gradients(loss, params, tx, opt_state)
        return params, opt_state, loss.detach()

    return step


def make_sft_eval_fn(cfg: TextConfig):
    """Loss-only twin of make_sft_train_step: (params, batch) -> mean CE
    over the supervised tokens, without autograd."""

    @torch.no_grad()
    def eval_loss(params, batch):
        batch = batch_to_device(batch, tree_device(params))
        return sft_loss_fn(
            params["text"] if "text" in params else params, cfg,
            batch["input_ids"], batch["labels"], batch["position_ids"],
            batch.get("segment_ids"), segment_layout=batch.get("segment_layout"),
        )

    return eval_loss


def make_sft_train_step(cfg: TextConfig, tx: AdamW, remat: bool = False,
                        remat_group: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, loss). params: the
    full tree with a "text" subtree, or the text tree itself; batch:
    dict(input_ids, labels, position_ids[, segment_ids]). remat=True
    checkpoints each decoder layer. Params and optimizer state are updated
    in place."""

    def step(params, opt_state, batch):
        batch = batch_to_device(batch, tree_device(params))
        loss = sft_loss_fn(
            params["text"] if "text" in params else params, cfg,
            batch["input_ids"], batch["labels"], batch["position_ids"],
            batch.get("segment_ids"), remat=remat, remat_group=remat_group,
            segment_layout=batch.get("segment_layout"),
        )
        apply_gradients(loss, params, tx, opt_state)
        return params, opt_state, loss.detach()

    return step
