"""Distillation training ("dt") stages (torch port of
infinitevl_tpu/train/distill.py).

- Stage 1: each student layer is fed the TEACHER's input to that layer and
  regressed (MSE x mse_factor) onto the teacher layer's output; the step
  runs the teacher's layer i and the student's term i together, layer by
  layer (`teacher_layer_io` gives the teacher's hidden states at once).
- Stage 2: KL between the student's and the teacher's logits with
  temperature^2 scaling (plus CE where the batch has labels).

Both share the embeddings and rope. The teacher runs under no_grad and
never trains. Stage 1's loss is the mean of per-layer terms and each
trainable leaf belongs to exactly one layer, so the step differentiates
each layer's term on its own and frees that layer's graph before the next
(JAX takes one value_and_grad over the sum: the same gradients). A step
updates the student and the optimizer state IN PLACE, like every step of
the port (train/step.py). Gradients are clipped by the global norm of the
TRAINABLE leaves: the JAX package also counts the zero-masked gradients
of the frozen leaves (a deliberate departure, as for `freeze`); and stage
2 leaves rope's `inv_freq` frozen (see stage2_mask).

Under FSDP (parallel/sharding.py) stage 1 gathers the teacher's layer (in
its forward) and the student's layer (in its term) where each runs; a leaf
the student shares with the teacher is one shard, which a trainable
student leaf clones (apply_trainable_mask) with its layout."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from ..config import TextConfig
from ..models.text import decoder_layer_forward, embed_tokens, lm_head, text_forward
from ..ops.rope import mrope_cos_sin
from ..parallel.sharding import copy_shard_info, gather_top, gather_tree, global_mean
from .step import (
    IGNORE_INDEX,
    AdamW,
    _layer_segments,
    apply_gradients,
    batch_to_device,
    cross_entropy_loss,
    full_finetune_leaf,
    kl_distill_loss,
    trainable_leaves,
    tree_device,
    tree_leaves_with_path,
)

Params = Dict[str, Any]


def _text(tree: Params) -> Params:
    return tree["text"] if "text" in tree else tree


@torch.no_grad()
def teacher_layer_io(
    teacher_params: Params,
    teacher_cfg: TextConfig,
    inputs_embeds: torch.Tensor,
    position_ids: torch.Tensor,
    segment_ids: Optional[torch.Tensor] = None,
) -> List[torch.Tensor]:
    """The teacher's hidden states: [i] is layer i's input, [i + 1] its
    output; the last entry is the normed final hidden (text_forward's
    output_hidden_states convention)."""
    _, _, hidden = text_forward(teacher_params, teacher_cfg, inputs_embeds, position_ids,
                                state=None, segment_ids=segment_ids,
                                output_hidden_states=True)
    return hidden


def _stage1_term(lp, cfg, role, x_in, x_out, cos, sin, segment_ids, scale) -> torch.Tensor:
    # FSDP: the student's layer is gathered here, in the unit that runs it
    out = decoder_layer_forward(gather_tree(lp), cfg, role, x_in, cos, sin, None, 0, segment_ids)
    return global_mean((out.float() - x_out.float()) ** 2) * scale


def _cos_sin(student_params, cfg, position_ids, dtype):
    return mrope_cos_sin(position_ids, student_params["inv_freq"], cfg.mrope_section,
                         cfg.attention_scaling, dtype=dtype)


def stage1_loss(
    student_params: Params,
    student_cfg: TextConfig,
    teacher_hidden: Sequence[torch.Tensor],
    position_ids: torch.Tensor,
    mse_factor: float = 1000.0,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean over the layers of the MSE of student layer i (fed the
    teacher's input i) against the teacher's output i, times mse_factor."""
    cos, sin = _cos_sin(student_params, student_cfg, position_ids, teacher_hidden[0].dtype)
    layers = student_params["layers"]
    scale = mse_factor / len(layers)
    return sum(_stage1_term(lp, student_cfg, student_cfg.layer_role(i), teacher_hidden[i],
                            teacher_hidden[i + 1], cos, sin, segment_ids, scale)
               for i, lp in enumerate(layers))


@torch.no_grad()
def vision_features(full_params: Params, full_cfg, batch: Dict[str, Any], grid_thw,
                    video_grid_thw) -> Dict[str, torch.Tensor]:
    """The frozen, shared ViT's features of a batch's images and videos,
    computed once for the teacher and the student (under data parallelism
    on the global batch's pixels, this rank's rows sliced out: see
    train/step.mm_sft_loss_fn)."""
    from ..models.infinitevl import encode_vision

    feats = {}
    for name, key, grids in (("image", "pixel_values", grid_thw),
                             ("video", "pixel_values_videos", video_grid_thw)):
        if batch.get(key) is not None:
            vis = encode_vision(full_params, full_cfg, batch[key], grids)
            rows = batch.get(f"{name}_rows")
            feats[name] = vis if rows is None else vis[rows[0] : rows[1]]
    return feats


def _mm_embeds(text_params: Params, full_cfg, input_ids: torch.Tensor,
               feats: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Token embeds with the vision features scattered in."""
    from ..models.infinitevl import scatter_vision_embeds

    embeds = embed_tokens(text_params, input_ids)
    if "image" in feats:
        embeds = scatter_vision_embeds(embeds, feats["image"],
                                       input_ids == full_cfg.image_token_id)
    if "video" in feats:
        embeds = scatter_vision_embeds(embeds, feats["video"],
                                       input_ids == full_cfg.video_token_id)
    return embeds


def _teacher_embeds(teacher_params, full_cfg, batch, grid_thw, video_grid_thw):
    """(teacher embeds, vision features) of a device batch."""
    t_text = gather_top(_text(teacher_params))
    if batch.get("inputs_embeds") is not None:
        return batch["inputs_embeds"], {}
    if full_cfg is None:
        return embed_tokens(t_text, batch["input_ids"]), {}
    feats = vision_features(teacher_params, full_cfg, batch, grid_thw, video_grid_thw)
    return _mm_embeds(t_text, full_cfg, batch["input_ids"], feats), feats


def make_stage1_step(student_cfg: TextConfig, teacher_cfg: TextConfig, tx: AdamW,
                     mse_factor: float = 1000.0, full_cfg=None):
    """(student, opt_state, teacher, batch[, grid_thw, video_grid_thw]) ->
    (student, opt_state, loss). batch: input_ids [B, T], position_ids
    [3, B, T][, segment_ids, pixel_values, pixel_values_videos]. With
    `full_cfg` the teacher is a full {"text", "visual"} tree and vision
    features go into the embeds. The student (text tree) and the optimizer
    state are updated in place."""

    def step(student, opt_state, teacher, batch, grid_thw=None, video_grid_thw=None):
        batch = batch_to_device(batch, tree_device(student))
        seg = batch.get("segment_ids")
        # stage 1 regresses every position, pads included: the ids stay exact
        # unless one sequence fills every row
        if seg is not None and batch.get("segment_layout") == "single":
            seg = None
        with torch.no_grad():
            x, _ = _teacher_embeds(teacher, full_cfg, batch, grid_thw, video_grid_thw)
        t_text, pos = _text(teacher), batch["position_ids"]
        t_cos, t_sin = _cos_sin(t_text, teacher_cfg, pos, x.dtype)
        cos, sin = _cos_sin(student, student_cfg, pos, x.dtype)
        layers = student["layers"]
        scale = mse_factor / len(layers)
        grads: Dict[int, torch.Tensor] = {}
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, lp in enumerate(layers):
            # the teacher's layer i and the student's in one unit (under FSDP
            # both gathered here, a leaf they share once): the teacher's
            # output, then the student's term on the same input
            tp, lp = gather_tree((t_text["layers"][i], lp))
            with torch.no_grad():
                x_out = decoder_layer_forward(tp, teacher_cfg, teacher_cfg.layer_role(i), x,
                                              t_cos, t_sin, None, 0, seg)
            leaves = [t for _, t in trainable_leaves(student["layers"][i])]
            with torch.set_grad_enabled(bool(leaves)):
                term = _stage1_term(lp, student_cfg, student_cfg.layer_role(i), x, x_out, cos,
                                    sin, seg, scale)
            if leaves:  # this layer's graph is freed before the next is built
                for t, g in zip(leaves, torch.autograd.grad(term, leaves, allow_unused=True)):
                    grads[id(t)] = torch.zeros_like(t) if g is None else g
            total = total + term.detach()
            x = x_out
            del tp, lp
        ordered = [grads[id(t)] if id(t) in grads else torch.zeros_like(t)
                   for _, t in trainable_leaves(student)]
        tx.update(ordered, opt_state, student)
        return student, opt_state, total

    return step


def stage2_loss(
    student_params: Params,
    student_cfg: TextConfig,
    inputs_embeds: torch.Tensor,
    position_ids: torch.Tensor,
    teacher_logits: torch.Tensor,
    labels: Optional[torch.Tensor] = None,
    temperature: float = 2.0,
    segment_ids: Optional[torch.Tensor] = None,
    tail_pads_only: bool = False,
    remat: bool = False,
    remat_group: int = 1,
) -> torch.Tensor:
    """KL(teacher || student) of the logits at temperature T, times T^2,
    over the positions `labels` supervise (all without labels), plus the
    CE on the labels where there are any."""
    student_params = gather_top(student_params)
    hidden, _ = text_forward(student_params, student_cfg, inputs_embeds, position_ids, None,
                             segment_ids, remat=remat, remat_group=remat_group,
                             tail_pads_only=tail_pads_only)
    logits = lm_head(student_params, student_cfg, hidden)
    mask = None if labels is None else (labels != IGNORE_INDEX).float()
    loss = kl_distill_loss(logits, teacher_logits, temperature, mask)
    if labels is not None:
        loss = loss + cross_entropy_loss(logits, labels)
    return loss


def make_stage2_step(student_cfg: TextConfig, teacher_cfg: TextConfig, tx: AdamW,
                     temperature: float = 2.0, full_cfg=None, remat: bool = False,
                     remat_group: int = 1):
    """End-to-end logit KL distillation step, (student, opt_state, teacher,
    batch[, grid_thw, video_grid_thw]) -> (student, opt_state, loss). With
    `full_cfg`, the features of the shared, frozen ViT go into the
    teacher's and the student's embeds (computed once; JAX computes them
    twice, with the same numbers). The student's embedding table trains."""

    def step(student, opt_state, teacher, batch, grid_thw=None, video_grid_thw=None):
        batch = batch_to_device(batch, tree_device(student))
        pos, labels = batch["position_ids"], batch.get("labels")
        seg, tail_pads_only, masked = _layer_segments(
            batch.get("segment_ids"), batch.get("segment_layout"),
            labels if labels is not None else torch.zeros_like(batch["input_ids"]))
        labels = None if labels is None else masked
        t_text = gather_top(_text(teacher))
        with torch.no_grad():
            t_embeds, feats = _teacher_embeds(teacher, full_cfg, batch, grid_thw,
                                              video_grid_thw)
            t_hidden, _ = text_forward(t_text, teacher_cfg, t_embeds, pos, None, seg,
                                       tail_pads_only=tail_pads_only)
            t_logits = lm_head(t_text, teacher_cfg, t_hidden)
        s_top = gather_top(student)  # FSDP: the embedding and head once a step
        s_embeds = (_mm_embeds(s_top, full_cfg, batch["input_ids"], feats)
                    if full_cfg is not None else embed_tokens(s_top, batch["input_ids"]))
        loss = stage2_loss(s_top, student_cfg, s_embeds, pos, t_logits, labels, temperature,
                           seg, tail_pads_only, remat, remat_group)
        apply_gradients(loss, student, tx, opt_state)
        return student, opt_state, loss.detach()

    return step


def stage2_mask(student_params: Params):
    """Stage 2 trains every leaf of the student's text tree but `inv_freq`,
    as full finetuning does (train/step.full_finetune_leaf)."""
    def mask(tree, key=""):
        if isinstance(tree, dict):
            return {k: mask(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [mask(v) for v in tree]
        return full_finetune_leaf(key)

    return mask(student_params)


def _mask_leaves(mask, prefix: str = ""):
    if isinstance(mask, dict):
        for k, v in mask.items():
            yield from _mask_leaves(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(mask, (list, tuple)):
        for i, v in enumerate(mask):
            yield from _mask_leaves(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, bool(mask)


def _replace_leaf(tree, path: str, value) -> None:
    *parents, last = path.split("/")
    for key in parents:
        tree = tree[int(key)] if isinstance(tree, list) else tree[key]
    if isinstance(tree, list):
        tree[int(last)] = value
    else:
        tree[last] = value


def apply_trainable_mask(params: Params, mask, teacher: Optional[Params] = None) -> int:
    """Freeze the leaves where `mask` (a bool tree shaped like `params`, as
    models/convert.trainable_mask makes it) is False and mark the others
    trainable. A trainable leaf that shares its storage with a tensor of
    `teacher` is first replaced, in `params`' own containers, by a clone,
    so the optimizer's in-place updates never reach the teacher. Returns
    the number of trainable leaves."""
    flags = dict(_mask_leaves(mask))
    shared = set()
    if teacher is not None:
        shared = {t.untyped_storage().data_ptr() for _, t in tree_leaves_with_path(teacher)}
    n = 0
    for path, leaf in list(tree_leaves_with_path(params)):
        on = flags[path] and leaf.is_floating_point()
        if on and leaf.untyped_storage().data_ptr() in shared:
            leaf = copy_shard_info(leaf.detach().clone(), leaf)
            _replace_leaf(params, path, leaf)
        leaf.requires_grad_(on)
        n += on
    return n
