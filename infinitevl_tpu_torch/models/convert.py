"""Attention -> linear-attention conversion for distillation (torch port of
infinitevl_tpu/models/convert.py).

Given a dense softmax-attention teacher, every decoder layer NOT in
`softmax_attention` gets a freshly initialised Gated DeltaNet mixer
(mimic_init warm start), or with `mixer="mamba2"` a Mamba2 mixer whose
q / k / v / o are the teacher's attention projections (k and v
GQA-expanded), and keeps the teacher's MLP and norms; preserved layers keep
their attention weights and become the hybrid's sliding-attention layers.

Aliasing. As in JAX, the student SHARES the teacher's tensors wherever it
keeps them (preserved layers, MLPs, norms, embeddings), so a converted 3B
model costs only its new mixers. Unlike JAX arrays these tensors are
mutable: the port's optimizer updates leaves in place and `requires_grad_`
flips a leaf's flag in place. The student's dicts and lists are its own,
so a leaf can be replaced without touching the teacher's tree, and a
shared leaf that is to train must first be cloned
(`train/distill.apply_trainable_mask` does that). Frozen shared leaves
stay shared."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ..config import LINEAR, MAMBA2, SLIDING, TextConfig
from .params import init_delta_layer, init_mamba2_layer

Params = Dict[str, Any]

DEFAULT_SOFTMAX_LAYERS = tuple(range(0, 36, 4))  # examples/train_3b_stage1.yaml

_MIXER_ALIASES = {
    "gated_deltanet": "gated_deltanet",
    "gateddeltanet": "gated_deltanet",
    "mamba2": "mamba2",
    "mamba2_new": "mamba2",
}


def _map_tree(fn, tree):
    """fn of every leaf, in new dicts and lists."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


def _share(tree):
    """The same tensors in new dicts and lists."""
    return _map_tree(lambda t: t, tree)


def _gqa_expand(kernel: torch.Tensor, bias: Optional[torch.Tensor], num_kv_heads: int,
                head_dim: int, groups: int):
    """KV projection weights expanded to all query heads in repeat_interleave
    order ([kv0, kv0, ..., kv1, kv1, ...]): GQA maps query head i to kv head
    i // groups, so the teacher's per-head q.k geometry survives the warm
    start. (The reference's `.repeat(groups, 1, 1)` tiles whole blocks
    instead, [kv0, kv1, kv0, kv1], pairing most query heads with the wrong
    teacher KV head; the JAX package deviates from it on purpose, and so
    does the port.) For the mamba2 conversion, which copies the teacher's
    q/k/v/o into the SSD's projections."""
    D = kernel.shape[0]
    w = kernel.reshape(D, num_kv_heads, head_dim).repeat_interleave(groups, dim=1)
    w = w.reshape(D, num_kv_heads * groups * head_dim)
    b = None
    if bias is not None:
        b = bias.reshape(num_kv_heads, head_dim).repeat_interleave(groups, dim=0).reshape(-1)
    return w, b


def convert_attention(
    teacher_params: Params,  # the text tree
    teacher_cfg: TextConfig,
    generator: Optional[torch.Generator],
    softmax_attention: Sequence[int] = DEFAULT_SOFTMAX_LAYERS,
    mixer: str = "gated_deltanet",
    mimic_init: bool = True,
    dtype: Optional[torch.dtype] = None,
) -> Tuple[Params, TextConfig]:
    """(student text params, student config). Preserved layers become
    sliding_attention; the rest become mixers drawn from `generator` (on
    the teacher's device) with the teacher's MLP and norms:
    - "gated_deltanet": the shipped target, every mixer weight fresh
      (mimic_init);
    - "mamba2": q_proj and o_proj are the teacher's, k_proj and v_proj the
      teacher's expanded to every query head (`_gqa_expand`), the SSD side
      (dt, A, D, conv, gate) fresh (mimic_init).
    The student shares the teacher's tensors where it keeps them (see the
    module docstring); the expanded k / v are new tensors."""
    mixer_key = _MIXER_ALIASES.get(mixer.lower())
    if mixer_key is None:
        raise NotImplementedError(
            f"mixer {mixer!r}: available mixers are {sorted(set(_MIXER_ALIASES.values()))}")
    softmax = set(softmax_attention)
    n = teacher_cfg.num_hidden_layers
    converted = LINEAR if mixer_key == "gated_deltanet" else MAMBA2
    student_cfg = dataclasses.replace(
        teacher_cfg,
        layer_types=tuple(SLIDING if i in softmax else converted for i in range(n)),
        use_sliding_window=True,
        sliding_window=teacher_cfg.sliding_window or 8192,
    )
    device = teacher_params["embed"].device
    if dtype is None:
        dtype = teacher_params["embed"].dtype
    student = _share(teacher_params)
    for i, lp in enumerate(student["layers"]):
        if i in softmax:
            continue
        if converted == LINEAR:
            fresh = init_delta_layer(student_cfg, generator, device, dtype,
                                     mimic_init=mimic_init)
        else:
            fresh = init_mamba2_layer(student_cfg, generator, device, dtype,
                                      mimic_init=mimic_init)
            Hkv, Dh = teacher_cfg.num_key_value_heads, teacher_cfg.head_dim
            groups = teacher_cfg.num_attention_heads // Hkv
            fresh["q_proj"], fresh["o_proj"] = lp["q_proj"], lp["o_proj"]
            for name in ("k_proj", "v_proj"):
                w, b = _gqa_expand(lp[name]["kernel"], lp[name].get("bias"), Hkv, Dh, groups)
                fresh[name] = {"kernel": w, **({"bias": b} if b is not None else {})}
        # the teacher's MLP and norms stay (the reference swaps only self_attn)
        fresh["mlp"] = lp["mlp"]
        fresh["input_norm"] = lp["input_norm"]
        fresh["post_norm"] = lp["post_norm"]
        student["layers"][i] = fresh
    return student, student_cfg


def llama_pro_expand(params: Params, cfg: TextConfig, num_expand: int
                     ) -> Tuple[Params, TextConfig]:
    """LLaMA-Pro block expansion: split the stack into `num_expand` groups
    and append after each group an IDENTITY copy of its last layer (o_proj
    and mlp.down zeroed, so the new block is a no-op at init). The copies
    are new tensors; the original layers are shared with `params`."""
    n = cfg.num_hidden_layers
    if num_expand <= 0 or n % num_expand:
        raise ValueError(f"num_expand must divide num_hidden_layers ({n}), got {num_expand}")
    group = n // num_expand
    new_layers, new_types = [], []
    for g in range(num_expand):
        for i in range(g * group, (g + 1) * group):
            new_layers.append(_share(params["layers"][i]))
            new_types.append(cfg.layer_types[i])
        last = (g + 1) * group - 1
        copy = _map_tree(lambda t: t.detach().clone(), params["layers"][last])
        copy["o_proj"]["kernel"].zero_()
        copy["mlp"]["down"]["kernel"].zero_()
        new_layers.append(copy)
        new_types.append(cfg.layer_types[last])
    new_params = _share(params)
    new_params["layers"] = new_layers
    return new_params, dataclasses.replace(cfg, num_hidden_layers=n + num_expand,
                                           layer_types=tuple(new_types))


def expansion_trainable_mask(params: Params, cfg: TextConfig, num_expand: int) -> Params:
    """Train only the new blocks of llama_pro_expand: they sit at positions
    (g + 1) * group + g for each group g."""
    n = cfg.num_hidden_layers  # after the expansion
    group = (n - num_expand) // num_expand
    new_idx = {(g + 1) * group + g for g in range(num_expand)}
    out = {k: _map_tree(lambda _: False, v) for k, v in params.items() if k != "layers"}
    out["layers"] = [_map_tree(lambda _, on=i in new_idx: on, lp)
                     for i, lp in enumerate(params["layers"])]
    return out


def trainable_mask(
    params: Params,
    cfg: TextConfig,
    distill_weights: Sequence[str] = ("self_attn",),
    softmax_attention: Sequence[int] = DEFAULT_SOFTMAX_LAYERS,
) -> Params:
    """Bool tree, True = trainable: a leaf trains iff its name matches one
    of `distill_weights` and its layer is not preserved. "self_attn"
    matches a converted layer's mixer (everything but the MLP and norms)."""
    softmax = set(softmax_attention)
    mixer_keys = {
        "q_proj", "k_proj", "v_proj", "a_proj", "b_proj", "g_proj",
        "o_proj", "A_log", "dt_bias", "o_norm",
        "conv_q_w", "conv_k_w", "conv_v_w", "conv_q_b", "conv_k_b", "conv_v_b",
        # mamba2 mixer params
        "dt_proj", "conv_w", "conv_b", "D",
    }
    attn = any(w in ("self_attn", "attn") for w in distill_weights)

    def mask_layer(i, lp):
        on = attn and i not in softmax
        return {k: _map_tree(lambda _, f=on and k in mixer_keys: f, v) for k, v in lp.items()}

    out = {k: _map_tree(lambda _: False, v) for k, v in params.items() if k != "layers"}
    out["layers"] = [mask_layer(i, lp) for i, lp in enumerate(params["layers"])]
    return out
