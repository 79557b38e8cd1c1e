"""Checkpoints (torch port of infinitevl_tpu/utils/checkpoint.py): train
states in the port's own format, the stage-handoff filter, and the HF
safetensors export that `models/params.load_hf_checkpoint` (and the JAX
package's loader) reads back.

A train-state checkpoint is one `step_<n>.pt` file under the checkpoint directory,
written by `torch.save` to a temporary name and renamed, so a reader never
sees a partial file. The state is any nest of dicts, lists, tensors and
plain numbers (parameters or adapters, the optimizer state, the step).
Tensors are saved from the CPU and restored onto the device of the
template's matching leaf, bit for bit."""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

_STEP_FILE = re.compile(r"step_(\d+)\.pt$")


def tree_map(fn, tree):
    """The same nest of dicts, lists and tuples with `fn` applied to every
    tensor (other leaves kept)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def save_train_state(path: str, step: int, state: Dict[str, Any]) -> None:
    """Write `state` as checkpoint `step` under directory `path`."""
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, f"step_{int(step)}.pt")
    tmp = f"{final}.tmp.{os.getpid()}"
    torch.save({"step": int(step), "state": tree_map(lambda t: t.detach().cpu(), state)}, tmp)
    os.replace(tmp, final)


def list_steps(path: str) -> List[int]:
    """The steps of the checkpoints under directory `path`, ascending."""
    if not os.path.isdir(path):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(path)) if m)


def latest_step(path: str) -> Optional[int]:
    return max(list_steps(path), default=None)


def _like(template, loaded):
    """`loaded` with every tensor moved to its template leaf's device and
    dtype, and marked trainable where the template's leaf is."""
    if isinstance(template, dict):
        return {k: _like(template[k], loaded[k]) if k in template else loaded[k]
                for k in loaded}
    if isinstance(template, (list, tuple)):
        return type(template)(_like(t, l) for t, l in zip(template, loaded))
    if isinstance(template, torch.Tensor) and isinstance(loaded, torch.Tensor):
        out = loaded.to(device=template.device, dtype=template.dtype)
        return out.requires_grad_(template.requires_grad)
    return loaded


def restore_train_state(
    path: str, step: Optional[int] = None, template: Optional[Dict[str, Any]] = None
) -> Tuple[Optional[int], Optional[Dict[str, Any]]]:
    """(step, state) of checkpoint `step` (default: the latest) under
    `path`, or (None, None) when there is none. With a `template`, tensors
    land on the devices of the template's leaves."""
    step = step if step is not None else latest_step(path)
    if step is None:
        return None, None
    blob = torch.load(os.path.join(path, f"step_{int(step)}.pt"), map_location="cpu",
                      weights_only=True)
    state = blob["state"]
    return int(blob["step"]), _like(template, state) if template is not None else state


def merge_params(base: Dict[str, Any], update: Dict[str, Any]) -> Dict[str, Any]:
    """Recursively overlay `update` onto `base` (missing keys keep base)."""
    if isinstance(base, dict):
        out = dict(base)
        for k, v in (update or {}).items():
            out[k] = merge_params(base[k], v) if k in base else v
        return out
    if isinstance(base, (list, tuple)):
        return type(base)(merge_params(b, u) for b, u in zip(base, update))
    return update if update is not None else base


def filter_softmax_layers(params: Dict[str, Any], softmax_attention: Sequence[int]
                          ) -> Dict[str, Any]:
    """Stage-handoff filter: the text tree without the attention weights of
    the preserved softmax layers (their MLPs and norms kept), so merging a
    stage's checkpoint leaves those layers as the teacher has them."""
    softmax = set(softmax_attention)
    attn_keys = {
        "q_proj", "k_proj", "v_proj", "o_proj", "a_proj", "b_proj", "g_proj",
        "A_log", "dt_bias", "o_norm",
        "conv_q_w", "conv_k_w", "conv_v_w", "conv_q_b", "conv_k_b", "conv_v_b",
    }
    out = dict(params)
    out["layers"] = [
        {k: v for k, v in lp.items() if not (i in softmax and k in attn_keys)}
        for i, lp in enumerate(params["layers"])
    ]
    return out


# ---------------------------------------------------------------- HF export


def hf_tensors(params: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """The params tree under HF names, in the HF layouts (Linear [out, in],
    Conv1d [D, 1, W], Conv3d patch embedding), as views of the leaves."""
    tensors: Dict[str, torch.Tensor] = {}

    def put_linear(name, p):
        tensors[f"{name}.weight"] = p["kernel"].T
        if "bias" in p:
            tensors[f"{name}.bias"] = p["bias"]

    mlp_names = (("gate", "gate_proj"), ("up", "up_proj"), ("down", "down_proj"))
    text = params["text"]
    tensors["model.language_model.embed_tokens.weight"] = text["embed"]
    tensors["model.language_model.norm.weight"] = text["final_norm"]
    for i, lp in enumerate(text["layers"]):
        pre = f"model.language_model.layers.{i}"
        tensors[f"{pre}.input_layernorm.weight"] = lp["input_norm"]
        tensors[f"{pre}.post_attention_layernorm.weight"] = lp["post_norm"]
        for mk, hk in mlp_names:
            put_linear(f"{pre}.mlp.{hk}", lp["mlp"][mk])
        sa = f"{pre}.self_attn"
        for k in ("q_proj", "k_proj", "v_proj", "o_proj", "a_proj", "b_proj", "g_proj"):
            if k in lp:
                put_linear(f"{sa}.{k}", lp[k])
        for k in ("A_log", "dt_bias"):
            if k in lp:
                tensors[f"{sa}.{k}"] = lp[k]
        if "o_norm" in lp:
            tensors[f"{sa}.o_norm.weight"] = lp["o_norm"]
        for w in "qkv":
            if f"conv_{w}_w" in lp:  # [W, D] -> torch Conv1d [D, 1, W]
                tensors[f"{sa}.{w}_conv1d.weight"] = lp[f"conv_{w}_w"].T[:, None, :]
            if f"conv_{w}_b" in lp:
                tensors[f"{sa}.{w}_conv1d.bias"] = lp[f"conv_{w}_b"]
    if "lm_head" in text:
        tensors["lm_head.weight"] = text["lm_head"].T
    if "visual" in params:
        vis, v = params["visual"], cfg.vision
        tensors["model.visual.patch_embed.proj.weight"] = vis["patch_embed"].T.reshape(
            v.hidden_size, v.in_channels, v.temporal_patch_size, v.patch_size, v.patch_size)
        for i, bp in enumerate(vis["blocks"]):
            pre = f"model.visual.blocks.{i}"
            tensors[f"{pre}.norm1.weight"] = bp["norm1"]
            tensors[f"{pre}.norm2.weight"] = bp["norm2"]
            put_linear(f"{pre}.attn.qkv", bp["qkv"])
            put_linear(f"{pre}.attn.proj", bp["proj"])
            for mk, hk in mlp_names:
                put_linear(f"{pre}.mlp.{hk}", bp["mlp"][mk])
        m = vis["merger"]
        tensors["model.visual.merger.ln_q.weight"] = m["ln_q"]
        put_linear("model.visual.merger.mlp.0", m["fc1"])
        put_linear("model.visual.merger.mlp.2", m["fc2"])
    return tensors


def export_hf_safetensors(
    params: Dict[str, Any],
    cfg,
    out_dir: str,
    max_shard_bytes: int = 4 * 1024**3,
) -> int:
    """Write an HF-layout safetensors checkpoint (model.language_model.* /
    model.visual.* names) and its config.json into `out_dir`, in shards of
    at most `max_shard_bytes` with model.safetensors.index.json when there
    is more than one. Tensors keep their dtype (bf16 stays bf16); each is
    written from a contiguous copy of its HF layout. Returns the bytes of
    tensor data written."""
    from .safetensors_io import save_file

    os.makedirs(out_dir, exist_ok=True)
    tensors = hf_tensors(params, cfg)
    shards: List[Dict[str, torch.Tensor]] = [{}]
    sizes = [0]
    for name in sorted(tensors):
        t = tensors[name]
        nb = t.numel() * t.element_size()
        if sizes[-1] + nb > max_shard_bytes and shards[-1]:
            shards.append({})
            sizes.append(0)
        shards[-1][name] = t
        sizes[-1] += nb
    meta = {"format": "pt"}  # what transformers' loader looks for
    if len(shards) == 1:
        save_file(shards[0], os.path.join(out_dir, "model.safetensors"), meta)
    else:
        index = {"weight_map": {}, "metadata": {"total_size": sum(sizes)}}
        for si, shard in enumerate(shards, 1):
            fn = f"model-{si:05d}-of-{len(shards):05d}.safetensors"
            save_file(shard, os.path.join(out_dir, fn), meta)
            index["weight_map"].update({name: fn for name in shard})
        with open(os.path.join(out_dir, "model.safetensors.index.json"), "w") as f:
            json.dump(index, f, indent=2)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config_to_hf_dict(cfg), f, indent=2)
    return sum(sizes)


def config_to_hf_dict(cfg) -> Dict[str, Any]:
    """The config as an HF config.json dict (config.from_hf_dict reads it)."""
    t, v = cfg.text, cfg.vision
    rope = {"mrope_section": list(t.mrope_section), "rope_type": t.rope_type,
            "type": t.rope_type}
    if t.rope_type != "default":
        rope.update(factor=t.rope_factor,
                    original_max_position_embeddings=t.rope_original_max_position_embeddings)
    return {
        "architectures": ["InfiniteVLQwen2_5_VLForConditionalGeneration"],
        "model_type": "infinite_vl",
        "hidden_size": t.hidden_size,
        "intermediate_size": t.intermediate_size,
        "num_hidden_layers": t.num_hidden_layers,
        "num_attention_heads": t.num_attention_heads,
        "num_key_value_heads": t.num_key_value_heads,
        "head_dim": t.head_dim,
        "vocab_size": t.vocab_size,
        "rms_norm_eps": t.rms_norm_eps,
        "norm_eps": t.norm_eps,
        "rope_theta": t.rope_theta,
        "max_position_embeddings": t.max_position_embeddings,
        "use_sliding_window": t.use_sliding_window,
        "sliding_window": t.sliding_window,
        "layer_types": list(t.layer_types),
        "tie_word_embeddings": t.tie_word_embeddings,
        "expand_v": t.expand_v,
        "conv_size": t.conv_size,
        "conv_bias": t.conv_bias,
        "num_linear_heads": t.num_linear_heads,
        "num_linear_key_value_heads": t.num_linear_key_value_heads,
        "linear_head_dim": t.linear_head_dim,
        "rope_scaling": rope,
        "image_token_id": cfg.image_token_id,
        "video_token_id": cfg.video_token_id,
        "vision_start_token_id": cfg.vision_start_token_id,
        "vision_end_token_id": cfg.vision_end_token_id,
        "bos_token_id": cfg.bos_token_id,
        "eos_token_id": cfg.eos_token_id,
        "vision_config": {
            "depth": v.depth,
            "hidden_size": v.hidden_size,
            "intermediate_size": v.intermediate_size,
            "num_heads": v.num_heads,
            "in_channels": v.in_channels,
            "patch_size": v.patch_size,
            "spatial_merge_size": v.spatial_merge_size,
            "temporal_patch_size": v.temporal_patch_size,
            "tokens_per_second": v.tokens_per_second,
            "window_size": v.window_size,
            "out_hidden_size": v.out_hidden_size,
            "fullatt_block_indexes": list(v.fullatt_block_indexes),
        },
    }
