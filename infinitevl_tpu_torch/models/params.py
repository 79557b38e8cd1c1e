"""Model parameters: random init, HF safetensors checkpoint loading and
conversion from the JAX package's parameters (torch port of
infinitevl_tpu/models/params.py).

Layout is the JAX one. Text: a dict with 'embed' [vocab, D], 'final_norm'
[D], 'inv_freq' [head_dim/2] (fp32), optional untied 'lm_head' [D, vocab],
and 'layers', a list of per-layer dicts. Vision: 'patch_embed'
[in_feat, Dv], 'blocks' (norm1, norm2, qkv, proj, mlp.gate/up/down) and
'merger' (ln_q, fc1, fc2). Linear weights are [d_in, d_out] 'kernel's (the
transpose of torch.nn.Linear), with optional 'bias'. Model-level functions
take {'text': ..., 'visual': ...}, as in JAX.

`device=None` means the CUDA card (device.default_device)."""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..config import LINEAR, MAMBA2, InfiniteVLConfig, TextConfig, VisionConfig
from ..device import Device, resolve_device
from ..ops.rope import rope_init

Params = Dict[str, Any]

_TN_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
_TN_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))


def _trunc_normal(shape, std, gen, device, dtype):
    """std * N(0, 1) truncated to [-2, 2] (inverse-CDF sampling)."""
    u = torch.rand(shape, generator=gen, device=device) * (_TN_HI - _TN_LO) + _TN_LO
    return (torch.erfinv(2.0 * u - 1.0) * (math.sqrt(2.0) * std)).to(dtype)


def _uniform(shape, lo, hi, gen, device):
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def _linear(d_in, d_out, gen, device, dtype, bias=False, std=0.02):
    p = {"kernel": _trunc_normal((d_in, d_out), std, gen, device, dtype)}
    if bias:
        p["bias"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def _mlp(cfg, gen, device, dtype):
    D, I = cfg.hidden_size, cfg.intermediate_size
    return {
        "gate": _linear(D, I, gen, device, dtype),
        "up": _linear(D, I, gen, device, dtype),
        "down": _linear(I, D, gen, device, dtype),
    }


def init_swa_layer(cfg: TextConfig, gen, device, dtype) -> Params:
    D, Dh = cfg.hidden_size, cfg.head_dim
    ones = torch.ones((D,), dtype=dtype, device=device)
    return {
        "input_norm": ones.clone(),
        "post_norm": ones.clone(),
        "q_proj": _linear(D, cfg.num_attention_heads * Dh, gen, device, dtype, bias=True),
        "k_proj": _linear(D, cfg.num_key_value_heads * Dh, gen, device, dtype, bias=True),
        "v_proj": _linear(D, cfg.num_key_value_heads * Dh, gen, device, dtype, bias=True),
        "o_proj": _linear(cfg.num_attention_heads * Dh, D, gen, device, dtype),
        "mlp": _mlp(cfg, gen, device, dtype),
    }


def init_delta_layer(cfg: TextConfig, gen, device, dtype, mimic_init: bool = False) -> Params:
    """DeltaNet layer: A_log = log U(1e-4, 16), dt_bias = softplus^-1 of a
    log-uniform dt in [1e-3, 0.1], conv taps kaiming-uniform (fan_in = W),
    as in the JAX init and the reference.

    mimic_init (the distillation warm start, as in JAX): conv = identity
    tap, a / b projections zeroed, A = 1 (A_log 0), dt = 1e-3, so the layer
    starts out approximating softmax attention's value path."""
    D = cfg.hidden_size
    H = cfg.num_linear_heads
    HK = H * cfg.linear_head_dim
    KD, VD = cfg.linear_key_dim, cfg.linear_value_dim
    HV = H * cfg.head_v_dim
    W = cfg.conv_size
    a = _uniform((H,), 1e-4, 16.0, gen, device)
    dt = torch.exp(
        _uniform((H,), 0.0, 1.0, gen, device) * (math.log(0.1) - math.log(1e-3))
        + math.log(1e-3)
    ).clamp(min=1e-4)
    bound = 1.0 / math.sqrt(W)
    ones = torch.ones((D,), dtype=dtype, device=device)
    p = {
        "input_norm": ones.clone(),
        "post_norm": ones.clone(),
        "q_proj": _linear(D, HK, gen, device, dtype),
        "k_proj": _linear(D, KD, gen, device, dtype),
        "v_proj": _linear(D, VD, gen, device, dtype),
        "a_proj": _linear(D, H, gen, device, dtype),
        "b_proj": _linear(D, H, gen, device, dtype),
        "g_proj": _linear(D, HV, gen, device, dtype),
        "o_proj": _linear(HV, D, gen, device, dtype),
        "A_log": torch.log(a).float(),
        "dt_bias": (dt + torch.log(-torch.expm1(-dt))).float(),
        "o_norm": torch.ones((cfg.head_v_dim,), dtype=dtype, device=device),
        "conv_q_w": _uniform((W, HK), -bound, bound, gen, device).to(dtype),
        "conv_k_w": _uniform((W, KD), -bound, bound, gen, device).to(dtype),
        "conv_v_w": _uniform((W, VD), -bound, bound, gen, device).to(dtype),
        "mlp": _mlp(cfg, gen, device, dtype),
    }
    if cfg.conv_bias:
        for n, d in (("q", HK), ("k", KD), ("v", VD)):
            p[f"conv_{n}_b"] = torch.zeros((d,), dtype=dtype, device=device)
    if mimic_init:
        ident = torch.zeros((W, 1), dtype=dtype, device=device)
        ident[W - 1] = 1.0
        for n, d in (("q", HK), ("k", KD), ("v", VD)):
            p[f"conv_{n}_w"] = ident.expand(W, d).contiguous()
        p["a_proj"]["kernel"] = torch.zeros_like(p["a_proj"]["kernel"])
        p["b_proj"]["kernel"] = torch.zeros_like(p["b_proj"]["kernel"])
        p["A_log"] = torch.zeros_like(p["A_log"])
        dt = torch.full((H,), 1e-3, device=device)
        p["dt_bias"] = (dt + torch.log(-torch.expm1(-dt))).float()
    return p


def init_mamba2_layer(cfg: TextConfig, gen, device, dtype, mimic_init: bool = False) -> Params:
    """Mamba2 mixer layer (the rules of JAX init_mamba2_layer): q / k / v
    (= the SSD's C / B / x) with bias, a fused conv over [v, k, q] with
    kaiming-uniform taps (fan_in = W) and a zero bias, dt_proj, per-head
    dt_bias / A_log / D in fp32 (A_log = log U(1, 16), D = 1, dt_bias 0),
    the gated RMSNorm's g_proj (std 0.02 * 2^-2.5) and o_norm, o_proj.

    mimic_init (the distillation warm start): conv = identity tap, dt_proj
    zeroed, dt_bias = softplus^-1 of a log-uniform dt in [1e-3, 0.1], A_log
    = 1."""
    D, H, Dh = cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim
    HD, W = H * Dh, cfg.conv_size
    bound = 1.0 / math.sqrt(W)
    conv_w = _uniform((W, 3 * HD), -bound, bound, gen, device).to(dtype)
    dt = torch.exp(
        _uniform((H,), 0.0, 1.0, gen, device) * (math.log(0.1) - math.log(1e-3))
        + math.log(1e-3)
    ).clamp(min=1e-3)
    ones = torch.ones((D,), dtype=dtype, device=device)
    p = {
        "input_norm": ones.clone(),
        "post_norm": ones.clone(),
        "q_proj": _linear(D, HD, gen, device, dtype, bias=True),
        "k_proj": _linear(D, HD, gen, device, dtype, bias=True),
        "v_proj": _linear(D, HD, gen, device, dtype, bias=True),
        "o_proj": _linear(HD, D, gen, device, dtype),
        "dt_proj": _linear(D, H, gen, device, dtype),
        "g_proj": _linear(D, HD, gen, device, dtype, std=0.02 * 2**-2.5),
        "conv_w": conv_w,
        "conv_b": torch.zeros((3 * HD,), dtype=dtype, device=device),
        "dt_bias": (dt + torch.log(-torch.expm1(-dt)) if mimic_init
                    else torch.zeros((H,), device=device)).float(),
        "A_log": (torch.ones((H,), device=device) if mimic_init
                  else torch.log(_uniform((H,), 1.0, 16.0, gen, device))).float(),
        "D": torch.ones((H,), dtype=torch.float32, device=device),
        "o_norm": torch.ones((Dh,), dtype=dtype, device=device),
        "mlp": _mlp(cfg, gen, device, dtype),
    }
    if mimic_init:
        ident = torch.zeros((W, 1), dtype=dtype, device=device)
        ident[W - 1] = 1.0
        p["conv_w"] = ident.expand(W, 3 * HD).contiguous()
        p["dt_proj"]["kernel"] = torch.zeros_like(p["dt_proj"]["kernel"])
    return p


def init_text_params(
    cfg: TextConfig,
    generator: torch.Generator,
    device: Optional[Device] = None,
    dtype: torch.dtype = torch.bfloat16,
) -> Params:
    """Random text-decoder params at any width, drawn from `generator`
    (which must live on `device`). Same shapes and init rules as JAX
    init_text_params; the numbers differ (another generator)."""
    device = resolve_device(device)
    layers = []
    for i in range(cfg.num_hidden_layers):
        role = cfg.layer_role(i)
        if role == LINEAR:
            layers.append(init_delta_layer(cfg, generator, device, dtype))
        elif role == MAMBA2:
            layers.append(init_mamba2_layer(cfg, generator, device, dtype))
        else:  # sliding or full attention share one parameter shape
            layers.append(init_swa_layer(cfg, generator, device, dtype))
    p = {
        "embed": _trunc_normal(
            (cfg.vocab_size, cfg.hidden_size), 0.02, generator, device, dtype
        ),
        "final_norm": torch.ones((cfg.hidden_size,), dtype=dtype, device=device),
        "inv_freq": torch.as_tensor(rope_init(cfg)[0], dtype=torch.float32, device=device),
        "layers": layers,
    }
    if not cfg.tie_word_embeddings:
        p["lm_head"] = _trunc_normal(
            (cfg.hidden_size, cfg.vocab_size), 0.02, generator, device, dtype
        )
    return p


def init_vision_params(
    cfg: VisionConfig,
    generator: torch.Generator,
    device: Optional[Device] = None,
    dtype: torch.dtype = torch.bfloat16,
) -> Params:
    """Random ViT params (shapes and init rules of JAX init_vision_params)."""
    device = resolve_device(device)
    D, I = cfg.hidden_size, cfg.intermediate_size
    in_feat = cfg.in_channels * cfg.temporal_patch_size * cfg.patch_size**2

    def lin(d_in, d_out):
        return _linear(d_in, d_out, generator, device, dtype, bias=True)

    ones = torch.ones((D,), dtype=dtype, device=device)
    blocks = [
        {
            "norm1": ones.clone(),
            "norm2": ones.clone(),
            "qkv": lin(D, 3 * D),
            "proj": lin(D, D),
            "mlp": {"gate": lin(D, I), "up": lin(D, I), "down": lin(I, D)},
        }
        for _ in range(cfg.depth)
    ]
    merged = D * cfg.spatial_merge_unit
    return {
        "patch_embed": _trunc_normal((in_feat, D), 0.02, generator, device, dtype),
        "blocks": blocks,
        "merger": {
            "ln_q": ones.clone(),
            "fc1": lin(merged, merged),
            "fc2": lin(merged, cfg.out_hidden_size),
        },
    }


def init_params(
    cfg: InfiniteVLConfig,
    generator: torch.Generator,
    device: Optional[Device] = None,
    dtype: torch.dtype = torch.bfloat16,
) -> Params:
    return {
        "text": init_text_params(cfg.text, generator, device, dtype),
        "visual": init_vision_params(cfg.vision, generator, device, dtype),
    }


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16 from a JAX array
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def from_jax_numpy(params_np: Any, device: Optional[Device] = None,
                   trainable: bool = False) -> Any:
    """Convert a JAX tree already moved to numpy (nested dicts, lists or
    tuples of arrays; e.g. `jax.tree.map(np.asarray, params)`) into the
    port's: the same tree with torch tensors. Layouts are shared, text and
    visual alike, so no transpose happens. The tree may be model params (a
    text tree may carry the preference stages' `value_head`: {'kernel':
    [D, 1]}), or a LoRA adapter tree (`init_lora` output: {'a', 'b'} nodes, `{}` for a
    layer without adapters), which `trainable=True` marks as trainable
    leaves. None leaves stay None. A pipelined tree (JAX's
    parallel/pipeline.stack_stage_params: `stage_stacks`, leaves [S, G / S,
    ...]) comes across with its per-layer `layers` list
    (parallel/pipeline.unstack_stage_params)."""
    device = resolve_device(device)
    if isinstance(params_np, dict) and "stage_stacks" in params_np:
        from ..parallel.pipeline import unstack_stage_params

        params_np = unstack_stage_params(params_np)
    if isinstance(params_np, dict):
        return {k: from_jax_numpy(v, device, trainable) for k, v in params_np.items()}
    if isinstance(params_np, (list, tuple)):
        return [from_jax_numpy(v, device, trainable) for v in params_np]
    if params_np is None:
        return None
    out = _tensor(params_np, device)
    return out.requires_grad_(True) if trainable and out.is_floating_point() else out


def adamw_state_from_jax_numpy(trainable_tree: Any, mu_np: Any, nu_np: Any, count,
                               device: Optional[Device] = None) -> dict:
    """A JAX AdamW state as the port's (train/step.AdamW): `mu_np` and
    `nu_np` are the first and second moments as numpy trees shaped like the
    optimised tree, `count` the steps taken. `trainable_tree` is the port's
    tree the optimizer will update: its trainable leaves, in its order,
    pick their moments by path."""
    from ..train.step import trainable_leaves, tree_leaves_with_path

    mu = dict(tree_leaves_with_path(from_jax_numpy(mu_np, device)))
    nu = dict(tree_leaves_with_path(from_jax_numpy(nu_np, device)))
    paths = [path for path, _ in trainable_leaves(trainable_tree)]
    return {"count": int(count), "mu": [mu[p] for p in paths], "nu": [nu[p] for p in paths]}


def param_count(params: Params) -> int:
    from ..train.step import tree_leaves_with_path

    return sum(t.numel() for _, t in tree_leaves_with_path(params))


# ---------------------------------------------------------------- HF checkpoints


def _strip_prefix(name: str) -> Optional[Tuple[str, str]]:
    """Normalize an HF tensor name -> ('text'|'visual'|'lm_head', rest).
    Both layouts the reference accepts: `model.language_model.*` /
    `model.visual.*` and the legacy `model.*` / `visual.*`."""
    for pre in ("model.language_model.", "language_model.", "model.model."):
        if name.startswith(pre):
            return "text", name[len(pre):]
    for pre in ("model.visual.", "visual."):
        if name.startswith(pre):
            return "visual", name[len(pre):]
    if name == "lm_head.weight":
        return "lm_head", ""
    if name.startswith("model."):
        return "text", name[len("model."):]
    return None


def checkpoint_files(path: str) -> List[str]:
    """The safetensors files of a checkpoint: a file, or a directory with
    model.safetensors.index.json (its shards) or loose *.safetensors."""
    if not os.path.isdir(path):
        return [path]
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            names = sorted(set(json.load(f)["weight_map"].values()))
        return [os.path.join(path, n) for n in names]
    return sorted(os.path.join(path, n) for n in os.listdir(path)
                  if n.endswith(".safetensors"))


def _iter_safetensors(path: str, device) -> Iterator[Tuple[str, torch.Tensor]]:
    from ..utils.safetensors_io import iter_file

    for fp in checkpoint_files(path):
        yield from iter_file(fp, device)


def _meta_to_zeros(tree, device):
    """Leaves still on the meta device (no tensor of the checkpoint filled
    them) become zeros on `device`."""
    if isinstance(tree, dict):
        return {k: _meta_to_zeros(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_meta_to_zeros(v, device) for v in tree]
    if isinstance(tree, torch.Tensor) and tree.is_meta:
        return torch.zeros(tree.shape, dtype=tree.dtype, device=device)
    return tree


def load_hf_checkpoint(
    path: str,
    cfg: InfiniteVLConfig,
    dtype: torch.dtype = torch.bfloat16,
    params: Optional[Params] = None,
    device: Optional[Device] = None,
) -> Params:
    """Load an HF-format InfiniteVL / Qwen2.5-VL-style safetensors
    checkpoint into the params tree on `device` (None: the CUDA card).
    Kernels are stored transposed ([out, in]), a Conv1d [D, 1, W] becomes
    [W, D], the Conv3d patch embedding a matmul [C*tp*p*p, Dv]; A_log and
    dt_bias stay fp32, everything else takes `dtype`; `inv_freq` is rebuilt
    from the config; with tied embeddings a stored lm_head is dropped.
    When `params` is given, tensors are loaded into a copy of it (missing
    tensors keep its values); otherwise a tensor the checkpoint lacks is
    zero. Raises when no tensor matched."""
    device = resolve_device(device)
    if params is None:
        params = init_params(cfg, None, "meta", dtype)  # shapes only
        params["text"]["inv_freq"] = torch.as_tensor(
            rope_init(cfg.text)[0], dtype=torch.float32, device=device)
    text = dict(params["text"])
    text_layers = [dict(lp, mlp=dict(lp["mlp"])) for lp in text["layers"]]
    visual = dict(params["visual"])
    vis_blocks = [dict(b, mlp=dict(b["mlp"])) for b in visual["blocks"]]
    merger = dict(visual["merger"])

    loaded = 0
    for name, arr in _iter_safetensors(path, device):
        hit = _strip_prefix(name)
        if hit is None:
            continue
        scope, rest = hit
        if scope == "lm_head":
            text["lm_head"] = arr.to(dtype).T.contiguous()
            loaded += 1
        elif scope == "text":
            loaded += _load_text_tensor(text, text_layers, rest, arr, dtype)
        else:
            loaded += _load_visual_tensor(vis_blocks, visual, merger, rest, arr, dtype)
    if loaded == 0:
        raise ValueError(f"no tensors matched under {path}")
    text["layers"] = text_layers
    visual["blocks"] = vis_blocks
    visual["merger"] = merger
    if cfg.text.tie_word_embeddings:
        # tied checkpoints may still store lm_head == embed; the head reads embed
        text.pop("lm_head", None)
    return _meta_to_zeros({"text": text, "visual": visual}, device)


def _set_linear(dst: Dict, key: str, arr: torch.Tensor, dtype, is_bias: bool) -> None:
    p = dict(dst.get(key, {}))
    if is_bias:
        p["bias"] = arr.to(dtype)
    else:
        p["kernel"] = arr.to(dtype).T.contiguous()  # torch Linear [out, in] -> [in, out]
    dst[key] = p


def _load_text_tensor(text, layers, rest: str, arr, dtype) -> int:
    if rest == "embed_tokens.weight":
        text["embed"] = arr.to(dtype)
        return 1
    if rest == "norm.weight":
        text["final_norm"] = arr.to(dtype)
        return 1
    if not rest.startswith("layers."):
        return 0
    parts = rest.split(".")
    lp = layers[int(parts[1])]
    tail = ".".join(parts[2:])
    is_bias = tail.endswith(".bias")
    if tail == "input_layernorm.weight":
        lp["input_norm"] = arr.to(dtype)
    elif tail == "post_attention_layernorm.weight":
        lp["post_norm"] = arr.to(dtype)
    elif tail.startswith("mlp."):
        _set_linear(lp["mlp"], parts[3].split("_")[0], arr, dtype, is_bias)  # gate/up/down
    elif tail.startswith("self_attn."):
        sub = parts[3]
        if sub in ("q_proj", "k_proj", "v_proj", "o_proj", "a_proj", "b_proj", "g_proj"):
            _set_linear(lp, sub, arr, dtype, is_bias)
        elif sub in ("A_log", "dt_bias"):
            lp[sub] = arr.float()
        elif sub == "o_norm":
            lp["o_norm"] = arr.to(dtype)
        elif sub.endswith("_conv1d"):
            which = sub.split("_")[0]  # q/k/v
            if is_bias:
                lp[f"conv_{which}_b"] = arr.to(dtype)
            else:  # torch Conv1d [D, 1, W] -> [W, D]
                lp[f"conv_{which}_w"] = arr[:, 0, :].to(dtype).T.contiguous()
        else:
            return 0
    else:
        return 0
    return 1


def _load_visual_tensor(blocks, visual, merger, rest: str, arr, dtype) -> int:
    is_bias = rest.endswith(".bias")
    if rest == "patch_embed.proj.weight":
        # Conv3d [Dv, C, tp, p, p] with kernel == stride -> matmul [C*tp*p*p, Dv]
        visual["patch_embed"] = arr.reshape(arr.shape[0], -1).to(dtype).T.contiguous()
        return 1
    if rest == "merger.ln_q.weight":
        merger["ln_q"] = arr.to(dtype)
        return 1
    if rest.startswith("merger.mlp."):
        _set_linear(merger, "fc1" if rest.split(".")[2] == "0" else "fc2", arr, dtype, is_bias)
        return 1
    if not rest.startswith("blocks."):
        return 0
    parts = rest.split(".")
    bp = blocks[int(parts[1])]
    tail = ".".join(parts[2:])
    if tail in ("norm1.weight", "norm2.weight"):
        bp[tail.split(".")[0]] = arr.to(dtype)
    elif tail.startswith("attn.qkv"):
        _set_linear(bp, "qkv", arr, dtype, is_bias)
    elif tail.startswith("attn.proj"):
        _set_linear(bp, "proj", arr, dtype, is_bias)
    elif tail.startswith("mlp."):
        _set_linear(bp["mlp"], parts[3].split("_")[0], arr, dtype, is_bias)
    else:
        return 0
    return 1
