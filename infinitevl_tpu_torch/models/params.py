"""Model parameters: random init and conversion from the JAX package's
parameters (torch port of infinitevl_tpu/models/params.py without the
checkpoint loaders).

Layout is the JAX one. Text: a dict with 'embed' [vocab, D], 'final_norm'
[D], 'inv_freq' [head_dim/2] (fp32), optional untied 'lm_head' [D, vocab],
and 'layers', a list of per-layer dicts. Vision: 'patch_embed'
[in_feat, Dv], 'blocks' (norm1, norm2, qkv, proj, mlp.gate/up/down) and
'merger' (ln_q, fc1, fc2). Linear weights are [d_in, d_out] 'kernel's (the
transpose of torch.nn.Linear), with optional 'bias'. Model-level functions
take {'text': ..., 'visual': ...}, as in JAX.

`device=None` means the CUDA card (device.default_device)."""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

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


def init_delta_layer(cfg: TextConfig, gen, device, dtype) -> Params:
    """DeltaNet layer: A_log = log U(1e-4, 16), dt_bias = softplus^-1 of a
    log-uniform dt in [1e-3, 0.1], conv taps kaiming-uniform (fan_in = W),
    as in the JAX init and the reference."""
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
        if role == MAMBA2:
            raise NotImplementedError("mamba2 layers are not ported to torch yet")
        if role == LINEAR:
            layers.append(init_delta_layer(cfg, generator, device, dtype))
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


def from_jax_numpy(params_np: Any, device: Optional[Device] = None) -> Any:
    """Convert JAX params already moved to numpy (nested dicts, lists or
    tuples of arrays; e.g. `jax.tree.map(np.asarray, params)`) into the
    port's params: the same tree with torch tensors. Layouts are shared,
    text and visual alike, so no transpose happens."""
    device = resolve_device(device)
    if isinstance(params_np, dict):
        return {k: from_jax_numpy(v, device) for k, v in params_np.items()}
    if isinstance(params_np, (list, tuple)):
        return [from_jax_numpy(v, device) for v in params_np]
    return _tensor(params_np, device)
