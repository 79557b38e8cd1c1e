"""Hybrid SWA / Gated-DeltaNet text decoder (torch port of the inference
path of infinitevl_tpu/models/text.py).

Parameters are the JAX layout (models/params.py); the layer loop is a
Python loop. With a state, every layer updates its part of the stacked
state IN PLACE: T == 1 goes through the decode kernels (A2 for SWA
layers, B for DeltaNet layers), T > 1 through the prefill kernel A1 plus a
plain ring write for SWA layers and, for DeltaNet layers, the chunked
delta rule kernel C (T above cfg.recurrent_threshold; the plain recurrence
below it). A CUDA tensor always reaches the kernel, which raises on what it
cannot take; a CPU tensor takes the kernel's plain version."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import FULL, LINEAR, SLIDING, TextConfig
from ..ops.delta_kernels import delta_step_fused_stacked
from ..ops.delta_rule import gated_delta_rule
from ..ops.norms import rms_norm, rms_norm_gated, silu
from ..ops.rope import apply_rotary, mrope_cos_sin
from ..ops.short_conv import short_conv, short_conv_step
from ..ops.swa import ring_write_stacked, swa_prefill_dense
from ..ops.swa_kernels import (
    swa_ring_flash_attention,
    swa_ring_flash_decode_stacked,
)
from .state import DecoderState

Params = Dict[str, Any]

# parameter layouts of the JAX package that later slices port
_LATER = {
    "kernel_q": "int8 weight-only serving (serving slice)",
    "kernel_q4": "int4 weight-only serving (serving slice)",
    "kernel_q4b": "int4 weight-only serving (serving slice)",
    "kernel_q4f": "fused int4 serving (kernel G, serving slice)",
    "lora_a": "LoRA adapters (training slice)",
    "dora_scale": "DoRA adapters (training slice)",
    "qkv_proj": "fused projections (serving slice, models/fuse.py)",
    "fused_proj": "fused projections (serving slice, models/fuse.py)",
    "gate_up": "fused projections (serving slice, models/fuse.py)",
}


def _not_ported(p: Params) -> None:
    for key, what in _LATER.items():
        if key in p:
            raise NotImplementedError(
                f"parameter layout {key!r} ({what}) is not ported to torch yet"
            )


def _dense(x: torch.Tensor, p: Params) -> torch.Tensor:
    """x @ kernel (+ bias); kernel is [d_in, d_out]."""
    _not_ported(p)
    y = x @ p["kernel"]
    if "bias" in p:
        y = y + p["bias"]
    return y


def mlp_forward(p: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP."""
    _not_ported(p)
    return _dense(silu(_dense(x, p["gate"])) * _dense(x, p["up"]), p["down"])


def swa_attention_forward(
    p: Params,
    cfg: TextConfig,
    x: torch.Tensor,  # [B, T, D]
    cos: torch.Tensor,  # [B, T, head_dim]
    sin: torch.Tensor,
    rings_k: Optional[torch.Tensor],  # [S, B, Hkv, cap, Dh] stacked rings or None
    rings_v: Optional[torch.Tensor],
    cum_len: Optional[int],
    layer_idx: int = 0,
    window: Optional[int] = None,
) -> torch.Tensor:
    """GQA with qkv bias, mRoPE and the sliding-window mask, no o_proj bias.
    With rings, layer `layer_idx` of the stacked rings is updated IN PLACE
    with the new tokens' K/V. Returns [B, T, D]."""
    _not_ported(p)
    B, T, _ = x.shape
    Hq, Hkv, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    window = window if window is not None else cfg.sliding_window
    q = _dense(x, p["q_proj"]).reshape(B, T, Hq, Dh)
    k = _dense(x, p["k_proj"]).reshape(B, T, Hkv, Dh)
    v = _dense(x, p["v_proj"]).reshape(B, T, Hkv, Dh)
    q, k = apply_rotary(q, k, cos, sin)
    if rings_k is None:
        out = swa_prefill_dense(q, k, v, window)
    elif T == 1:
        # write-then-attend over the ring alone (kernel A2)
        out = swa_ring_flash_decode_stacked(
            q, k, v, rings_k, rings_v, layer_idx, cum_len, window
        )
    else:
        out = swa_ring_flash_attention(
            q, k, v, rings_k[layer_idx], rings_v[layer_idx], cum_len, window
        )
        ring_write_stacked(rings_k, rings_v, layer_idx, k, v, cum_len)
    return _dense(out.reshape(B, T, Hq * Dh), p["o_proj"])


def delta_forward(
    p: Params,
    cfg: TextConfig,
    x: torch.Tensor,  # [B, T, D]
    conv_q: Optional[torch.Tensor],  # stacked [L, B, W, HK] or None
    conv_k: Optional[torch.Tensor],
    conv_v: Optional[torch.Tensor],
    h: Optional[torch.Tensor],  # stacked [L, B, H, K, V] fp32 or None
    layer_idx: int = 0,
) -> torch.Tensor:
    """Gated DeltaNet layer. With a state, layer `layer_idx` of the stacked
    conv histories and recurrent state is updated IN PLACE. Returns
    [B, T, D]."""
    _not_ported(p)
    B, T, _ = x.shape
    H, K, V = cfg.num_linear_heads, cfg.linear_head_dim, cfg.head_v_dim
    q_raw = _dense(x, p["q_proj"])
    k_raw = _dense(x, p["k_proj"])
    v_raw = _dense(x, p["v_proj"])
    a_lin = _dense(x, p["a_proj"])
    b_lin = _dense(x, p["b_proj"])
    g_lin = _dense(x, p["g_proj"])

    use_cache = conv_q is not None
    decode = use_cache and T == 1
    convs = []
    for raw, name, stack in ((q_raw, "q", conv_q), (k_raw, "k", conv_k), (v_raw, "v", conv_v)):
        w, bias = p[f"conv_{name}_w"], p.get(f"conv_{name}_b")
        if decode:
            y, new_c = short_conv_step(raw[:, 0], w, bias, stack[layer_idx])
            y = y[:, None]
        else:
            y, new_c = short_conv(
                raw, w, bias, stack[layer_idx] if use_cache else None,
                carry_history=cfg.conv_carry,
            )
        if use_cache:
            stack[layer_idx].copy_(new_c)
        convs.append(y)
    q = convs[0].reshape(B, T, H, K)
    k = convs[1].reshape(B, T, H, K)
    v = convs[2].reshape(B, T, H, V)

    beta = torch.sigmoid(b_lin.float())  # [B, T, H]; g/beta in fp32
    g = -torch.exp(p["A_log"].float()) * F.softplus(a_lin.float() + p["dt_bias"].float())

    if decode:
        # kernel B: both state reductions, the decay + rank-1 update and the
        # in-place write of the layer's slab of the stacked state
        o = delta_step_fused_stacked(
            q[:, 0], k[:, 0], v[:, 0], g[:, 0], beta[:, 0], h, layer_idx
        )[:, None]
    else:
        # the chunk math is chunk-size invariant; short inputs take a
        # smaller chunk so the pad to a chunk multiple stays small
        chunk = cfg.delta_chunk_size
        if T <= 512:
            chunk = min(chunk, 64)
        # with a state, kernel C reads the layer's slab of the stacked state
        # and writes the final state back into it
        slab = h[layer_idx] if use_cache else None
        o, _ = gated_delta_rule(
            q, k, v, g, beta,
            initial_state=slab,
            chunk_size=chunk,
            recurrent_threshold=cfg.recurrent_threshold,
            out_state=slab,
        )
    o = rms_norm_gated(o, g_lin.reshape(B, T, H, V), p["o_norm"], eps=cfg.norm_eps)
    return _dense(o.reshape(B, T, H * V), p["o_proj"])


def decoder_layer_forward(
    p: Params,
    cfg: TextConfig,
    role: str,
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    state: Optional[DecoderState],
    stack_idx: int,
) -> torch.Tensor:
    """Pre-norm residual block. `stack_idx` is the layer's index within the
    SWA or DeltaNet stack of `state` (updated in place)."""
    h = rms_norm(x, p["input_norm"], cfg.rms_norm_eps)
    if role in (SLIDING, FULL):
        if role == FULL and state is not None:
            raise NotImplementedError(
                "cached decoding with full_attention layers is not supported "
                "(the deployed InfiniteVL config has none)"
            )
        window = cfg.sliding_window if role == SLIDING else (1 << 30)
        if state is None:
            attn = swa_attention_forward(p, cfg, h, cos, sin, None, None, None,
                                         window=window)
        else:
            attn = swa_attention_forward(
                p, cfg, h, cos, sin, state["swa_k"], state["swa_v"],
                state["cum_len"], layer_idx=stack_idx, window=window,
            )
    elif role == LINEAR:
        if state is None:
            attn = delta_forward(p, cfg, h, None, None, None, None)
        else:
            attn = delta_forward(
                p, cfg, h, state["conv_q"], state["conv_k"], state["conv_v"],
                state["delta_h"], layer_idx=stack_idx,
            )
    else:
        raise NotImplementedError(f"layer role {role!r} is not ported to torch yet")
    x = x + attn
    return x + mlp_forward(p["mlp"], rms_norm(x, p["post_norm"], cfg.rms_norm_eps))


def text_forward(
    params: Params,
    cfg: TextConfig,
    inputs_embeds: torch.Tensor,  # [B, T, D]
    position_ids: torch.Tensor,  # [3, B, T]
    state: Optional[DecoderState] = None,
) -> Tuple[torch.Tensor, Optional[DecoderState]]:
    """Run the decoder stack. With a state, the state is updated IN PLACE
    (rings, conv histories, delta_h, and cum_len += T) and returned.
    Returns (final-normed hidden [B, T, D], state)."""
    if "layer_stacks" in params:
        raise NotImplementedError(
            "scan-over-layers params (layer_stacks) belong to the training "
            "slice and are not ported to torch yet"
        )
    cos, sin = mrope_cos_sin(
        position_ids, params["inv_freq"], cfg.mrope_section,
        cfg.attention_scaling, dtype=inputs_embeds.dtype,
    )
    x = inputs_embeds
    swa_i = lin_i = 0
    for idx, layer_p in enumerate(params["layers"]):
        role = cfg.layer_role(idx)
        stack_idx = swa_i if role in (SLIDING, FULL) else lin_i
        x = decoder_layer_forward(layer_p, cfg, role, x, cos, sin, state, stack_idx)
        if role in (SLIDING, FULL):
            swa_i += 1
        else:
            lin_i += 1
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    if state is not None:
        state["cum_len"] += inputs_embeds.shape[1]
    return x, state


def lm_head(params: Params, cfg: TextConfig, hidden: torch.Tensor) -> torch.Tensor:
    """fp32 logits; tied to the embedding when cfg.tie_word_embeddings."""
    for key in ("lm_head_q", "head_q"):
        if key in params:
            raise NotImplementedError(
                f"quantized head {key!r} (serving slice) is not ported to torch yet"
            )
    w = params["lm_head"] if "lm_head" in params else params["embed"].T
    return (hidden @ w.to(hidden.dtype)).float()


def embed_tokens(params: Params, input_ids: torch.Tensor) -> torch.Tensor:
    if "embed_q" in params:
        raise NotImplementedError(
            "quantized embeddings (serving slice) are not ported to torch yet"
        )
    return params["embed"][input_ids]
