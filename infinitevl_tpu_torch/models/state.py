"""Decoder inference state (torch port of infinitevl_tpu/models/state.py).

Same keys, layouts and dtypes as the JAX state (S = #SWA layers,
L = #DeltaNet layers):
  swa_k, swa_v : [S, B, Hkv, cap, Dh]  ring KV, head-major, cap = window
  delta_h      : [L, B, H, K, V] fp32   recurrent state
  conv_q/k/v   : [L, B, W, D*]          raw-input history of the short convs
  cum_len      : int                    tokens processed so far (host int)
and, only when the config has mamba2 layers (M of them; models/convert.py's
mamba2 students), so that the deployed state is unchanged:
  mamba_conv   : [M, B, W, 3*H*Dh]      raw-input history of the fused [v, k, q] conv
  mamba_h      : [M, B, H, Dh, Dh] fp32 SSM state (N = P = head_dim)

The model updates the tensors IN PLACE; branching a stream (decoding from
a snapshot without disturbing the original) needs `clone_state` first;
`state_row` is the same for one row of a multi-stream state."""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from ..config import TextConfig
from ..device import Device, resolve_device

DecoderState = Dict[str, Union[torch.Tensor, int]]


def init_decoder_state(
    cfg: TextConfig,
    batch_size: int,
    dtype: torch.dtype = torch.bfloat16,
    device: Optional[Device] = None,
) -> DecoderState:
    """Zero state; `device=None` means the CUDA card."""
    device = resolve_device(device)
    S = cfg.num_swa_layers
    L = cfg.num_linear_layers
    B = batch_size
    W = cfg.conv_size
    K = cfg.linear_head_dim

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    state = {
        "swa_k": zeros(S, B, cfg.num_key_value_heads, cfg.swa_capacity, cfg.head_dim),
        "swa_v": zeros(S, B, cfg.num_key_value_heads, cfg.swa_capacity, cfg.head_dim),
        "delta_h": zeros(L, B, cfg.num_linear_heads, K, cfg.head_v_dim, dt=torch.float32),
        "conv_q": zeros(L, B, W, cfg.num_linear_heads * K),
        "conv_k": zeros(L, B, W, cfg.linear_key_dim),
        "conv_v": zeros(L, B, W, cfg.linear_value_dim),
        "cum_len": 0,
    }
    M = cfg.num_mamba2_layers
    if M:
        H, Dh = cfg.num_attention_heads, cfg.head_dim
        state["mamba_conv"] = zeros(M, B, W, 3 * H * Dh)
        state["mamba_h"] = zeros(M, B, H, Dh, Dh, dt=torch.float32)
    return state


def state_bytes(state: DecoderState) -> int:
    """Device bytes held by the state's tensors."""
    return sum(
        v.numel() * v.element_size()
        for v in state.values()
        if isinstance(v, torch.Tensor)
    )


def clone_state(state: DecoderState) -> DecoderState:
    """Deep copy: the snapshot a branch decodes from while the original
    stays untouched."""
    return {
        k: v.clone() if isinstance(v, torch.Tensor) else v
        for k, v in state.items()
    }


def state_row(state: DecoderState, row: int) -> DecoderState:
    """Copy of batch row `row` as a batch-1 state (every tensor is
    [layers, B, ...])."""
    return {
        k: v[:, row : row + 1].clone() if isinstance(v, torch.Tensor) else v
        for k, v in state.items()
    }
