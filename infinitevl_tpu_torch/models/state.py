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
`state_row` is the same for one row of a multi-stream state.

Under tensor parallelism (parallel/sharding.py) a rank holds its part of
the state: `init_decoder_state(mesh=...)` makes it (batch rows of its
data coordinate; the SWA rings of the KV heads its query heads read, its
DeltaNet heads' states and its conv channels, its Mamba2 heads' states and
their channels of the fused conv's history), `sharding.shard_state` cuts
it from a whole state and `sharding.gather_state` puts the parts back."""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from ..config import TextConfig
from ..device import Device, resolve_device
from ..parallel.sharding import local_state_shape

DecoderState = Dict[str, Union[torch.Tensor, int]]


def init_decoder_state(
    cfg: TextConfig,
    batch_size: int,
    dtype: torch.dtype = torch.bfloat16,
    device: Optional[Device] = None,
    mesh=None,
) -> DecoderState:
    """Zero state; `device=None` means the CUDA card. With a `mesh`
    (parallel/sharding.Mesh) this rank's part of it."""
    device = resolve_device(device)
    S = cfg.num_swa_layers
    L = cfg.num_linear_layers
    B = batch_size
    W = cfg.conv_size
    K = cfg.linear_head_dim

    def zeros(key, *shape, dt=dtype):
        if mesh is not None:
            shape = local_state_shape(key, shape, mesh, cfg.num_attention_heads)
        return torch.zeros(shape, dtype=dt, device=device)

    state = {
        "swa_k": zeros("swa_k", S, B, cfg.num_key_value_heads, cfg.swa_capacity, cfg.head_dim),
        "swa_v": zeros("swa_v", S, B, cfg.num_key_value_heads, cfg.swa_capacity, cfg.head_dim),
        "delta_h": zeros("delta_h", L, B, cfg.num_linear_heads, K, cfg.head_v_dim,
                         dt=torch.float32),
        "conv_q": zeros("conv_q", L, B, W, cfg.num_linear_heads * K),
        "conv_k": zeros("conv_k", L, B, W, cfg.linear_key_dim),
        "conv_v": zeros("conv_v", L, B, W, cfg.linear_value_dim),
        "cum_len": 0,
    }
    M = cfg.num_mamba2_layers
    if M:
        H, Dh = cfg.num_attention_heads, cfg.head_dim
        state["mamba_conv"] = zeros("mamba_conv", M, B, W, 3 * H * Dh)
        state["mamba_h"] = zeros("mamba_h", M, B, H, Dh, Dh, dt=torch.float32)
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
