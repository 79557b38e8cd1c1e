"""Depthwise causal short convolution (kernel size ~4) with SiLU; torch port
of infinitevl_tpu/ops/short_conv.py.

State layout: [B, W, D] (time-major, slot W-1 = most recent raw input).

Reference semantics kept exactly: the multi-token path convolves the
current inputs with ZERO left padding and does not read the cached history
(`carry_history=False`, the reference's quirk that token parity depends
on); the new state is the last W raw inputs of (state ++ inputs); the
single-step path shifts the history and convolves over it. Packed
`segment_ids` are not ported yet and raise."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .norms import silu


def _no_segments(segment_ids) -> None:
    if segment_ids is not None:
        raise NotImplementedError(
            "segment_ids (packed sequences) are not ported to the torch "
            "short conv yet; they come with the training slice"
        )


def causal_conv1d(
    x: torch.Tensor,  # [B, T, D]
    weight: torch.Tensor,  # [W, D] time-major taps; tap W-1 hits the current token
    bias: Optional[torch.Tensor] = None,  # [D]
    activation: str = "silu",
    initial_state: Optional[torch.Tensor] = None,  # [B, W, D] left context
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """y[t] = sum_i w[i] * x[t - (W-1-i)], zero-padded (or padded with the
    tail of `initial_state`), accumulated in fp32."""
    _no_segments(segment_ids)
    B, T, D = x.shape
    W = weight.shape[0]
    if initial_state is not None:
        left = initial_state[:, 1:, :].to(x.dtype)
    else:
        left = x.new_zeros((B, W - 1, D))
    xp = torch.cat([left, x], dim=1)  # [B, T + W - 1, D]
    acc = torch.zeros((B, T, D), dtype=torch.float32, device=x.device)
    for i in range(W):
        acc = acc + xp[:, i : i + T, :].float() * weight[i].float()
    if bias is not None:
        acc = acc + bias.float()
    if activation in ("silu", "swish"):
        acc = silu(acc)
    elif activation is not None and activation != "none":
        raise ValueError(f"unsupported activation {activation!r}")
    return acc.to(x.dtype)


def conv_state_update(
    state: torch.Tensor,  # [B, W, D] previous raw-input history
    x: torch.Tensor,  # [B, T, D] new raw inputs
) -> torch.Tensor:
    """New state = last W entries of concat(state, x) along time."""
    W = state.shape[1]
    T = x.shape[1]
    if T >= W:
        return x[:, T - W :, :]
    return torch.cat([state[:, T:, :], x.to(state.dtype)], dim=1)


def short_conv(
    x: torch.Tensor,  # [B, T, D] raw projections
    weight: torch.Tensor,  # [W, D]
    bias: Optional[torch.Tensor],
    state: Optional[torch.Tensor],  # [B, W, D] or None
    activation: str = "silu",
    carry_history: bool = False,
    segment_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Multi-token short convolution, returning (output, new_state); the
    new state is None when `state` is None (stateless use)."""
    init = state if (carry_history and state is not None) else None
    y = causal_conv1d(x, weight, bias, activation, initial_state=init,
                      segment_ids=segment_ids)
    new_state = conv_state_update(state, x) if state is not None else None
    return y, new_state


def short_conv_step(
    x: torch.Tensor,  # [B, D] single token
    weight: torch.Tensor,  # [W, D]
    bias: Optional[torch.Tensor],
    state: torch.Tensor,  # [B, W, D]
    activation: str = "silu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token decode step: shift history, convolve over it. Returns
    (y [B, D], new_state)."""
    new_state = torch.cat([state[:, 1:, :], x[:, None, :].to(state.dtype)], dim=1)
    y = (new_state.float() * weight.float()[None]).sum(dim=1)
    if bias is not None:
        y = y + bias.float()
    if activation in ("silu", "swish"):
        y = silu(y)
    return y.to(x.dtype), new_state
