"""Sliding-window attention over a circular ring KV buffer; torch port of
infinitevl_tpu/ops/swa.py (dense paths). These functions are the plain
versions of the Hopper kernels in ops/swa_kernels.py.

Ring invariant: slot s holds token n = the largest n < cum_len with
n % cap == s (valid iff n >= 0). Slot positions are recomputed from
`cum_len` (a host int). A query at position p attends keys in
[p - W + 1, p].

Ring writes are in place on the given buffers."""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = torch.finfo(torch.float32).min


def ring_slot_positions(
    cum_len: int, capacity: int, device=None
) -> torch.Tensor:
    """Absolute token position held by each ring slot; -1 if empty."""
    slots = torch.arange(capacity, dtype=torch.int64, device=device)
    m = (cum_len - 1) % capacity
    pos = cum_len - 1 - torch.remainder(m - slots, capacity)
    return torch.where(pos >= 0, pos, -1)


def ring_write(
    ring_k: torch.Tensor,  # [B, Hkv, cap, D] head-major, updated in place
    ring_v: torch.Tensor,
    new_k: torch.Tensor,  # [B, T, Hkv, D]
    new_v: torch.Tensor,
    cum_len: int,  # tokens written before this call
) -> None:
    """Write T new tokens into their ring slots (position mod capacity),
    in place. When T > cap only the last cap tokens can survive; they are
    the only ones written, so every slot index is written once (a scatter
    with repeated indices has no defined order on CUDA)."""
    cap = ring_k.shape[2]
    T = new_k.shape[1]
    n = min(T, cap)
    idx = torch.remainder(
        torch.arange(cum_len + T - n, cum_len + T, device=ring_k.device), cap
    )
    ring_k[:, :, idx] = new_k[:, T - n :].transpose(1, 2).to(ring_k.dtype)
    ring_v[:, :, idx] = new_v[:, T - n :].transpose(1, 2).to(ring_v.dtype)


def ring_write_stacked(
    rings_k: torch.Tensor,  # [S, B, Hkv, cap, D] stacked rings, updated in place
    rings_v: torch.Tensor,
    layer: int,
    new_k: torch.Tensor,  # [B, T, Hkv, D]
    new_v: torch.Tensor,
    cum_len: int,
) -> None:
    """ring_write into layer `layer` of the stacked rings, in place."""
    ring_write(rings_k[layer], rings_v[layer], new_k, new_v, cum_len)


def attention_dense(
    q: torch.Tensor,  # [B, Tq, Hq, D]
    k: torch.Tensor,  # [B, Tk, Hkv, D]
    v: torch.Tensor,  # [B, Tk, Hkv, D]
    mask: torch.Tensor,  # [B or 1, Tq, Tk] bool (True = attend)
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Masked dense GQA attention with fp32 softmax. [B, Tq, Hq, D] out."""
    B, Tq, Hq, D = q.shape
    Hkv = k.shape[2]
    groups = Hq // Hkv
    if scale is None:
        scale = D**-0.5
    qg = q.reshape(B, Tq, Hkv, groups, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    logits = logits.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(B, Tq, Hq, D)


def sliding_window_mask(
    q_pos: torch.Tensor,  # [Tq] absolute positions of queries
    k_pos: torch.Tensor,  # [Tk] absolute positions of keys (-1 = invalid)
    window: int,
) -> torch.Tensor:
    """[Tq, Tk] bool: causal AND within the last `window` tokens."""
    qp = q_pos[:, None]
    kp = k_pos[None, :]
    return (kp >= 0) & (kp <= qp) & (kp > qp - window)


def swa_prefill_dense(
    q: torch.Tensor,  # [B, T, Hq, D], positions = offset + arange(T)
    k: torch.Tensor,
    v: torch.Tensor,
    window: int,
    offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Cache-less banded attention (stateless forward)."""
    T = q.shape[1]
    pos = torch.arange(T, device=q.device) + offset
    mask = sliding_window_mask(pos, pos, window)[None]
    return attention_dense(q, k, v, mask, scale)


def swa_cached_attention(
    q: torch.Tensor,  # [B, T, Hq, D] current-step queries
    new_k: torch.Tensor,  # [B, T, Hkv, D] current-step keys (post-RoPE)
    new_v: torch.Tensor,
    ring_k: torch.Tensor,  # [B, Hkv, cap, D] head-major
    ring_v: torch.Tensor,
    cum_len: int,  # tokens seen before this call
    window: int,
    scale: Optional[float] = None,
    write_ring: bool = True,
) -> torch.Tensor:
    """Attend over (ring ++ new) with the sliding-window mask, then (when
    `write_ring`) write the new tokens into the ring IN PLACE. Returns the
    output [B, T, Hq, D]."""
    T = q.shape[1]
    cap = ring_k.shape[2]
    dev = q.device
    q_pos = cum_len + torch.arange(T, device=dev)
    k_pos = torch.cat([ring_slot_positions(cum_len, cap, dev), q_pos])
    k_all = torch.cat([ring_k.transpose(1, 2), new_k.to(ring_k.dtype)], dim=1)
    v_all = torch.cat([ring_v.transpose(1, 2), new_v.to(ring_v.dtype)], dim=1)
    mask = sliding_window_mask(q_pos, k_pos, window)[None]
    out = attention_dense(q, k_all.to(q.dtype), v_all.to(q.dtype), mask, scale)
    if write_ring:
        ring_write(ring_k, ring_v, new_k, new_v, cum_len)
    return out
