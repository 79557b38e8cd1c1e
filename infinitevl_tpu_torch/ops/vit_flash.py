"""Segment-masked non-causal attention over the packed ViT sequence (torch
port of infinitevl_tpu/ops/vit_flash.py): the plain versions of kernel E
(full-attention blocks) and kernel F (window blocks) and the model's two
entries, `vit_full_attention` and `vit_window_attention`.

The full-attention blocks of the vision trunk attend within each image /
temporal frame of the packed sequence. A dense pass materializes the
[H, S, S] score tensor (5.4 GB fp32 for one 1344x1344 image: S = 9216, 16
heads); `attention_segment_chunked` bounds it to [H, block_q, S] per query
chunk, and is the plain version of the Hopper kernel
`ops/vit_kernels.segment_flash_attention` (E), which streams key tiles
through an online softmax. `vit_full_attention` is the model's entry.

Pad tokens carry segment -1: they attend only other pads (finite rows,
dropped by the caller's inverse permutation), never real tokens."""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from .swa import attention_dense

NEG_INF = -1e30
# fp32 score values that one group of `window_attention_chunked` may hold
# (256 MB): the backward recomputes one group at a time
WINDOW_SCORE_BUDGET = 1 << 26


def _segment_chunk(qi, k, v, seg_q, seg, scale):
    """One query chunk of `attention_segment_chunked`."""
    logits = torch.einsum("qhd,khd->hqk", qi.float() * scale, k.float())
    mask = seg_q[:, None] == seg[None, :]
    logits = logits.masked_fill(~mask[None], NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("hqk,khd->qhd", p.to(v.dtype), v).to(qi.dtype)


def attention_segment_chunked(
    q: torch.Tensor,  # [S, H, D]
    k: torch.Tensor,
    v: torch.Tensor,
    seg: torch.Tensor,  # [S] integer segment ids; pads -1
    scale: Optional[float] = None,
    block_q: int = 256,
) -> torch.Tensor:
    """Exact attention with query chunking: scores exist only as
    [H, block_q, S] fp32 per chunk, so it runs at S = 9216 on the card and
    on the CPU. Under autograd every chunk is checkpointed (its scores are
    recomputed in the backward), so only one chunk's scores are alive in
    the backward too: the differentiable twin of kernel E. Softmax in fp32;
    probabilities are cast to v's dtype for the value product, as in the
    kernel. Returns [S, H, D] in q's dtype."""
    S, H, D = q.shape
    if scale is None:
        scale = D**-0.5
    track = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                         or v.requires_grad)
    outs = []
    for s0 in range(0, S, block_q):
        args = (q[s0 : s0 + block_q], k, v, seg[s0 : s0 + block_q], seg, scale)
        if track:
            outs.append(checkpoint(_segment_chunk, *args, use_reentrant=False))
        else:
            outs.append(_segment_chunk(*args))
    return torch.cat(outs, dim=0)


def window_attention_reference(
    q: torch.Tensor,  # [S, H, D] window order, S = nW * win_len
    k: torch.Tensor,
    v: torch.Tensor,
    seg: torch.Tensor,  # [S] integer window ids (pads -2-w)
    win_len: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Batched dense attention over [nW, win_len] with the segment mask:
    the plain version of kernel F. Scores live as [nW, H, L, L] fp32;
    `window_attention_chunked` is its twin for gradients."""
    S, H, D = q.shape
    if S % win_len:
        raise ValueError(f"sequence length {S} is not a multiple of win_len {win_len}")
    nW = S // win_len
    sw = seg.reshape(nW, win_len)
    mask = sw[:, :, None] == sw[:, None, :]
    out = attention_dense(
        q.reshape(nW, win_len, H, D), k.reshape(nW, win_len, H, D),
        v.reshape(nW, win_len, H, D), mask, scale=scale,
    )
    return out.reshape(S, H, D)


def _window_group(q, k, v, seg, win_len, scale):
    """Whole windows of `window_attention_chunked`: [n * win_len, H, D]."""
    S, H, D = q.shape
    sw = seg.reshape(-1, win_len)
    out = attention_dense(
        q.reshape(-1, win_len, H, D), k.reshape(-1, win_len, H, D),
        v.reshape(-1, win_len, H, D), sw[:, :, None] == sw[:, None, :], scale=scale)
    return out.reshape(S, H, D)


def window_attention_chunked(
    q: torch.Tensor,  # [S, H, D] window order, S = nW * win_len
    k: torch.Tensor,
    v: torch.Tensor,
    seg: torch.Tensor,  # [S] integer window ids (pads -2-w)
    win_len: int,
    scale: Optional[float] = None,
    budget: int = WINDOW_SCORE_BUDGET,
) -> torch.Tensor:
    """`window_attention_reference` in groups of whole windows whose
    [n, H, L, L] fp32 scores stay under `budget` values; a window whose own
    scores exceed it is taken alone with its queries chunked
    (`attention_segment_chunked` over the window). Under autograd every
    group and query chunk is checkpointed, so the backward holds one
    group's scores at a time: the differentiable twin of kernel F. When one
    group holds every window it is the plain version itself (nothing to
    recompute)."""
    S, H, D = q.shape
    if S % win_len:
        raise ValueError(f"sequence length {S} is not a multiple of win_len {win_len}")
    track = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                         or v.requires_grad)
    per_window = H * win_len * win_len
    outs = []
    if per_window > budget:
        block_q = max(1, budget // (H * win_len))
        for s0 in range(0, S, win_len):
            w = slice(s0, s0 + win_len)
            outs.append(attention_segment_chunked(q[w], k[w], v[w], seg[w], scale, block_q))
        return torch.cat(outs, dim=0)
    step = win_len * (budget // per_window)
    if step >= S:
        return _window_group(q, k, v, seg, win_len, scale)
    for s0 in range(0, S, step):
        g = slice(s0, s0 + step)
        args = (q[g], k[g], v[g], seg[g], win_len, scale)
        outs.append(checkpoint(_window_group, *args, use_reentrant=False) if track
                    else _window_group(*args))
    return torch.cat(outs, dim=0)


def vit_full_attention(
    q: torch.Tensor,  # [S, H, D]
    k: torch.Tensor,
    v: torch.Tensor,
    seg: torch.Tensor,  # [S] int32, pads -1
    scale: Optional[float] = None,
) -> torch.Tensor:
    """ViT full-attention blocks over long packed sequences: kernel E's
    wrapper (the flash kernel on a CUDA tensor, its plain version on a CPU
    tensor), so no [S, S] score tensor exists either way."""
    from .vit_kernels import segment_flash_attention  # imports this module

    return segment_flash_attention(q, k, v, seg, scale)


def vit_window_attention(
    q: torch.Tensor,  # [S, H, D] window order
    k: torch.Tensor,
    v: torch.Tensor,
    seg: torch.Tensor,  # [S] int32 window ids (pads -2-w)
    win_len: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """ViT window-attention blocks: kernel F's wrapper (the diagonal-block
    flash kernel on a CUDA tensor, the batched-dense plain version on a CPU
    tensor)."""
    from .vit_kernels import window_flash_attention  # imports this module

    return window_flash_attention(q, k, v, seg, win_len, scale)
