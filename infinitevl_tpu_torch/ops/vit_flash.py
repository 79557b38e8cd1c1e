"""Segment-masked non-causal attention over the packed ViT sequence (torch
port of infinitevl_tpu/ops/vit_flash.py without the backward and without
the window variant, kernel F).

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

NEG_INF = -1e30


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
    on the CPU. Softmax in fp32; probabilities are cast to v's dtype for
    the value product, as in the kernel. Returns [S, H, D] in q's dtype."""
    S, H, D = q.shape
    if scale is None:
        scale = D**-0.5
    kf = k.float()
    out = torch.empty_like(q)
    for s0 in range(0, S, block_q):
        qi = q[s0 : s0 + block_q].float() * scale
        logits = torch.einsum("qhd,khd->hqk", qi, kf)
        mask = seg[s0 : s0 + block_q, None] == seg[None, :]
        logits = logits.masked_fill(~mask[None], NEG_INF)
        p = torch.softmax(logits, dim=-1)
        out[s0 : s0 + block_q] = torch.einsum("hqk,khd->qhd", p.to(v.dtype), v).to(q.dtype)
    return out


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
