"""Wrappers of the ViT flash attention kernels in csrc/vit_flash.cu, under
the names of their Pallas counterparts in infinitevl_tpu/ops/vit_flash.py:
E, `segment_flash_attention` (full-attention blocks), and F,
`window_flash_attention` (window blocks: E's body on diagonal blocks).

A tensor on the CPU takes the plain version
(ops/vit_flash.attention_segment_chunked, window_attention_reference); a
CUDA tensor launches the kernel or raises. Launches are counted in each
wrapper's `launches`. Both carry gradients: the forward is the kernel, the
backward differentiates the plain version (as the JAX package's custom
VJPs do; neither side has a backward kernel for them)."""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .vit_flash import (
    attention_segment_chunked,
    window_attention_chunked,
    window_attention_reference,
)

HEAD_DIM = 80  # the head dim the kernel is written for

_DTYPES = {torch.float32: _build.DTYPE_F32, torch.bfloat16: _build.DTYPE_BF16}


def _launch(name, q, k, v, seg, scale, win_len) -> torch.Tensor:
    """Check the operands and launch the kernel (win_len 0: E; > 0: F)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: device {q.device} is neither cpu nor cuda")
    S, H, D = q.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {q.dtype} not supported (float32, bfloat16)")
    if D != HEAD_DIM:
        raise ValueError(f"{name}: head dim {D}, the kernel takes {HEAD_DIM}")
    for arg, t in dict(k=k, v=v).items():
        if t.device != q.device or t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(
                f"{name}: {arg} ({tuple(t.shape)}, {t.dtype}, {t.device}) does not "
                f"match q ({tuple(q.shape)}, {q.dtype}, {q.device})"
            )
    if seg.device != q.device or seg.dtype != torch.int32 or seg.shape != (S,):
        raise ValueError(f"{name}: seg must be int32 [{S}] on {q.device} "
                         f"(got {seg.dtype} {tuple(seg.shape)} on {seg.device})")
    if scale is None:
        scale = D**-0.5
    # a token's [H, D] must be dense; the stride between tokens is free (v
    # usually arrives as a slice of the [S, 3, H, D] projection) as long as
    # the kernel's 16-byte loads stay aligned
    per = 16 // q.element_size()
    q, k, v = (
        t if t.stride(2) == 1 and t.stride(1) == D and t.stride(0) % per == 0
        and t.data_ptr() % 16 == 0 else t.contiguous()
        for t in (q, k, v)
    )
    seg = seg.contiguous()
    out = torch.empty((S, H, D), dtype=q.dtype, device=q.device)
    lib = _build.load_library()
    with torch.cuda.device(q.device):  # launch on the tensors' card
        _build.check(
            lib.ivl_vit_flash(
                _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                seg.data_ptr(), out.data_ptr(), S, H, D,
                q.stride(0), k.stride(0), v.stride(0), float(scale), int(win_len),
                torch.cuda.current_stream(q.device).cuda_stream,
            ),
            name,
        )
    return out


class _VitFlashFn(torch.autograd.Function):
    """Kernel E or F with a gradient: the forward launches the kernel, the
    backward recomputes the checkpointed twin of the plain version under
    autograd (E: query chunks; F: groups of windows), so no [nW, H, L, L]
    or [H, S, S] score tensor exists."""

    @staticmethod
    def forward(ctx, q, k, v, seg, scale, win_len, wrapper):
        ctx.save_for_backward(q, k, v, seg)
        ctx.scale, ctx.win_len = scale, win_len
        out = _launch(wrapper.__name__, q, k, v, seg, scale, win_len)
        wrapper.launches += 1
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, seg = ctx.saved_tensors
        with torch.enable_grad():
            ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
            if ctx.win_len:
                out = window_attention_chunked(ql, kl, vl, seg, ctx.win_len, ctx.scale)
            else:
                out = attention_segment_chunked(ql, kl, vl, seg, ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, (ql, kl, vl), d_out)
        return dq, dk, dv, None, None, None, None


def _dispatch(wrapper, q, k, v, seg, scale, win_len) -> torch.Tensor:
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _VitFlashFn.apply(q, k, v, seg, scale, win_len, wrapper)
    out = _launch(wrapper.__name__, q, k, v, seg, scale, win_len)
    wrapper.launches += 1
    return out


def segment_flash_attention(
    q: torch.Tensor,  # [S, H, D] packed sequence (ViT layout)
    k: torch.Tensor,
    v: torch.Tensor,
    seg: torch.Tensor,  # [S] int32 segment ids; pads -1
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Kernel E: non-causal attention in which a query sees the keys of its
    own segment. Returns [S, H, D] in q's dtype."""
    if q.device.type == "cpu":
        return attention_segment_chunked(q, k, v, seg, scale)
    return _dispatch(segment_flash_attention, q, k, v, seg, scale, 0)


segment_flash_attention.launches = 0


def window_flash_attention(
    q: torch.Tensor,  # [S, H, D] window-ordered packed sequence
    k: torch.Tensor,
    v: torch.Tensor,
    seg: torch.Tensor,  # [S] int32 window ids (pads -2-w), windows contiguous
    win_len: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Kernel F: window attention over the window-ordered layout. Window w
    is the run of `win_len` tokens starting at w * win_len; a query sees
    the keys of its window that share its segment id. S must be a multiple
    of win_len; any win_len >= 1 is taken. Returns [S, H, D] in q's dtype."""
    name = "window_flash_attention"
    if win_len < 1 or q.shape[0] % win_len:
        raise ValueError(f"{name}: sequence length {q.shape[0]} is not a positive "
                         f"multiple of win_len {win_len}")
    if q.device.type == "cpu":
        return window_attention_reference(q, k, v, seg, win_len, scale)
    return _dispatch(window_flash_attention, q, k, v, seg, scale, int(win_len))


window_flash_attention.launches = 0
