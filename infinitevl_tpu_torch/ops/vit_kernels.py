"""Wrapper of the ViT segment flash attention kernel (E) in
csrc/vit_flash.cu, under the name of its Pallas counterpart in
infinitevl_tpu/ops/vit_flash.py.

A tensor on the CPU takes the plain version
(ops/vit_flash.attention_segment_chunked); a CUDA tensor launches the
kernel or raises. Launches are counted in
`segment_flash_attention.launches`."""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .vit_flash import attention_segment_chunked

HEAD_DIM = 80  # the head dim the kernel is written for

_DTYPES = {torch.float32: _build.DTYPE_F32, torch.bfloat16: _build.DTYPE_BF16}


def segment_flash_attention(
    q: torch.Tensor,  # [S, H, D] packed sequence (ViT layout)
    k: torch.Tensor,
    v: torch.Tensor,
    seg: torch.Tensor,  # [S] int32 segment ids; pads -1
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Kernel E: non-causal attention in which a query sees the keys of its
    own segment. Returns [S, H, D] in q's dtype."""
    name = "segment_flash_attention"
    if q.device.type == "cpu":
        return attention_segment_chunked(q, k, v, seg, scale)
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
                q.stride(0), k.stride(0), v.stride(0), float(scale),
                torch.cuda.current_stream(q.device).cuda_stream,
            ),
            name,
        )
    segment_flash_attention.launches += 1
    return out


segment_flash_attention.launches = 0
