"""Wrappers of the ViT flash attention kernels in csrc/vit_flash.cu, under
the names of their Pallas counterparts in infinitevl_tpu/ops/vit_flash.py:
E, `segment_flash_attention` (full-attention blocks), and F,
`window_flash_attention` (window blocks: E's body on diagonal blocks).

A tensor on the CPU takes the plain version
(ops/vit_flash.attention_segment_chunked, window_attention_reference); a
CUDA tensor launches the kernel or raises. Launches are counted in each
wrapper's `launches`. Both carry gradients: the forward is the kernel, the
backward differentiates the plain version (as the JAX package's custom
VJPs do; neither side has a backward kernel for them).

`vit_warpgroups` chooses the bf16 kernel's consumer warpgroups a block
(64 query rows each), which the wrapper passes to the kernel.
`vit_tile_walk` is the plain twin of the kernel's walk over key tiles
(which tiles a block of 64, 128 or 192 query rows visits, and which of them
it takes whole, skips or masks per element), for tests and for reports."""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import torch

from . import _build
from .vit_flash import (
    attention_segment_chunked,
    window_attention_chunked,
    window_attention_reference,
)

HEAD_DIM = 80  # the head dim the kernel is written for
TILE = 64  # query rows of a block and keys of a tile (bf16 kernel)

_DTYPES = {torch.float32: _build.DTYPE_F32, torch.bfloat16: _build.DTYPE_BF16}


def _tma_ready(t: torch.Tensor) -> bool:
    """A token's [H, D] dense, tokens apart by at least that and by a
    multiple of 16 bytes, the base on 16 bytes: what the kernel's TMA maps
    take."""
    S, H, D = t.shape
    return (t.stride(2) == 1 and t.stride(1) == D and t.stride(0) >= H * D
            and t.stride(0) * t.element_size() % 16 == 0 and t.data_ptr() % 16 == 0)


def tma_operand(t: torch.Tensor) -> torch.Tensor:
    """`t` [S, H, D] itself where the TMA maps can read it where it lies (v
    usually arrives as a slice of the [S, 3, H, D] projection), else a
    dense copy. Raises if the copy does not qualify either."""
    if _tma_ready(t):
        return t
    t = t.contiguous()
    if not _tma_ready(t):  # dense but off a 16-byte boundary
        t = t.clone()
    if not _tma_ready(t):
        raise ValueError(f"tensor of shape {tuple(t.shape)}, strides {t.stride()} cannot be "
                         f"laid out for the kernel's TMA maps")
    return t


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
    q, k, v = (tma_operand(t) for t in (q, k, v))
    seg = seg.contiguous()
    cwg = vit_warpgroups(S, H, win_len, sm_count(q.device.index))
    out = torch.empty((S, H, D), dtype=q.dtype, device=q.device)
    lib = _build.load_library()
    with torch.cuda.device(q.device):  # launch on the tensors' card
        _build.check(
            lib.ivl_vit_flash(
                _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                seg.data_ptr(), out.data_ptr(), S, H, D,
                q.stride(0), k.stride(0), v.stride(0), float(scale), int(win_len), cwg,
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


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA card `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def vit_warpgroups(S: int, H: int, win_len: int, sms: int) -> int:
    """Consumer warpgroups of one block of the bf16 kernel, each owning TILE
    query rows, on a card of `sms` SMs. E takes 3 (one load of a key tile
    serves 192 rows) where that still gives two blocks an SM, else 2. F
    takes 2 where a window holds 16 key tiles or more and a block's 128 rows
    lie in one window (win_len a multiple of 2 TILE, >= 1,024), else 1: the
    walk over K/V from L2 bounds a block of one warpgroup, and more rows a
    load pay off only where the walk is long (PERF.md section 6)."""
    if win_len > 0:
        return 2 if win_len % (2 * TILE) == 0 and win_len >= 1024 else 1
    return 3 if -(-S // (3 * TILE)) * H >= 2 * sms else 2


def vit_tile_walk(seg: torch.Tensor, win_len: int = 0,
                  rows: int = TILE) -> List[List[Tuple[int, str]]]:
    """The plain twin of the bf16 kernel's walk (csrc/vit_flash.cu,
    VitSrc): for each block of `rows` query rows (TILE per consumer
    warpgroup, `vit_warpgroups`), the key tiles of TILE keys it visits as
    (first key, kind), kind "whole" (every pair visible: no per-element
    mask), "skip" (no pair visible: never loaded) or "mask" (per element).
    E is win_len 0, F win_len > 0. A block visits the windows its rows lie
    in (every key for E), from the first key of its first window in steps
    of TILE. Where those steps line up with the windows (E; F at a win_len
    that is a multiple of TILE) each tile's interval of segment ids over
    its real keys is tested against the interval over the block's real
    rows: disjoint is "skip"; one and the same id over full tiles of keys
    and rows is "whole" where the rows lie in one window (E; F at a win_len
    that is a multiple of `rows`); otherwise "mask"."""
    seg = torch.as_tensor(seg).to("cpu", torch.int64).reshape(-1)
    S = seg.numel()
    n_tiles = -(-S // TILE)
    pad = n_tiles * TILE - S
    big = torch.iinfo(torch.int64).max
    lo = torch.nn.functional.pad(seg, (0, pad), value=big).reshape(n_tiles, TILE).amin(1).tolist()
    hi = torch.nn.functional.pad(seg, (0, pad), value=-big).reshape(n_tiles, TILE).amax(1).tolist()
    ranged = win_len % TILE == 0
    walk = []
    for q0 in range(0, S, rows):
        last = min(q0 + rows, S) - 1
        if win_len > 0:
            kb, kend = q0 // win_len * win_len, min(S, (last // win_len + 1) * win_len)
        else:
            kb, kend = 0, S
        r_lo, r_hi = int(seg[q0 : last + 1].min()), int(seg[q0 : last + 1].max())
        tiles = []
        for k0 in range(kb, kend, TILE):
            t, kind = k0 // TILE, "mask"
            if ranged and (hi[t] < r_lo or lo[t] > r_hi):
                kind = "skip"
            elif (win_len % rows == 0 and q0 + rows <= S and k0 + TILE <= S
                  and r_lo == r_hi == lo[t] == hi[t]):
                kind = "whole"
            tiles.append((k0, kind))
        walk.append(tiles)
    return walk
