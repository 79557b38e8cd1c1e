"""Wrappers of the ring sliding-window attention kernels (A1 prefill, A2
decode) in csrc/swa_ring_flash.cu, under the names of their Pallas
counterparts in infinitevl_tpu/ops/swa_pallas.py.

A tensor on the CPU takes the kernel's plain version (ops/swa.py); a CUDA
tensor launches the kernel or raises. Each wrapper counts its launches in
its `launches` attribute."""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .swa import ring_write_stacked, swa_cached_attention

HEAD_DIM = 128  # the head dim the kernels are written for
DECODE_SPLIT = 128  # ring keys per block of the split-KV decode pass
MAX_GROUPS = 16  # query heads per KV head the decode kernel takes

_DTYPES = {torch.float32: _build.DTYPE_F32, torch.bfloat16: _build.DTYPE_BF16}


def _check_cuda(name: str, tensors: dict, dtype: torch.dtype) -> None:
    if dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {dtype} not supported (float32, bfloat16)")
    for arg, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, expected cuda")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _on_cpu(name: str, t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{name}: device {t.device} is neither cpu nor cuda")


def swa_ring_flash_attention(
    q: torch.Tensor,  # [B, T, Hq, D]
    new_k: torch.Tensor,  # [B, T, Hkv, D]
    new_v: torch.Tensor,
    ring_k: torch.Tensor,  # [B, Hkv, cap, D] head-major (one layer's ring)
    ring_v: torch.Tensor,
    cum_len: int,  # tokens in the ring before this call
    window: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Kernel A1: attention of T new queries over (ring ++ new keys) with
    the sliding-window mask. Reads the ring; does not write it. Returns
    [B, T, Hq, D] in q's dtype."""
    name = "swa_ring_flash_attention"
    if _on_cpu(name, q):
        return swa_cached_attention(
            q, new_k, new_v, ring_k, ring_v, cum_len, window, scale,
            write_ring=False,
        )
    B, T, Hq, D = q.shape
    Hkv, cap = ring_k.shape[1], ring_k.shape[2]
    _check_cuda(name, dict(q=q, new_k=new_k, new_v=new_v, ring_k=ring_k,
                           ring_v=ring_v), q.dtype)
    if D != HEAD_DIM or Hq % Hkv:
        raise ValueError(f"{name}: needs head_dim {HEAD_DIM} and Hq % Hkv == 0 "
                         f"(got D={D}, Hq={Hq}, Hkv={Hkv})")
    if new_k.shape != (B, T, Hkv, D) or new_v.shape != new_k.shape:
        raise ValueError(f"{name}: new_k/new_v shape {tuple(new_k.shape)} does "
                         f"not match q {tuple(q.shape)} and Hkv={Hkv}")
    if ring_k.shape != (B, Hkv, cap, D) or ring_v.shape != ring_k.shape:
        raise ValueError(f"{name}: ring shape {tuple(ring_k.shape)} is not "
                         f"[B, Hkv, cap, D]")
    if -(-T * (Hq // Hkv) // 32) > 65535:
        raise ValueError(f"{name}: T={T} too long for one launch; prefill in chunks")
    if scale is None:
        scale = D**-0.5
    out = torch.empty_like(q)
    lib = _build.load_library()
    with torch.cuda.device(q.device):  # launch on the tensors' card
        _build.check(
            lib.ivl_swa_prefill(
                _DTYPES[q.dtype], q.data_ptr(), new_k.data_ptr(), new_v.data_ptr(),
                ring_k.data_ptr(), ring_v.data_ptr(), out.data_ptr(),
                B, T, Hq, Hkv, D, cap, int(cum_len), int(window), float(scale),
                torch.cuda.current_stream(q.device).cuda_stream,
            ),
            name,
        )
    swa_ring_flash_attention.launches += 1
    return out


swa_ring_flash_attention.launches = 0


def swa_ring_flash_decode_stacked(
    q: torch.Tensor,  # [B, 1, Hq, D]
    new_k: torch.Tensor,  # [B, 1, Hkv, D]
    new_v: torch.Tensor,
    rings_k: torch.Tensor,  # [S, B, Hkv, cap, D] stacked rings, updated in place
    rings_v: torch.Tensor,
    layer: int,
    cum_len: int,  # tokens in the ring BEFORE this one
    window: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Kernel A2: write the token's K/V into slot cum_len % cap of layer
    `layer` of the stacked rings (IN PLACE), then attend over that ring
    alone. Requires cap >= window (the evicted token is then never
    visible). Returns [B, 1, Hq, D] in q's dtype."""
    name = "swa_ring_flash_decode_stacked"
    if _on_cpu(name, q):
        out = swa_cached_attention(
            q, new_k, new_v, rings_k[layer], rings_v[layer], cum_len, window,
            scale, write_ring=False,
        )
        ring_write_stacked(rings_k, rings_v, layer, new_k, new_v, cum_len)
        return out
    B, T, Hq, D = q.shape
    S, _, Hkv, cap, _ = rings_k.shape
    _check_cuda(name, dict(q=q, rings_k=rings_k, rings_v=rings_v), q.dtype)
    if T != 1:
        raise ValueError(f"{name}: decode takes one token (got T={T})")
    if D != HEAD_DIM or Hq % Hkv or Hq // Hkv > MAX_GROUPS:
        raise ValueError(f"{name}: needs head_dim {HEAD_DIM}, Hq % Hkv == 0 and "
                         f"Hq/Hkv <= {MAX_GROUPS} (got D={D}, Hq={Hq}, Hkv={Hkv})")
    if rings_k.shape != (S, B, Hkv, cap, D) or rings_v.shape != rings_k.shape:
        raise ValueError(f"{name}: rings shape {tuple(rings_k.shape)} is not "
                         f"[S, B, Hkv, cap, D] for B={B}")
    if new_k.shape != (B, 1, Hkv, D) or new_v.shape != new_k.shape:
        raise ValueError(f"{name}: new_k/new_v shape {tuple(new_k.shape)}")
    if cap < window:
        raise ValueError(f"{name}: ring capacity {cap} < window {window}: the "
                         "write-then-attend order would evict a visible key")
    if not 0 <= layer < S:
        raise IndexError(f"{name}: layer {layer} outside the stack of {S}")
    if scale is None:
        scale = D**-0.5
    slot = cum_len % cap
    rings_k[layer, :, :, slot] = new_k[:, 0].to(rings_k.dtype)
    rings_v[layer, :, :, slot] = new_v[:, 0].to(rings_v.dtype)
    ns = -(-cap // DECODE_SPLIT)
    part = torch.empty((B * Hkv, ns, Hq // Hkv, D + 2), dtype=torch.float32,
                       device=q.device)
    out = torch.empty_like(q)
    lib = _build.load_library()
    with torch.cuda.device(q.device):  # launch on the tensors' card
        _build.check(
            lib.ivl_swa_decode(
                _DTYPES[q.dtype], q.data_ptr(), rings_k.data_ptr(),
                rings_v.data_ptr(), part.data_ptr(), out.data_ptr(),
                B, Hq, Hkv, D, cap, int(layer), int(cum_len) + 1, int(window),
                float(scale), DECODE_SPLIT, ns,
                torch.cuda.current_stream(q.device).cuda_stream,
            ),
            name,
        )
    swa_ring_flash_decode_stacked.launches += 1
    return out


swa_ring_flash_decode_stacked.launches = 0
