"""Rotary position embeddings: 3D mRoPE for the text decoder and the 2D
RoPE of the ViT (torch port of infinitevl_tpu/ops/rope.py).

`rope_init` is numpy (it runs once, at parameter init) and mirrors the
transformers ROPE_INIT_FUNCTIONS the reference activates: default, linear,
dynamic, yarn and llama3."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def default_inv_freq(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim)


def rope_init(cfg, seq_len: int | None = None) -> Tuple[np.ndarray, float]:
    """(inv_freq, attention_scaling) for a TextConfig, honoring its rope
    scaling variant. `seq_len` only affects "dynamic" (NTK base rescale for
    a window enlarged past the original length)."""
    d = cfg.head_dim
    theta = cfg.rope_theta
    rt = cfg.rope_type
    factor = cfg.rope_factor
    base = default_inv_freq(d, theta)
    if rt == "default":
        return base, 1.0
    if rt == "linear":
        return base / factor, 1.0
    if rt == "dynamic":
        # theta' = theta * ((factor * L / L_orig) - (factor - 1)) ** (d/(d-2))
        L_orig = (
            cfg.rope_original_max_position_embeddings
            or cfg.max_position_embeddings
        )
        L = max(seq_len or cfg.max_position_embeddings, L_orig)
        new_theta = theta * ((factor * L / L_orig) - (factor - 1)) ** (d / (d - 2))
        return default_inv_freq(d, new_theta), 1.0
    if rt == "yarn":
        orig = cfg.rope_original_max_position_embeddings or (
            cfg.max_position_embeddings // max(int(factor), 1)
        )

        def find_dim(num_rot):
            return (d * np.log(orig / (num_rot * 2 * np.pi))) / (2 * np.log(theta))

        low = max(int(np.floor(find_dim(cfg.rope_beta_fast))), 0)
        high = min(int(np.ceil(find_dim(cfg.rope_beta_slow))), d - 1)
        # linear ramp over rotary dims: 0 keeps the base frequency
        # (extrapolate), 1 takes base / factor (interpolate)
        ramp = (np.arange(d // 2, dtype=np.float64) - low) / max(high - low, 1e-3)
        ramp = np.clip(ramp, 0.0, 1.0)
        inv_freq = (base / factor) * ramp + base * (1 - ramp)
        return inv_freq, 0.1 * float(np.log(factor)) + 1.0
    if rt == "llama3":
        orig = cfg.rope_original_max_position_embeddings or 8192
        low_f, high_f = cfg.rope_low_freq_factor, cfg.rope_high_freq_factor
        low_wl = orig / low_f
        high_wl = orig / high_f
        wavelen = 2 * np.pi / base
        inv_llama = np.where(wavelen > low_wl, base / factor, base)
        smooth = (orig / wavelen - low_f) / (high_f - low_f)
        smoothed = (1 - smooth) * inv_llama / factor + smooth * inv_llama
        is_mid = (wavelen >= high_wl) & (wavelen <= low_wl)
        return np.where(is_mid, smoothed, inv_llama), 1.0
    raise ValueError(
        f"unknown rope_type {rt!r} (default | linear | dynamic | yarn | llama3)"
    )


def mrope_axis_index(head_dim: int, mrope_section: Tuple[int, ...]) -> np.ndarray:
    """For each channel of the full (duplicated) head_dim, which of the 3
    position axes (t/h/w) supplies its cos/sin: chunk i of the sections
    repeated twice comes from axis i % 3."""
    sections = list(mrope_section) * 2
    if sum(sections) != head_dim:
        raise ValueError(f"mrope sections {sections} do not sum to {head_dim}")
    return np.concatenate(
        [np.full(s, i % 3, dtype=np.int64) for i, s in enumerate(sections)]
    )


def mrope_cos_sin(
    position_ids: torch.Tensor,  # [3, B, T] (t/h/w rows)
    inv_freq: torch.Tensor,  # [head_dim // 2]
    mrope_section: Tuple[int, ...],
    attention_scaling: float = 1.0,
    dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each [B, T, head_dim], with the 3-axis interleaved section
    layout applied, so downstream use is plain rotate-half. Channel c takes
    axis mrope_axis_index(...)[c]; the runs of equal axis are sliced
    directly, so no index array is copied to the device (a pageable
    host-to-device copy would synchronise every decode step)."""
    pos = position_ids.float()
    freqs = pos[..., None] * inv_freq.float()  # [3, B, T, hd/2]
    emb = torch.cat([freqs, freqs], dim=-1)  # [3, B, T, hd]
    sections = list(mrope_section) * 2
    if sum(sections) != emb.shape[-1]:
        raise ValueError(f"mrope sections {sections} do not sum to {emb.shape[-1]}")
    parts, start = [], 0
    for i, n in enumerate(sections):
        parts.append(emb[i % 3, ..., start : start + n])
        start += n
    emb_sel = torch.cat(parts, dim=-1)  # [B, T, hd]
    cos = torch.cos(emb_sel) * attention_scaling
    sin = torch.sin(emb_sel) * attention_scaling
    return cos.to(dtype), sin.to(dtype)


def apply_rotary(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # [B, T, Hkv, D]
    cos: torch.Tensor,  # [B, T, D]
    sin: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    q_out = q * c + rotate_half(q) * s
    k_out = k * c + rotate_half(k) * s
    return q_out.to(q.dtype), k_out.to(k.dtype)


# ---------------------------------------------------------------------------
# Vision 2D RoPE
# ---------------------------------------------------------------------------


def vision_rot_pos_ids(
    grid_thw: Sequence[Tuple[int, int, int]], spatial_merge_size: int
) -> np.ndarray:
    """Per-patch (h, w) position ids in merger-aware order, [S, 2]. Numpy:
    grid shapes are fixed per bucket, so this runs once per shape (the
    permutation of reference modeling_infinitevl.py:741-768)."""
    m = spatial_merge_size
    out = []
    for t, h, w in grid_thw:
        hpos = np.arange(h)[:, None].repeat(w, axis=1)
        hpos = hpos.reshape(h // m, m, w // m, m).transpose(0, 2, 1, 3).reshape(-1)
        wpos = np.arange(w)[None, :].repeat(h, axis=0)
        wpos = wpos.reshape(h // m, m, w // m, m).transpose(0, 2, 1, 3).reshape(-1)
        ids = np.stack([hpos, wpos], axis=-1)
        out.append(np.tile(ids, (t, 1)))
    return np.concatenate(out, axis=0)


def vision_cos_sin(
    pos_ids: np.ndarray,  # [S, 2] (h, w)
    head_dim: int,
    theta: float = 10000.0,
    dtype=np.float32,
) -> Tuple[np.ndarray, np.ndarray]:
    """cos/sin of shape [S, head_dim] (numpy): freqs for the (h, w) axes
    concatenated, then duplicated (reference modeling_infinitevl.py:823,
    838-841)."""
    inv_freq = default_inv_freq(head_dim // 2, theta)  # [head_dim/4]
    freqs = pos_ids[..., None].astype(np.float64) * inv_freq  # [S, 2, hd/4]
    freqs = freqs.reshape(freqs.shape[0], -1)  # [S, hd/2]
    emb = np.concatenate([freqs, freqs], axis=-1)  # [S, hd]
    return np.cos(emb).astype(dtype), np.sin(emb).astype(dtype)


def apply_rotary_vision(
    q: torch.Tensor,  # [S, H, D]
    k: torch.Tensor,  # [S, H, D]
    cos: torch.Tensor,  # [S, D]
    sin: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 rotation, cast back (reference modeling_infinitevl.py:528-542)."""
    qf, kf = q.float(), k.float()
    c = cos[:, None, :].float()
    s = sin[:, None, :].float()
    q_out = qf * c + rotate_half(qf) * s
    k_out = kf * c + rotate_half(kf) * s
    return q_out.to(q.dtype), k_out.to(k.dtype)
