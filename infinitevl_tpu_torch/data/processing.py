"""Frame preprocessing for the vision encoder: CLIP normalization and the
merger-aware patch flattening whose layout the checkpoint's patch embed
expects (the port's copy of `normalize` / `patchify` and the torch twin of
`patchify_device` from infinitevl_tpu/data/processing.py; resizing, the
tokenizer-side processor and frame sampling are not ported).

`patchify` is numpy on the host. `patchify_device` does normalize +
patchify in torch on the frames' device, so the streaming engine ships raw
uint8 frames (3 bytes per pixel) to the card."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def normalize(img: np.ndarray) -> np.ndarray:
    """uint8 [T, H, W, C] -> CLIP-normalized float32."""
    x = img.astype(np.float32) / 255.0
    mean = np.asarray(OPENAI_CLIP_MEAN, np.float32)
    std = np.asarray(OPENAI_CLIP_STD, np.float32)
    return (x - mean) / std


def patchify(
    frames: np.ndarray,  # [T, H, W, C] normalized float
    patch_size: int = 14,
    temporal_patch_size: int = 2,
    merge_size: int = 2,
) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """Flatten frames into [grid_t*grid_h*grid_w, C*tps*ps*ps], transpose
    order (t, h_block, w_block, h_merge, w_merge, C, tps, ph, pw). A frame
    count that is not a multiple of temporal_patch_size repeats the last
    frame. Returns (patches, (grid_t, grid_h, grid_w))."""
    T, H, W, C = frames.shape
    x = frames.transpose(0, 3, 1, 2)  # [T, C, H, W]
    if T % temporal_patch_size:
        reps = temporal_patch_size - T % temporal_patch_size
        x = np.concatenate([x, np.repeat(x[-1:], reps, axis=0)], axis=0)
    grid_t = x.shape[0] // temporal_patch_size
    grid_h, grid_w = H // patch_size, W // patch_size
    m, ps, tps = merge_size, patch_size, temporal_patch_size
    x = x.reshape(grid_t, tps, C, grid_h // m, m, ps, grid_w // m, m, ps)
    x = x.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    flat = x.reshape(grid_t * grid_h * grid_w, C * tps * ps * ps)
    return np.ascontiguousarray(flat), (grid_t, grid_h, grid_w)


def patchify_device(
    frames: torch.Tensor,  # [T, H, W, C] raw uint8 (or float in 0..255)
    patch_size: int = 14,
    temporal_patch_size: int = 2,
    merge_size: int = 2,
) -> torch.Tensor:
    """normalize + patchify in torch, on the frames' device. Returns fp32
    [grid_t*grid_h*grid_w, C*tps*ps*ps]."""
    T, H, W, C = frames.shape
    x = frames.float() / 255.0
    mean = torch.tensor(OPENAI_CLIP_MEAN, dtype=torch.float32, device=frames.device)
    std = torch.tensor(OPENAI_CLIP_STD, dtype=torch.float32, device=frames.device)
    x = ((x - mean) / std).permute(0, 3, 1, 2)
    if T % temporal_patch_size:
        reps = temporal_patch_size - T % temporal_patch_size
        x = torch.cat([x, x[-1:].expand(reps, -1, -1, -1)], dim=0)
    grid_t = x.shape[0] // temporal_patch_size
    grid_h, grid_w = H // patch_size, W // patch_size
    m, ps, tps = merge_size, patch_size, temporal_patch_size
    x = x.reshape(grid_t, tps, C, grid_h // m, m, ps, grid_w // m, m, ps)
    x = x.permute(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return x.reshape(grid_t * grid_h * grid_w, C * tps * ps * ps)
