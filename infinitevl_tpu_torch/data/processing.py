"""Image / video preprocessing and the multimodal processor (the port's
copy of infinitevl_tpu/data/processing.py): smart dynamic-resolution
resize, CLIP normalization, the merger-aware patch flattening whose layout
the checkpoint's patch embed expects, frame sampling, and the processor
that expands each image / video placeholder to its grid.prod() / merge^2
pad tokens (second_per_grid_ts = temporal_patch_size / fps).

Everything is numpy (and PIL for the bicubic resize) on the host, except
`patchify_device`, which does normalize + patchify in torch on the frames'
device, so the streaming engine ships raw uint8 frames (3 bytes per pixel)
to the card."""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

IMAGE_PAD = "<|image_pad|>"
VIDEO_PAD = "<|video_pad|>"
VISION_START = "<|vision_start|>"
VISION_END = "<|vision_end|>"


def smart_resize(
    height: int,
    width: int,
    factor: int = 28,
    min_pixels: int = 56 * 56,
    max_pixels: int = 14 * 14 * 4 * 1280,
) -> Tuple[int, int]:
    """Target (h, w): factor-aligned, area clamped to [min, max], aspect
    ratio preserved. Same contract as the HF Qwen2VL smart_resize."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError(
            f"aspect ratio must be < 200, got {max(height, width) / min(height, width):.1f}"
        )
    h = round(height / factor) * factor
    w = round(width / factor) * factor
    if h * w > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h = max(factor, math.floor(height / beta / factor) * factor)
        w = max(factor, math.floor(width / beta / factor) * factor)
    elif h * w < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h = math.ceil(height * beta / factor) * factor
        w = math.ceil(width * beta / factor) * factor
    return h, w


def resize_bicubic(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Resize [H, W, C] uint8/float to [out_h, out_w, C].

    Uses PIL's bicubic when available (matches the reference pipeline);
    falls back to a numpy bilinear."""
    try:
        from PIL import Image

        if img.dtype != np.uint8:
            arr = np.clip(img, 0, 255).astype(np.uint8)
        else:
            arr = img
        pil = Image.fromarray(arr)
        return np.asarray(pil.resize((out_w, out_h), Image.BICUBIC))
    except ImportError:
        return _resize_bilinear_np(img.astype(np.float32), out_h, out_w)


def _resize_bilinear_np(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    H, W = img.shape[:2]
    ys = (np.arange(out_h) + 0.5) * H / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * W / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, H - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, W - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    a = img[y0][:, x0]
    b = img[y0][:, x1]
    c = img[y1][:, x0]
    d = img[y1][:, x1]
    return a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx + c * wy * (1 - wx) + d * wy * wx


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


def preprocess_image(
    img: np.ndarray,  # [H, W, C] uint8
    patch_size: int = 14,
    temporal_patch_size: int = 2,
    merge_size: int = 2,
    min_pixels: int = 56 * 56,
    max_pixels: int = 14 * 14 * 4 * 1280,
) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """Full single-image path: smart resize -> normalize -> patchify."""
    if min(img.shape[:2]) < 28:
        raise ValueError("image height/width must be >= 28 px")
    h, w = smart_resize(
        img.shape[0], img.shape[1], patch_size * merge_size, min_pixels, max_pixels
    )
    resized = resize_bicubic(img, h, w)
    frames = normalize(resized[None])
    return patchify(frames, patch_size, temporal_patch_size, merge_size)


def preprocess_video(
    frames: np.ndarray,  # [T, H, W, C] uint8 (already fps-sampled)
    fps: float = 2.0,
    patch_size: int = 14,
    temporal_patch_size: int = 2,
    merge_size: int = 2,
    min_pixels: int = 128 * 28 * 28,
    max_pixels: int = 768 * 28 * 28,
) -> Tuple[np.ndarray, Tuple[int, int, int], float]:
    """Video path. Returns (patches, grid_thw, second_per_grid_t =
    temporal_patch_size / fps)."""
    h, w = smart_resize(
        frames.shape[1], frames.shape[2], patch_size * merge_size, min_pixels, max_pixels
    )
    resized = np.stack([resize_bicubic(f, h, w) for f in frames])
    flat, grid = patchify(
        normalize(resized), patch_size, temporal_patch_size, merge_size
    )
    return flat, grid, temporal_patch_size / fps


def sample_frames(
    frames: np.ndarray,  # [T, H, W, C] uint8, decoded at src_fps
    src_fps: float,
    target_fps: float = 2.0,
    min_frames: int = 4,
    max_frames: int = 64,
    temporal_patch_size: int = 2,
) -> np.ndarray:
    """fps-sample a decoded clip for training/inference: pick frames at
    `target_fps`, clamp count to [min_frames, max_frames], and pad to a
    multiple of temporal_patch_size by repeating the last frame."""
    T = frames.shape[0]
    n = T / max(src_fps, 1e-6) * target_fps
    n = int(np.clip(round(n), min(min_frames, T), max_frames))
    n = max(n, 1)
    idx = np.linspace(0, T - 1, n).round().astype(int)
    out = frames[idx]
    if out.shape[0] % temporal_patch_size:
        reps = temporal_patch_size - out.shape[0] % temporal_patch_size
        out = np.concatenate([out, np.repeat(out[-1:], reps, axis=0)], axis=0)
    return out


@dataclasses.dataclass
class ProcessorOutput:
    input_ids: np.ndarray  # [1, T]
    pixel_values: Optional[np.ndarray] = None
    image_grid_thw: Optional[np.ndarray] = None
    pixel_values_videos: Optional[np.ndarray] = None
    video_grid_thw: Optional[np.ndarray] = None
    second_per_grid_ts: Optional[List[float]] = None


class InfiniteVLProcessor:
    """Combines a tokenizer with the vision preprocessing, expanding each
    image/video placeholder to its grid.prod()/merge^2 pad tokens.

    `tokenizer` is any object with encode(text, add_special_tokens=False) ->
    list[int]; pass the HF Qwen2 tokenizer when its files are available."""

    def __init__(self, tokenizer, cfg, min_pixels=56 * 56, max_pixels=14 * 14 * 4 * 1280):
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.min_pixels = min_pixels
        self.max_pixels = max_pixels

    def __call__(
        self,
        text: str,
        images: Optional[Sequence[np.ndarray]] = None,
        videos: Optional[Sequence[np.ndarray]] = None,
        fps: Union[float, Sequence[float]] = 2.0,
    ) -> ProcessorOutput:
        v = self.cfg.vision
        merge2 = v.spatial_merge_size**2
        img_feats, img_grids = [], []
        if images:
            for im in images:
                flat, grid = preprocess_image(
                    im, v.patch_size, v.temporal_patch_size, v.spatial_merge_size,
                    self.min_pixels, self.max_pixels,
                )
                img_feats.append(flat)
                img_grids.append(grid)
        vid_feats, vid_grids, spgs = [], [], []
        if videos:
            fps_list = fps if isinstance(fps, (list, tuple)) else [fps] * len(videos)
            for vidframes, f in zip(videos, fps_list):
                flat, grid, spg = preprocess_video(
                    vidframes, f, v.patch_size, v.temporal_patch_size, v.spatial_merge_size
                )
                vid_feats.append(flat)
                vid_grids.append(grid)
                spgs.append(spg)

        # expand pad placeholders by token count
        out_text = text
        for grid in img_grids:
            n = grid[0] * grid[1] * grid[2] // merge2
            out_text = out_text.replace(IMAGE_PAD, "<|placeholder|>" * n, 1)
        for grid in vid_grids:
            n = grid[0] * grid[1] * grid[2] // merge2
            out_text = out_text.replace(VIDEO_PAD, "<|video_placeholder|>" * n, 1)
        out_text = out_text.replace("<|placeholder|>", IMAGE_PAD).replace(
            "<|video_placeholder|>", VIDEO_PAD
        )
        ids = self.tokenizer.encode(out_text, add_special_tokens=False)
        return ProcessorOutput(
            input_ids=np.asarray([ids], dtype=np.int64),
            pixel_values=np.concatenate(img_feats) if img_feats else None,
            image_grid_thw=np.asarray(img_grids) if img_grids else None,
            pixel_values_videos=np.concatenate(vid_feats) if vid_feats else None,
            video_grid_thw=np.asarray(vid_grids) if vid_grids else None,
            second_per_grid_ts=spgs or None,
        )
