"""InfiniteVL model entry: 3D mRoPE position indices and the decoder
forward (torch port of infinitevl_tpu/models/infinitevl.py, text only;
the vision encoder and the masked scatter come with the multimodal slice).

`get_rope_index` is host-side numpy, copied whole from the JAX module:
data-dependent token bookkeeping done once per prompt."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import InfiniteVLConfig
from .state import DecoderState
from .text import embed_tokens, lm_head, text_forward

Params = Dict[str, Any]


def get_rope_index(
    cfg: InfiniteVLConfig,
    input_ids: np.ndarray,  # [B, T]
    image_grid_thw: Optional[np.ndarray] = None,  # [n_img, 3]
    video_grid_thw: Optional[np.ndarray] = None,  # [n_vid, 3]
    second_per_grid_ts: Optional[Sequence[float]] = None,
    attention_mask: Optional[np.ndarray] = None,  # [B, T]
) -> Tuple[np.ndarray, np.ndarray]:
    """3D (t, h, w) rope indices per token. Returns
    (position_ids [3, B, T], rope_deltas [B, 1]).

    Semantics of reference modeling_infinitevl.py:1623-1758: text tokens
    advance all three axes together; each vision segment gets a 3D grid
    whose temporal index scales with second_per_grid_ts * tokens_per_second,
    and subsequent text resumes from max(position)+1."""
    input_ids = np.asarray(input_ids)
    B, T = input_ids.shape
    merge = cfg.vision.spatial_merge_size
    tps = cfg.vision.tokens_per_second

    if image_grid_thw is None and video_grid_thw is None:
        if attention_mask is not None:
            am = np.asarray(attention_mask)
            pos = np.cumsum(am, axis=-1) - 1
            pos[am == 0] = 1
            position_ids = np.broadcast_to(pos[None], (3, B, T)).astype(np.int64)
            deltas = position_ids.max(axis=(0, 2), keepdims=False)[:, None] + 1 - T
        else:
            pos = np.arange(T, dtype=np.int64)
            position_ids = np.broadcast_to(pos[None, None], (3, B, T)).copy()
            deltas = np.zeros((B, 1), dtype=np.int64)
        return position_ids, deltas

    position_ids = np.ones((3, B, T), dtype=np.int64)
    deltas = np.zeros((B, 1), dtype=np.int64)
    img_i = vid_i = 0
    for b in range(B):
        ids = input_ids[b]
        if attention_mask is not None:
            keep = np.asarray(attention_mask[b]).astype(bool)
            ids = ids[keep]
        tokens = ids.tolist()
        n = len(tokens)
        chunks = []
        st = 0
        while True:
            # next vision pad token (image or video)
            nxt_img = _index_of(tokens, cfg.image_token_id, st)
            nxt_vid = _index_of(tokens, cfg.video_token_id, st)
            if nxt_img is None and nxt_vid is None:
                break
            if nxt_vid is None or (nxt_img is not None and nxt_img < nxt_vid):
                t, h, w = image_grid_thw[img_i]
                spg = 0.0
                img_i += 1
                ed = nxt_img
            else:
                t, h, w = video_grid_thw[vid_i]
                spg = (
                    float(second_per_grid_ts[vid_i])
                    if second_per_grid_ts is not None
                    else 1.0
                )
                vid_i += 1
                ed = nxt_vid
            lt, lh, lw = int(t), int(h) // merge, int(w) // merge
            text_len = ed - st
            st_idx = (chunks[-1].max() + 1) if chunks else 0
            if text_len:
                rng = np.arange(text_len, dtype=np.int64) + st_idx
                chunks.append(np.broadcast_to(rng, (3, text_len)).copy())
            # bug-compatible with the reference (and upstream Qwen2.5-VL):
            # second_per_grid_t is cast to the int64 dtype of range_tensor
            # BEFORE the multiply (modeling_infinitevl.py:1710-1717), so
            # fractional seconds-per-grid truncate to whole numbers
            spg_cast = float(int(spg))
            t_idx = (
                (np.arange(lt, dtype=np.float64)[:, None] * spg_cast * tps)
                .astype(np.int64)
                .repeat(lh * lw, axis=1)
                .reshape(-1)
            )
            h_idx = np.tile(np.arange(lh, dtype=np.int64)[:, None], (lt, 1, lw)).reshape(-1)
            w_idx = np.tile(np.arange(lw, dtype=np.int64)[None, :], (lt, lh, 1)).reshape(-1)
            chunks.append(np.stack([t_idx, h_idx, w_idx]) + text_len + st_idx)
            st = ed + lt * lh * lw
        if st < n:
            st_idx = (chunks[-1].max() + 1) if chunks else 0
            rng = np.arange(n - st, dtype=np.int64) + st_idx
            chunks.append(np.broadcast_to(rng, (3, n - st)).copy())
        pos = np.concatenate(chunks, axis=1)
        if attention_mask is not None:
            position_ids[:, b, keep] = pos
        else:
            position_ids[:, b, :] = pos
        deltas[b, 0] = pos.max() + 1 - T
    return position_ids, deltas


def _index_of(tokens, tok, start):
    try:
        return tokens.index(tok, start)
    except ValueError:
        return None


def forward(
    params: Params,
    cfg: InfiniteVLConfig,
    input_ids: torch.Tensor,  # [B, T]
    position_ids: torch.Tensor,  # [3, B, T]
    state: Optional[DecoderState] = None,
    pixel_values: Optional[torch.Tensor] = None,
    pixel_values_videos: Optional[torch.Tensor] = None,
    logits_to_keep: int = 0,
) -> Tuple[torch.Tensor, Optional[DecoderState]]:
    """Text forward: embed, decoder stack, head. `logits_to_keep`: 0 = all
    positions, n > 0 = only the last n. With a state, the state is updated
    IN PLACE and returned. Returns (fp32 logits [B, T', vocab], state)."""
    if pixel_values is not None or pixel_values_videos is not None:
        raise NotImplementedError(
            "vision inputs come with the multimodal slice; the torch port "
            "serves text only so far"
        )
    embeds = embed_tokens(params["text"], input_ids)
    hidden, state = text_forward(params["text"], cfg.text, embeds, position_ids, state)
    if logits_to_keep:
        hidden = hidden[:, -logits_to_keep:]
    return lm_head(params["text"], cfg.text, hidden), state
