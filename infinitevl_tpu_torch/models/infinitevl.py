"""InfiniteVL model entry: 3D mRoPE position indices, the masked scatter
of vision features and the multimodal forward (torch port of
infinitevl_tpu/models/infinitevl.py).

`get_rope_index` is host-side numpy, copied whole from the JAX module:
data-dependent token bookkeeping done once per prompt."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import InfiniteVLConfig
from .state import DecoderState
from .text import embed_tokens, lm_head, text_forward
from .vision import get_vision_plan, vision_forward

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


def scatter_vision_embeds(
    inputs_embeds: torch.Tensor,  # [B, T, D]
    vision_embeds: torch.Tensor,  # [N, D] packed features
    vision_mask: torch.Tensor,  # [B, T] bool, exactly N True entries
) -> torch.Tensor:
    """Masked scatter (reference modeling_infinitevl.py:1869-1887): the
    i-th True position (row-major) receives vision_embeds[i]. Written as a
    gather + where, so no host sync counts the mask."""
    B, T, D = inputs_embeds.shape
    if vision_embeds.shape[0] == 0:
        # none of the features lands in these rows (a data-parallel rank's
        # slice of the global batch's media): they still enter the result,
        # as an exact zero, so every rank runs the same ViT backward
        return inputs_embeds + vision_embeds.sum().to(inputs_embeds.dtype)
    flat_mask = vision_mask.reshape(-1)
    idx = torch.cumsum(flat_mask.to(torch.int64), dim=0) - 1
    idx = idx.clamp(0, vision_embeds.shape[0] - 1)
    gathered = vision_embeds[idx].to(inputs_embeds.dtype)
    out = torch.where(flat_mask[:, None], gathered, inputs_embeds.reshape(B * T, D))
    return out.reshape(B, T, D)


def encode_vision(
    params: Params,
    cfg: InfiniteVLConfig,
    pixel_values: torch.Tensor,  # [n_patches, in_feat]
    grid_thw: Sequence[Sequence[int]],
) -> torch.Tensor:
    plan = get_vision_plan(tuple(tuple(int(x) for x in g) for g in grid_thw), cfg.vision)
    return vision_forward(params["visual"], cfg.vision, pixel_values, plan)


def forward(
    params: Params,
    cfg: InfiniteVLConfig,
    input_ids: torch.Tensor,  # [B, T]
    position_ids: torch.Tensor,  # [3, B, T]
    state: Optional[DecoderState] = None,
    pixel_values: Optional[torch.Tensor] = None,  # packed image patches
    grid_thw: Optional[Sequence[Sequence[int]]] = None,
    pixel_values_videos: Optional[torch.Tensor] = None,  # packed video patches
    video_grid_thw: Optional[Sequence[Sequence[int]]] = None,
    vision_mask: Optional[torch.Tensor] = None,  # [B, T]
    segment_ids: Optional[torch.Tensor] = None,
    logits_to_keep: int = 0,
) -> Tuple[torch.Tensor, Optional[DecoderState]]:
    """Full multimodal forward: embed, encode and scatter the vision
    features, decoder stack, head. `logits_to_keep`: 0 = all positions,
    n > 0 = only the last n. With a state, the state is updated IN PLACE
    and returned. Returns (fp32 logits [B, T', vocab], state).

    Images and videos are encoded and scattered separately, each into its
    own pad-token mask, so interleaved image/video prompts stay correct
    whatever their order. When only `pixel_values` is given with no
    explicit mask, the mask covers both pad kinds. `segment_ids` [B, T]
    (packed sequences) belong to the stateless forward."""
    embeds = embed_tokens(params["text"], input_ids)
    if pixel_values is not None:
        vis = encode_vision(params, cfg, pixel_values, grid_thw)
        mask = vision_mask
        if mask is None:
            mask = input_ids == cfg.image_token_id
            if pixel_values_videos is None:
                mask = mask | (input_ids == cfg.video_token_id)
        embeds = scatter_vision_embeds(embeds, vis, mask)
    if pixel_values_videos is not None:
        vis = encode_vision(params, cfg, pixel_values_videos, video_grid_thw)
        embeds = scatter_vision_embeds(embeds, vis, input_ids == cfg.video_token_id)
    hidden, state = text_forward(params["text"], cfg.text, embeds, position_ids, state,
                                 segment_ids=segment_ids)
    if logits_to_keep:
        hidden = hidden[:, -logits_to_keep:]
    return lm_head(params["text"], cfg.text, hidden), state
