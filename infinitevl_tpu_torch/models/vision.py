"""Qwen2.5-VL-style dynamic-resolution ViT encoder (torch port of the
inference path of infinitevl_tpu/models/vision.py).

All data-dependent layout work (window reordering, segment ids, rotary
tables) is computed once per (t, h, w) grid tuple in numpy (`VisionPlan`)
and cached; the device copies of a plan's arrays are cached per (grid,
device) (`plan_tensors`).

Attention per block:
- Window blocks (most of the 32): after the window permutation every
  window is a contiguous run of `spatial_merge_unit * merger_window^2`
  tokens padded to equal size, so window attention is a batched dense
  attention over [num_windows, win_len].
- Full-attention blocks (fullatt_block_indexes): segment-masked attention
  over the packed sequence, one segment per image / video frame: dense
  below FLASH_FULL_ATTN_MIN_SEQ tokens, batched per grid when all grids
  are equal, and the segment flash kernel E (ops/vit_kernels.py) from
  FLASH_FULL_ATTN_MIN_SEQ on.

Under tensor parallelism (the model axis of parallel/sharding.py) a block
runs on this rank's slices: the fused qkv kernel is split colwise into
contiguous slices that cut heads (at model 2 rank 0 holds all of q and half
of k), so its output is gathered whole (`tp_gather`, summed backward) and
the rank attends with the heads whose `proj` rows it holds; `proj`, the
MLP's down and the merger's fc2 are row-parallel (models/text._dense sums
their partial outputs before the replicated bias). The patch embedding's
output channels are gathered whole."""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import VisionConfig
from ..ops.norms import rms_norm, silu
from ..ops.rope import apply_rotary_vision, vision_cos_sin, vision_rot_pos_ids
from ..ops.swa import attention_dense
from ..ops.vit_flash import vit_full_attention, vit_window_attention
from ..parallel.sharding import gather_top, gather_tree, tp_copy, tp_gather, tp_info
from .text import _dense, _kernel, _tp

Params = Dict[str, Any]
GridTHW = Tuple[Tuple[int, int, int], ...]

# Packed-sequence length at which full-attention blocks switch from the
# dense-mask path to the segment flash kernel's wrapper (E), and the packed
# length and window length from which window blocks take the window flash
# kernel's wrapper (F) instead of the batched-dense path. They are the
# smallest sizes at which the kernels were measured against the dense paths
# on an H100 (chip_smoke.py, lines "[3 gates]" and "F timed"; both kernels
# won at every size measured, down to one 448x448 frame: S 1024, windows of
# 64). On a CPU tensor the wrappers run their plain versions and the
# thresholds only bound the score memory; on a CUDA tensor of another head
# dim than the kernels are written for, the wrappers raise. F takes any
# window length: there is no upper bound.
FLASH_FULL_ATTN_MIN_SEQ = 1024
WINDOW_FLASH_MIN_SEQ = 1024
WINDOW_FLASH_MIN_WIN_LEN = 64


class VisionPlan:
    """Static per-grid layout: permutations, window shapes, rope tables
    (numpy; built once per distinct grid_thw tuple and cached)."""

    def __init__(self, grid_thw: GridTHW, cfg: VisionConfig):
        self.grid_thw = grid_thw
        self.cfg = cfg
        m = cfg.spatial_merge_size
        unit = cfg.spatial_merge_unit
        mw = cfg.merger_window  # window edge in merged tokens

        # window permutation in merged-token units, with pad slots (-1);
        # one full-attention segment per temporal frame (the reference
        # builds full cu_seqlens via repeat_interleave(h*w, t))
        perm_chunks = []
        seg_full_merged = []
        seg_id = 0
        base = 0
        for t, h, w in grid_thw:
            lh, lw = h // m, w // m
            for _ in range(t):
                seg_full_merged.extend([seg_id] * (lh * lw))
                seg_id += 1
            nh = -(-lh // mw)
            nw = -(-lw // mw)
            idx = np.arange(t * lh * lw).reshape(t, lh, lw)
            padded = np.full((t, nh * mw, nw * mw), -1, dtype=np.int64)
            padded[:, :lh, :lw] = idx
            padded = (
                padded.reshape(t, nh, mw, nw, mw)
                .transpose(0, 1, 3, 2, 4)
                .reshape(t * nh * nw, mw * mw)
            )
            perm_chunks.extend(np.where(row >= 0, row + base, -1) for row in padded)
            base += t * lh * lw

        win = np.stack(perm_chunks)  # [nW, mw*mw] merged indices or -1
        self.num_windows = win.shape[0]
        self.win_len_merged = win.shape[1]
        self.win_len = self.win_len_merged * unit  # patch tokens per window
        self.seq_merged = base  # real merged tokens
        self.seq = base * unit  # real patch tokens
        self.pad_seq_merged = self.num_windows * self.win_len_merged
        self.pad_seq = self.pad_seq_merged * unit

        # gather index over merged units; pads read unit 0 and are masked
        flat = win.reshape(-1)
        self.merged_gather = np.where(flat >= 0, flat, 0).astype(np.int32)
        self.merged_valid = flat >= 0  # [pad_seq_merged]
        self.token_valid = np.repeat(self.merged_valid, unit)  # [pad_seq]

        # inverse permutation: padded window-order slot of each merged token
        inv = np.zeros(self.seq_merged, dtype=np.int32)
        inv[flat[flat >= 0]] = np.nonzero(flat >= 0)[0].astype(np.int32)
        self.merged_inverse = inv

        # window ids in window order: real tokens of window w carry w, pad
        # slots -2-w (the segment form of window attention, kernel F)
        wi = np.repeat(np.arange(self.num_windows, dtype=np.int32), self.win_len)
        self.win_seg = np.where(self.token_valid, wi, -2 - wi)  # [pad_seq]

        # full-attention segment ids in window order; pad slots get -1
        seg_full = np.asarray(seg_full_merged, dtype=np.int32)
        seg_win_order = np.where(self.merged_valid, seg_full[self.merged_gather], -1)
        self.seg_full = np.repeat(seg_win_order, unit).astype(np.int32)  # [pad_seq]

        # equal grids (multi-stream / clip ingestion): each grid's
        # window-ordered span has the same padded length, so full attention
        # can batch per grid instead of masking the whole packed sequence
        self.equal_frame_len = (
            self.pad_seq // len(grid_thw)
            if len(grid_thw) > 1 and len(set(grid_thw)) == 1
            else None
        )

        # rotary tables in window order (patch-token units)
        pos_ids = vision_rot_pos_ids(grid_thw, m)  # [seq, 2] original order
        cos, sin = vision_cos_sin(pos_ids, cfg.head_dim)
        cos = cos.reshape(self.seq_merged, unit, -1)
        sin = sin.reshape(self.seq_merged, unit, -1)
        self.cos = cos[self.merged_gather].reshape(self.pad_seq, -1)
        self.sin = sin[self.merged_gather].reshape(self.pad_seq, -1)


@functools.lru_cache(maxsize=64)
def get_vision_plan(grid_thw: GridTHW, cfg: VisionConfig) -> VisionPlan:
    return VisionPlan(grid_thw, cfg)


@functools.lru_cache(maxsize=64)
def _plan_tensors(grid_thw: GridTHW, cfg: VisionConfig, device: torch.device):
    plan = get_vision_plan(grid_thw, cfg)
    return {
        "merged_gather": torch.as_tensor(plan.merged_gather.astype(np.int64), device=device),
        "merged_inverse": torch.as_tensor(plan.merged_inverse.astype(np.int64), device=device),
        "token_valid": torch.as_tensor(plan.token_valid, device=device),
        "seg_full": torch.as_tensor(plan.seg_full, device=device),
        "win_seg": torch.as_tensor(plan.win_seg.astype(np.int32), device=device),
        "cos": torch.as_tensor(plan.cos, device=device),
        "sin": torch.as_tensor(plan.sin, device=device),
    }


def plan_tensors(plan: VisionPlan, device) -> Dict[str, torch.Tensor]:
    """The plan's arrays as tensors on `device`, made once per (grid,
    device) and shared by every forward (read-only)."""
    return _plan_tensors(plan.grid_thw, plan.cfg, torch.device(device))


def _vision_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    if "gate_up" in p:  # fused layout (models/fuse.py)
        gu = _dense(x, p["gate_up"])
        inter = gu.shape[-1] // 2
        return _dense(silu(gu[..., :inter]) * gu[..., inter:], p["down"])
    if _tp(p["gate"]) is not None:
        x = tp_copy(x)
    return _dense(silu(_dense(x, p["gate"])) * _dense(x, p["up"]), p["down"])


def _window_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, plan: VisionPlan,
    valid: torch.Tensor, win_seg: torch.Tensor,
) -> torch.Tensor:
    """Per-window attention. q/k/v: [S, H, D] in window order. Real queries
    see real keys and pad queries pad keys, which keeps pad rows finite.
    Long windows of a long sequence go through the window flash kernel's
    wrapper (F; its plain version on a CPU tensor); everything else is
    batched dense attention."""
    S, H, D = q.shape
    nW, L = plan.num_windows, plan.win_len
    if S >= WINDOW_FLASH_MIN_SEQ and L >= WINDOW_FLASH_MIN_WIN_LEN:
        return vit_window_attention(q, k, v, win_seg, L)
    vm = valid.reshape(nW, L)
    mask = vm[:, :, None] == vm[:, None, :]
    out = attention_dense(
        q.reshape(nW, L, H, D), k.reshape(nW, L, H, D), v.reshape(nW, L, H, D), mask
    )
    return out.reshape(S, H, D)


def _full_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    seg: torch.Tensor,
    frame_len: Optional[int] = None,
) -> torch.Tensor:
    """Segment-masked non-causal attention over the packed sequence. Pad
    slots share segment -1, so they attend each other and stay finite
    without mixing with real tokens. With `frame_len` (equal grids) the
    sequence reshapes to [n_frames, frame_len] and attention batches per
    frame: the same result (segments never cross grid spans) at 1/n_frames
    of the score work."""
    S, H, D = q.shape
    if frame_len is not None:
        n = S // frame_len
        segb = seg.reshape(n, frame_len)
        mask = segb[:, :, None] == segb[:, None, :]
        out = attention_dense(
            q.reshape(n, frame_len, H, D),
            k.reshape(n, frame_len, H, D),
            v.reshape(n, frame_len, H, D),
            mask,
        )
        return out.reshape(S, H, D)
    if S >= FLASH_FULL_ATTN_MIN_SEQ:
        # long packed sequence (high-resolution image, multi-image prefill)
        return vit_full_attention(q, k, v, seg)
    mask = seg[:, None] == seg[None, :]
    return attention_dense(q[None], k[None], v[None], mask[None])[0]


def vision_block_forward(
    p: Params,
    cfg: VisionConfig,
    x: torch.Tensor,  # [S, Dv] window order
    plan: VisionPlan,
    full: bool,
    tensors: Dict[str, torch.Tensor],
) -> torch.Tensor:
    S = x.shape[0]
    H, D = cfg.num_heads, cfg.head_dim
    h = rms_norm(x, p["norm1"], 1e-6)
    tp = _tp(p["qkv"])
    if tp is None:
        qkv = _dense(h, p["qkv"]).reshape(S, 3, H, D)
    else:  # the heads whose proj rows this rank holds
        qkv = tp_gather(_dense(tp_copy(h), p["qkv"]), summed=True).reshape(S, 3, H, D)
        proj = _kernel(p["proj"])
        n, r = proj.shape[0] // D, tp_info(proj).rank
        qkv = qkv[:, :, r * n : (r + 1) * n]
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    q, k = apply_rotary_vision(q, k, tensors["cos"], tensors["sin"])
    if full:
        attn = _full_attention(q, k, v, tensors["seg_full"], plan.equal_frame_len)
    else:
        attn = _window_attention(q, k, v, plan, tensors["token_valid"], tensors["win_seg"])
    x = x + _dense(attn.reshape(S, -1), p["proj"])
    return x + _vision_mlp(p["mlp"], rms_norm(x, p["norm2"], 1e-6))


def vision_forward(
    params: Params,
    cfg: VisionConfig,
    pixel_values: torch.Tensor,  # [seq, in_feat] flattened patches (processor layout)
    plan: VisionPlan,
) -> torch.Tensor:
    """Full ViT: patch embed -> window reorder -> blocks -> merger ->
    restore. Returns [seq_merged, out_hidden] in the original token order."""
    unit = cfg.spatial_merge_unit
    params = gather_top(params)  # FSDP: the patch embedding and the merger once
    tensors = plan_tensors(plan, pixel_values.device)
    x = pixel_values.to(params["patch_embed"].dtype) @ params["patch_embed"]
    if tp_info(params["patch_embed"]) is not None:
        x = tp_gather(x)
    # reorder to window order with pad slots
    x = x.reshape(plan.seq_merged, unit, -1)
    x = x[tensors["merged_gather"]].reshape(plan.pad_seq, -1)

    fullatt = set(cfg.fullatt_block_indexes)
    for i, bp in enumerate(params["blocks"]):
        x = vision_block_forward(gather_tree(bp), cfg, x, plan, i in fullatt, tensors)

    # merger: RMSNorm -> concat the 2x2 merged unit -> MLP (exact GELU)
    m = params["merger"]
    h = rms_norm(x, m["ln_q"], 1e-6)
    h = h.reshape(plan.pad_seq_merged, unit * h.shape[-1])
    if _tp(m["fc1"]) is not None:
        h = tp_copy(h)
    h = _dense(F.gelu(_dense(h, m["fc1"])), m["fc2"])  # [pad_seq_merged, out]
    # restore the original merged-token order, dropping pad slots
    return h[tensors["merged_inverse"]]
