"""Streaming video inference engine (torch port of
infinitevl_tpu/streaming.py).

Each frame goes through the ViT, becomes `tokens_per_frame` tokens, and
<vision_start> + those tokens are prefilled into the constant-size decoder
state, which every step updates IN PLACE (the JAX step donates its state).

Position semantics: every stream frame reuses the same spatial (h, w)
mRoPE base positions; only the temporal axis advances, by t_offset =
grid_t * tokens_per_grid where grid_t indexes wall-clock time in
second_per_grid_ts units. QA branches start at max(position) + 1.

Branched QA: because the state is updated in place, `ask` and
`extract_stream` work on a copy (`clone_state`, `state_row`), so the stream
is left as it was. The copy costs one pass over the state."""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import InfiniteVLConfig
from .data.processing import patchify_device
from .device import Device, resolve_device
from .generation import (
    embed_leaf,
    check_params_device,
    decode_chunk,
    prefill,
    serving_params,
)
from .models.infinitevl import get_rope_index, scatter_vision_embeds
from .models.state import DecoderState, clone_state, init_decoder_state, state_row
from .models.text import embed_tokens, lm_head, text_forward
from .models.vision import get_vision_plan, vision_forward

Params = Dict[str, Any]
GridTHW = Tuple[Tuple[int, int, int], ...]


def _ingest(
    params: Params,
    cfg: InfiniteVLConfig,
    pixel_values: torch.Tensor,  # packed patches of every grid in grid_thw
    input_ids: torch.Tensor,  # [B, n_units_per_row * (1 + n_tok)]
    pos_base: int,
    t_offsets: Sequence[int],  # temporal offset of each unit of a row
    state: DecoderState,
    grid_thw: GridTHW,
) -> DecoderState:
    """ViT over the packed grids, scatter into the pad tokens, positions,
    decoder prefill. Each row of `input_ids` holds len(t_offsets) units of
    <vision_start> + n_tok pads; every unit restarts from `pos_base`."""
    plan = get_vision_plan(grid_thw, cfg.vision)
    vis = vision_forward(params["visual"], cfg.vision, pixel_values, plan)
    embeds = embed_tokens(params["text"], input_ids)
    embeds = scatter_vision_embeds(embeds, vis, input_ids == cfg.image_token_id)

    B, T = input_ids.shape
    n = len(t_offsets)
    n_tok = T // n - 1
    m = cfg.vision.spatial_merge_size
    lh, lw = grid_thw[0][1] // m, grid_thw[0][2] // m
    dev = input_ids.device
    h_idx = torch.arange(lh, device=dev).repeat_interleave(lw)
    w_idx = torch.arange(lw, device=dev).repeat(lh)
    t_off = torch.as_tensor(list(t_offsets), dtype=torch.long, device=dev)[:, None]
    grid_base = pos_base + 1
    start_col = torch.full((n, 1), pos_base, dtype=torch.long, device=dev)
    pos_t = torch.cat([start_col, (grid_base + t_off).expand(n, n_tok)], dim=1)
    pos_h = torch.cat([start_col, (grid_base + h_idx).expand(n, n_tok)], dim=1)
    pos_w = torch.cat([start_col, (grid_base + w_idx).expand(n, n_tok)], dim=1)
    pos = torch.stack([pos_t.reshape(-1), pos_h.reshape(-1), pos_w.reshape(-1)])
    pos = pos[:, None, :].expand(3, B, T)
    _, state = text_forward(params["text"], cfg.text, embeds, pos, state)
    return state


def stream_frame_step(
    params: Params,
    cfg: InfiniteVLConfig,
    pixel_values: torch.Tensor,  # [n_patches, in_feat] one frame
    frame_input_ids: torch.Tensor,  # [1, 1 + n_tok] <vision_start> + image pads
    pos_base: int,  # position of <vision_start>
    t_offset: int,  # temporal mrope offset of this frame
    state: DecoderState,
    grid_thw: GridTHW = ((1, 32, 32),),
) -> DecoderState:
    """Ingest one video frame into the streaming state (in place)."""
    return _ingest(params, cfg, pixel_values, frame_input_ids, pos_base,
                   [t_offset], state, grid_thw)


def _patchify_raw(params: Params, cfg: InfiniteVLConfig, frames: torch.Tensor):
    v = cfg.vision
    return patchify_device(
        frames, v.patch_size, v.temporal_patch_size, v.spatial_merge_size
    ).to(params["visual"]["patch_embed"].dtype)


def stream_frame_step_raw(
    params: Params,
    cfg: InfiniteVLConfig,
    raw_frame: torch.Tensor,  # [H, W, C] uint8, already sized to the bucket
    frame_input_ids: torch.Tensor,
    pos_base: int,
    t_offset: int,
    state: DecoderState,
    grid_thw: GridTHW = ((1, 32, 32),),
) -> DecoderState:
    """Raw-uint8 variant: CLIP-normalize + patchify run on the device
    (data/processing.patchify_device), so the host ships 3 bytes per pixel.
    [H, W, C] is one frame (repeated to fill the temporal patch); [T, H, W,
    C] a clip of real frames for one temporal unit (paired mode)."""
    frames = raw_frame if raw_frame.ndim == 4 else raw_frame[None]
    return stream_frame_step(
        params, cfg, _patchify_raw(params, cfg, frames), frame_input_ids,
        pos_base, t_offset, state, grid_thw,
    )


def stream_clip_step(
    params: Params,
    cfg: InfiniteVLConfig,
    pixel_values: torch.Tensor,  # [n_units * n_patches, in_feat] packed units
    clip_input_ids: torch.Tensor,  # [1, n_units * (1 + n_tok)]
    pos_base: int,
    t_offsets: Sequence[int],  # temporal offset per unit
    state: DecoderState,
    grid_thw: GridTHW,  # n_units single-unit grids
) -> DecoderState:
    """Ingest N temporal units in ONE forward (T = N * (1 + n_tok)). Token
    stream, per-unit positions, per-frame ViT windows and state updates are
    those of N sequential stream_frame_step calls (each unit keeps its own
    (1, h, w) grid, so full-attention ViT blocks never mix units); the
    decoder's weights are read once for N units, at the cost of N - 1 units
    of buffering on the host."""
    return _ingest(params, cfg, pixel_values, clip_input_ids, pos_base,
                   t_offsets, state, grid_thw)


def stream_clip_step_raw(
    params: Params,
    cfg: InfiniteVLConfig,
    raw_frames: torch.Tensor,  # [n_units, H, W, C] (one frame per unit) or
    #                            [n_units * tps, H, W, C] (consecutive frames)
    clip_input_ids: torch.Tensor,
    pos_base: int,
    t_offsets: Sequence[int],
    state: DecoderState,
    grid_thw: GridTHW,
) -> DecoderState:
    """Raw-uint8 clip variant. One frame per unit is repeated on the device
    to fill temporal_patch_size. Patchifying the whole clip is block-wise
    the per-unit patchify: rows [i*HW, (i+1)*HW) hold unit i's patches."""
    tps = cfg.vision.temporal_patch_size
    frames = raw_frames
    if frames.shape[0] == len(grid_thw) and tps > 1:
        frames = frames.repeat_interleave(tps, dim=0)
    return stream_clip_step(
        params, cfg, _patchify_raw(params, cfg, frames), clip_input_ids,
        pos_base, t_offsets, state, grid_thw,
    )


def stream_frames_batched(
    params: Params,
    cfg: InfiniteVLConfig,
    pixel_values: torch.Tensor,  # [B * n_patches, in_feat] one frame per stream
    frame_input_ids: torch.Tensor,  # [B, 1 + n_tok]
    pos_base: int,  # streams advance in lockstep
    t_offset: int,
    state: DecoderState,  # batch size B
    grid_thw: GridTHW,  # B single-frame grids
) -> DecoderState:
    """Ingest one frame for each of B independent streams in ONE forward
    (multi-camera serving): each stream keeps its own state row; frames
    pack as B per-frame ViT grids (full-attention blocks never mix streams)
    and scatter row-major into each row's pad tokens."""
    return _ingest(params, cfg, pixel_values, frame_input_ids, pos_base,
                   [t_offset], state, grid_thw)


class StreamingEngine:
    """Frame-by-frame video prefill with branched QA (push_frame / ask /
    stats). `device=None` means the CUDA card; the params must live on the
    device. `fuse=True` serves from fused projections; `quant` ("int8" /
    "int4") quantizes the weights first, and an already quantized tree is
    taken as it is (the state dtype then rides on the embedding's scale)."""

    def __init__(
        self,
        params: Params,
        cfg: InfiniteVLConfig,
        frame_hw: Tuple[int, int] = (448, 448),
        dtype: Optional[torch.dtype] = None,
        batch_size: int = 1,
        fuse: bool = False,
        quant: Optional[str] = None,
        device: Optional[Device] = None,
    ):
        self.device = resolve_device(device)
        check_params_device(params, self.device)
        # the state dtype follows the activations (the weights')
        self.dtype = dtype if dtype is not None else embed_leaf(params).dtype
        self.params = serving_params(params, fuse, quant)
        self.cfg = cfg
        self.frame_hw = tuple(frame_hw)
        p = cfg.vision.patch_size
        m = cfg.vision.spatial_merge_size
        if frame_hw[0] % (p * m) or frame_hw[1] % (p * m):
            raise ValueError("frame size must be a multiple of patch*merge")
        gh, gw = frame_hw[0] // p, frame_hw[1] // p
        self.grid_thw: GridTHW = ((1, gh, gw),)
        self.tokens_per_frame = (gh // m) * (gw // m)
        ids = [cfg.vision_start_token_id] + [cfg.image_token_id] * self.tokens_per_frame
        self.frame_input_ids = torch.tensor([ids], dtype=torch.long, device=self.device)
        self.state: DecoderState = init_decoder_state(
            cfg.text, batch_size, dtype=self.dtype, device=self.device
        )
        # host-side position bookkeeping
        self.pos_base = 0  # position of <vision_start> for stream frames
        self.pos_max = -1  # running max mrope position
        self.frame_times_ms: List[float] = []
        self.frames = 0
        self._pair_buf: List[np.ndarray] = []

    # ------------------------------------------------------------------
    def prime(
        self,
        input_ids: np.ndarray,  # [1, T] initial prompt (may include a frame)
        pixel_values: Optional[np.ndarray] = None,
        image_grid_thw: Optional[np.ndarray] = None,
    ) -> None:
        """Prefill an initial prompt and set the stream position base."""
        input_ids = np.asarray(input_ids)
        pos, _ = get_rope_index(self.cfg, input_ids, image_grid_thw)
        grid = (
            tuple(tuple(int(x) for x in g) for g in image_grid_thw)
            if image_grid_thw is not None
            else None
        )
        pv = None
        if pixel_values is not None:
            pv = torch.as_tensor(np.asarray(pixel_values), device=self.device).to(self.dtype)
        prefill(
            self.params, self.cfg,
            torch.as_tensor(input_ids, dtype=torch.long, device=self.device),
            torch.as_tensor(pos, device=self.device),
            self.state, pixel_values=pv, grid_thw=grid,
        )
        self.pos_max = int(pos.max())
        self.pos_base = self.pos_max + 1

    def t_offset_for_frame(self, frame_idx: int, fps: float) -> int:
        """grid_t = floor(frame_time / second_per_grid_ts); the offset in
        position units is grid_t * second_per_grid * tokens_per_second."""
        v = self.cfg.vision
        second_per_grid = v.temporal_patch_size / fps
        grid_t = int((frame_idx / fps) / second_per_grid)
        return int(grid_t * second_per_grid * v.tokens_per_second)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _timed(self, step, data, ids, t_offs, grid_thw, n_frames: int) -> None:
        """Run one ingestion step on `data`, wait for the device (as the
        JAX engine's block_until_ready) and do the bookkeeping."""
        t0 = time.perf_counter()
        step(self.params, self.cfg, data, ids, self.pos_base, t_offs, self.state, grid_thw)
        self._sync()
        self.frame_times_ms.append((time.perf_counter() - t0) * 1e3)
        t_max = max(t_offs) if isinstance(t_offs, list) else t_offs
        self.pos_max = max(self.pos_max, self.pos_base + 1 + t_max)
        self.frames += n_frames

    def _pixels(self, pixel_values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(pixel_values), device=self.device).to(self.dtype)

    def _raw(self, frames) -> torch.Tensor:
        return torch.as_tensor(np.asarray(frames), dtype=torch.uint8, device=self.device)

    def push_frame(self, pixel_values: np.ndarray, fps: float = 30.0) -> None:
        """Ingest one frame (pixel_values: [n_patches, in_feat])."""
        t_off = self.t_offset_for_frame(self.frames, fps)
        self._timed(stream_frame_step, self._pixels(pixel_values),
                    self.frame_input_ids, t_off, self.grid_thw, 1)

    def push_frame_pair(self, pixel_values: np.ndarray, fps: float = 30.0) -> None:
        """Ingest TWO consecutive frames as one temporal unit (pixel_values
        from patchify of a [2, H, W, C] clip): one grid_t unit per
        temporal_patch_size real frames, the offline video processor's
        semantics, at half the per-frame cost of repeating each frame."""
        t_off = self.t_offset_for_frame(self.frames, fps)
        self._timed(stream_frame_step, self._pixels(pixel_values),
                    self.frame_input_ids, t_off, self.grid_thw, 2)

    def push_frame_raw_paired(self, frame_rgb: np.ndarray, fps: float = 30.0) -> bool:
        """Paired-mode raw ingestion: buffers every other frame on the host
        and runs one step per two frames. Returns True when a step ran."""
        self._pair_buf.append(np.asarray(frame_rgb))
        if len(self._pair_buf) < 2:
            return False
        clip = np.stack(self._pair_buf)
        self._pair_buf = []
        t_off = self.t_offset_for_frame(self.frames, fps)
        self._timed(stream_frame_step_raw, self._raw(clip), self.frame_input_ids,
                    t_off, self.grid_thw, 2)
        return True

    def push_frame_raw(self, frame_rgb: np.ndarray, fps: float = 30.0) -> None:
        """Ingest a raw uint8 [H, W, C] frame; normalize + patchify on the
        device."""
        t_off = self.t_offset_for_frame(self.frames, fps)
        self._timed(stream_frame_step_raw, self._raw(frame_rgb),
                    self.frame_input_ids, t_off, self.grid_thw, 1)

    def extract_stream(self, row: int) -> "StreamingEngine":
        """Snapshot one stream of a multi-stream engine as a batch-1 engine
        holding a COPY of that row of the state, so pushing to or asking the
        snapshot leaves the multi-stream state untouched."""
        eng = StreamingEngine.__new__(StreamingEngine)  # no fresh zero state
        eng.__dict__.update(self.__dict__)
        eng.state = state_row(self.state, row)
        eng.frame_times_ms = []
        eng._pair_buf = []
        return eng

    def push_frames_batched(self, pixel_values: np.ndarray, fps: float = 30.0) -> None:
        """Multi-stream ingestion: one frame per stream (pixel_values
        [batch_size * n_patches, in_feat], stream-major), all streams in
        lockstep. For an engine built with batch_size > 1."""
        B = self.state["delta_h"].shape[1]
        t_off = self.t_offset_for_frame(self.frames, fps)
        self._timed(stream_frames_batched, self._pixels(pixel_values),
                    self.frame_input_ids.expand(B, -1), t_off, self.grid_thw * B, 1)

    def push_clip_raw(
        self,
        frames: np.ndarray,  # [k, H, W, C] uint8 (one frame per unit) or
        #                      [k * tps, H, W, C] (paired: consecutive frames)
        fps: float = 30.0,
        paired: bool = False,
    ) -> None:
        """Ingest k temporal units in ONE step (stream_clip_step). Latency
        grows by the k - 1 units buffered on the host; per-unit state and
        position semantics are those of k push_frame calls."""
        frames = np.asarray(frames)
        tps = self.cfg.vision.temporal_patch_size
        k = frames.shape[0] // tps if paired else frames.shape[0]
        frames_per_unit = tps if paired else 1
        t_offs = [
            self.t_offset_for_frame(self.frames + i * frames_per_unit, fps)
            for i in range(k)
        ]
        self._timed(stream_clip_step_raw, self._raw(frames),
                    self.frame_input_ids.repeat(1, k), t_offs, self.grid_thw * k,
                    k * frames_per_unit)

    def ask(
        self,
        question_ids: np.ndarray,  # [1, Tq] tokenized question
        max_new_tokens: int = 200,
        eos_token_id: Optional[int] = None,
        chunk_size: int = 16,
    ) -> List[int]:
        """Branch the stream, prefill <vision_end> + question, greedy
        decode. The branch is a clone of the state (the forward updates its
        state in place), so the stream itself is untouched. Decoding runs
        chunk_size steps per host sync."""
        cfg = self.cfg
        B = self.state["delta_h"].shape[1]
        if B != 1:
            raise ValueError(
                f"ask() branches a single stream; this engine holds {B}. "
                "Use extract_stream(row).ask(...) to question one stream."
            )
        eos = eos_token_id if eos_token_id is not None else cfg.eos_token_id
        q_ids = np.concatenate(
            [[[cfg.vision_end_token_id]], np.atleast_2d(np.asarray(question_ids))],
            axis=1,
        ).astype(np.int64)
        Tq = q_ids.shape[1]
        start = self.pos_max + 1
        pos = torch.arange(start, start + Tq, device=self.device).expand(3, 1, Tq)
        branch = clone_state(self.state)
        embeds = embed_tokens(self.params["text"],
                              torch.as_tensor(q_ids, device=self.device))
        hidden, branch = text_forward(self.params["text"], cfg.text, embeds, pos, branch)
        logits = lm_head(self.params["text"], cfg.text, hidden[:, -1])
        tok = int(torch.argmax(logits, dim=-1)[0])
        out: List[int] = []
        if tok == eos or max_new_tokens <= 0:
            return out
        out.append(tok)
        # decode positions continue from start + Tq: delta against cum_len
        rope_delta = torch.tensor([[start - self.state["cum_len"]]], dtype=torch.long,
                                  device=self.device)
        tok_in = torch.tensor([[tok]], dtype=torch.long, device=self.device)
        finished = torch.zeros((1,), dtype=torch.bool, device=self.device)
        while len(out) < max_new_tokens:
            steps = min(chunk_size, max_new_tokens - len(out))
            toks, branch, finished, _ = decode_chunk(
                self.params, cfg, tok_in, rope_delta, branch, finished, None,
                steps=steps, eos=eos, temperature=0.0,
            )
            for x in toks[0].tolist():  # one host sync per chunk
                if x == eos:
                    return out
                out.append(x)
            tok_in = toks[:, -1:]
        return out

    def stats(self) -> Dict[str, float]:
        if not self.frame_times_ms:
            return {}
        arr = np.asarray(self.frame_times_ms[1:] or self.frame_times_ms)
        return {
            "frames": self.frames,
            "avg_ms": float(arr.mean()),
            "p50_ms": float(np.percentile(arr, 50)),
            "fps": float(1000.0 / arr.mean()),
            "tokens": int(self.state["cum_len"]),
        }
