"""Generation: prefill, decode steps and the `Generator` driver (torch port
of infinitevl_tpu/generation.py: text and multimodal prompts, greedy and
sampled decoding; speculative and beam decoding are not ported).

The state is updated IN PLACE by every call that takes one (the JAX
functions donate it and return a new value). Positions follow the
reference's prepare_inputs: prefill takes mRoPE indices from
get_rope_index; decode positions are cum_len + rope_delta on all 3 axes.

Decoding runs `chunk_size` steps between host syncs: tokens are sampled on
the device, and the host reads them (and the EOS flags) once per chunk."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import InfiniteVLConfig
from .device import Device, resolve_device
from .models.infinitevl import forward, get_rope_index
from .models.state import DecoderState, init_decoder_state
from .models.text import embed_tokens, lm_head, text_forward

Params = Dict[str, Any]


def prefill(
    params: Params,
    cfg: InfiniteVLConfig,
    input_ids: torch.Tensor,  # [B, T]
    position_ids: torch.Tensor,  # [3, B, T]
    state: DecoderState,
    pixel_values: Optional[torch.Tensor] = None,
    grid_thw: Optional[Sequence[Sequence[int]]] = None,
    pixel_values_videos: Optional[torch.Tensor] = None,
    video_grid_thw: Optional[Sequence[Sequence[int]]] = None,
) -> Tuple[torch.Tensor, DecoderState]:
    """Prefill the prompt (with its images / videos, if any) into `state`
    (in place). Returns (last-token logits [B, vocab] fp32, state)."""
    logits, state = forward(
        params, cfg, input_ids, position_ids, state=state,
        pixel_values=pixel_values, grid_thw=grid_thw,
        pixel_values_videos=pixel_values_videos, video_grid_thw=video_grid_thw,
        logits_to_keep=1,
    )
    return logits[:, 0], state


def decode_step(
    params: Params,
    cfg: InfiniteVLConfig,
    token: torch.Tensor,  # [B, 1]
    rope_delta: torch.Tensor,  # [B, 1]
    state: DecoderState,
) -> Tuple[torch.Tensor, DecoderState]:
    """One decode step (state updated in place); position = cum_len +
    rope_delta on all 3 axes. Returns (logits [B, vocab] fp32, state)."""
    pos = (state["cum_len"] + rope_delta.long())[None]  # [1, B, 1]
    pos = pos.expand(3, -1, -1)
    embeds = embed_tokens(params["text"], token)
    hidden, state = text_forward(params["text"], cfg.text, embeds, pos, state)
    return lm_head(params["text"], cfg.text, hidden[:, -1]), state


def sample_token(
    logits: torch.Tensor,  # [B, vocab] fp32
    generator: Optional[torch.Generator] = None,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """Greedy (temperature 0) or top-k / top-p sampling. Returns [B] int64."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True).clamp(max=logits.shape[-1] - 1)
        cutoff = sorted_logits.gather(-1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def decode_chunk(
    params: Params,
    cfg: InfiniteVLConfig,
    token: torch.Tensor,  # [B, 1] last emitted token (the chunk's input)
    rope_delta: torch.Tensor,  # [B, 1]
    state: DecoderState,
    finished: torch.Tensor,  # [B] bool carried across chunks
    generator: Optional[torch.Generator],
    steps: int,
    eos: int,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    rep_penalty: float = 1.0,
    seen: Optional[torch.Tensor] = None,  # [B, vocab] bool, updated in place
) -> Tuple[torch.Tensor, DecoderState, torch.Tensor, Optional[torch.Tensor]]:
    """Decode `steps` tokens with no host sync: finished rows keep emitting
    eos (HF pad semantics). rep_penalty > 1 applies the HF repetition
    penalty (score / p if > 0 else score * p) to every token flagged in
    `seen`. Returns (tokens [B, steps], state, finished, seen)."""
    use_pen = rep_penalty != 1.0 and seen is not None
    rows = torch.arange(token.shape[0], device=token.device)
    toks = []
    tok = token
    for _ in range(steps):
        logits, state = decode_step(params, cfg, tok, rope_delta, state)
        if use_pen:
            pen = torch.where(logits > 0, logits / rep_penalty, logits * rep_penalty)
            logits = torch.where(seen, pen, logits)
        nxt = sample_token(logits, generator, temperature, top_k, top_p)
        nxt = nxt.masked_fill(finished, eos)
        finished = finished | (nxt == eos)
        if use_pen:
            seen[rows, nxt] = True
        toks.append(nxt)
        tok = nxt[:, None]
    return torch.stack(toks, dim=1), state, finished, (seen if use_pen else None)


def prefill_chunked(
    params: Params,
    cfg: InfiniteVLConfig,
    input_ids: torch.Tensor,  # [B, T]
    position_ids: torch.Tensor,  # [3, B, T]
    state: DecoderState,
    chunk: int = 2048,
) -> Tuple[torch.Tensor, DecoderState]:
    """Long-prompt prefill in `chunk`-token pieces carried through the
    state. With the default conv_carry=False each chunk's short conv starts
    from zero history (the reference's multi-token quirk), exactly as in
    the JAX package. Returns (last-token logits [B, vocab], state)."""
    T = input_ids.shape[1]
    if T == 0:
        raise ValueError("empty prompt")
    logits = None
    for s in range(0, T, chunk):
        logits, state = prefill(params, cfg, input_ids[:, s : s + chunk],
                                position_ids[:, :, s : s + chunk], state)
    return logits, state


def _later(what: str):
    raise NotImplementedError(f"{what} is not ported to the torch Generator yet")


def check_params_device(params: Params, device: torch.device) -> None:
    """The params must already live on the device the caller runs on."""
    have = params["text"]["embed"].device
    if have != device:
        raise ValueError(
            f"params are on {have} but the device is {device}: build or move "
            "the params there (init_params / from_jax_numpy take a device), or "
            "pass device= explicitly"
        )


class Generator:
    """Generation: prompt prefill (text prompts chunked when long,
    multimodal prompts in one pass), then chunks of on-device decode steps.
    One instance per (params, config). `device=None` means the CUDA card;
    the params must live on the device."""

    def __init__(
        self,
        params: Params,
        cfg: InfiniteVLConfig,
        dtype: Optional[torch.dtype] = None,
        chunk_size: int = 8,
        fuse: bool = False,
        quant: Optional[str] = None,
        device: Optional[Device] = None,
    ):
        if fuse:
            _later("fused projections (fuse=True)")
        if quant is not None:
            _later(f"weight quantization (quant={quant!r})")
        self.device = resolve_device(device)
        check_params_device(params, self.device)
        embed = params["text"]["embed"]
        self.params = params
        self.cfg = cfg
        # ring / conv state dtype follows the activations (the weights')
        self.dtype = dtype if dtype is not None else embed.dtype
        # decode steps per host sync; EOS overshoot is < chunk_size steps
        self.chunk_size = chunk_size
        # text prompts longer than this prefill through prefill_chunked
        self.prefill_chunk_size = 2048

    def generate_speculative(self, *args, **kwargs):
        _later("speculative decoding")

    def generate_speculative_sampled(self, *args, **kwargs):
        _later("sampled speculative decoding")

    def generate_beam(self, *args, **kwargs):
        _later("beam search")

    def generate(
        self,
        input_ids: np.ndarray,  # [B, T]
        eos_token_id: Optional[int] = None,
        **kwargs,
    ) -> np.ndarray:
        """Full generation: collects generate_stream and trims the chunk
        overshoot (each row keeps its own first EOS, HF pad semantics)."""
        eos = eos_token_id if eos_token_id is not None else self.cfg.eos_token_id
        out = np.concatenate(
            list(self.generate_stream(input_ids, eos_token_id=eos, **kwargs)), axis=1
        )
        # drop columns that are EOS padding for every row
        eos_before = np.cumsum(out == eos, axis=1) - (out == eos)
        pad_col = (eos_before >= 1).all(axis=0)
        keep = int(np.argmax(pad_col)) if pad_col.any() else out.shape[1]
        return out[:, :keep]

    def prefill_prompt(
        self,
        input_ids: np.ndarray,  # [B, T]
        pixel_values: Optional[np.ndarray] = None,
        image_grid_thw: Optional[np.ndarray] = None,
        pixel_values_videos: Optional[np.ndarray] = None,
        video_grid_thw: Optional[np.ndarray] = None,
        second_per_grid_ts=None,
        state: Optional[DecoderState] = None,
    ) -> Tuple[torch.Tensor, DecoderState, torch.Tensor]:
        """Prompt prefill shared by the decode entry points: mRoPE indices
        (get_rope_index), the count check of vision placeholders against
        the grids (reference get_placeholder_mask), a fresh state unless
        one is given (updated in place), chunked prefill for text prompts
        longer than prefill_chunk_size. Returns (last-token logits, state,
        rope_delta)."""
        cfg = self.cfg
        input_ids = np.asarray(input_ids)
        pos, deltas = get_rope_index(cfg, input_ids, image_grid_thw, video_grid_thw,
                                     second_per_grid_ts)
        if state is None:
            state = init_decoder_state(cfg.text, input_ids.shape[0],
                                       dtype=self.dtype, device=self.device)
        merge2 = cfg.vision.spatial_merge_unit

        def grids_of(arr):
            return [tuple(int(x) for x in g) for g in arr]

        def check(grids_arr, token_id, kind):
            if grids_arr is None:
                raise ValueError(f"{kind} pixel values passed without the matching "
                                 f"{kind}_grid_thw")
            grids = tuple(grids_of(grids_arr))
            n_feats = sum(t * h * w for t, h, w in grids) // merge2
            n_pads = int((input_ids == token_id).sum())
            if n_pads != n_feats:
                raise ValueError(f"{kind} features and pad tokens do not match: "
                                 f"{n_feats} features vs {n_pads} pad tokens")
            return grids

        def pixels(arr):
            return torch.as_tensor(np.asarray(arr), device=self.device)

        grid = vgrid = pv = pvv = None
        if pixel_values is not None:
            if pixel_values_videos is None and video_grid_thw is not None:
                # images and videos already concatenated into pixel_values
                grids = grids_of(image_grid_thw) if image_grid_thw is not None else []
                grid = tuple(grids + grids_of(video_grid_thw))
            else:
                grid = check(image_grid_thw, cfg.image_token_id, "image")
            pv = pixels(pixel_values)
        if pixel_values_videos is not None:
            vgrid = check(video_grid_thw, cfg.video_token_id, "video")
            pvv = pixels(pixel_values_videos)
        ids = torch.as_tensor(input_ids, dtype=torch.long, device=self.device)
        pos = torch.as_tensor(pos, device=self.device)
        if pv is None and pvv is None and input_ids.shape[1] > self.prefill_chunk_size:
            logits, state = prefill_chunked(self.params, cfg, ids, pos, state,
                                            chunk=self.prefill_chunk_size)
        else:
            logits, state = prefill(self.params, cfg, ids, pos, state,
                                    pixel_values=pv, grid_thw=grid,
                                    pixel_values_videos=pvv, video_grid_thw=vgrid)
        return logits, state, torch.as_tensor(deltas, device=self.device)

    def generate_stream(
        self,
        input_ids: np.ndarray,  # [B, T]
        pixel_values: Optional[np.ndarray] = None,
        image_grid_thw: Optional[np.ndarray] = None,
        pixel_values_videos: Optional[np.ndarray] = None,
        video_grid_thw: Optional[np.ndarray] = None,
        second_per_grid_ts=None,
        max_new_tokens: int = 128,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        repetition_penalty: float = 1.0,
        seed: int = 0,
        eos_token_id: Optional[int] = None,
        state: Optional[DecoderState] = None,
    ):
        """Token streaming: yields numpy token chunks ([B, 1] for the first
        sampled token, then [B, <= chunk_size] per decode chunk), one host
        sync per chunk."""
        cfg = self.cfg
        input_ids = np.asarray(input_ids)
        B = input_ids.shape[0]
        eos = eos_token_id if eos_token_id is not None else cfg.eos_token_id
        logits, state, rope_delta = self.prefill_prompt(
            input_ids, pixel_values=pixel_values, image_grid_thw=image_grid_thw,
            pixel_values_videos=pixel_values_videos, video_grid_thw=video_grid_thw,
            second_per_grid_ts=second_per_grid_ts, state=state,
        )
        rows = torch.arange(B, device=self.device)
        seen = None
        if repetition_penalty != 1.0:
            # HF semantics: penalize every token already in the sequence
            seen = torch.zeros((B, cfg.text.vocab_size), dtype=torch.bool, device=self.device)
            seen[rows[:, None], torch.as_tensor(input_ids, device=self.device)] = True
            pen = torch.where(logits > 0, logits / repetition_penalty,
                              logits * repetition_penalty)
            logits = torch.where(seen, pen, logits)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        tok = sample_token(logits, gen, temperature, top_k, top_p)
        t0 = tok.cpu().numpy()  # the first generated token (one sync)
        yield t0[:, None]
        if max_new_tokens <= 1 or bool(np.all(t0 == eos)):
            return
        finished = tok == eos
        if seen is not None:
            seen[rows, tok] = True
        tok_in = tok[:, None]
        remaining = max_new_tokens - 1
        while remaining > 0:
            steps = min(self.chunk_size, remaining)
            toks, state, finished, seen = decode_chunk(
                self.params, cfg, tok_in, rope_delta, state, finished, gen,
                steps=steps, eos=eos, temperature=temperature, top_k=top_k,
                top_p=top_p, rep_penalty=repetition_penalty, seen=seen,
            )
            out = toks.cpu().numpy()  # ONE host sync per chunk
            yield out
            remaining -= steps
            if bool(np.all(out[:, -1] == eos)):
                return
            tok_in = toks[:, -1:]
