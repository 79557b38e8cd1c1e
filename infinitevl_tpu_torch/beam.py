"""Beam search decoding, HF BeamSearchScorer semantics (torch port of
infinitevl_tpu/beam.py).

- the per-step compute is `_beam_step`: the decode forward over the B*K
  beam-expanded batch, fp32 log-softmax, cumulative-score add and top-2K
  over the K*V candidate grid, on the device;
- `_reorder_state_impl` moves every beam's ring KV / delta state to its
  parent's slot: an index_select on the batch axis into FRESH tensors (the
  state a step reads is never the one being written);
- the candidate bookkeeping (finished-hypothesis pool, length penalty,
  early stopping) is O(K) python on 2K scalars per step, mirroring
  transformers' BeamSearchScorer.process / finalize token for token.

Beam search is a quality knob, not a throughput path: one host round trip
per step, and each step reads the weights once for all K beams.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import InfiniteVLConfig
from .generation import decode_step, prefill, prefill_chunked
from .models.infinitevl import get_rope_index
from .models.state import DecoderState, init_decoder_state


def _beam_step(params, cfg: InfiniteVLConfig, tokens, rope_delta, state,
               beam_scores, k2: int):
    """One beam-expanded decode step (state advanced in place). tokens
    [B*K, 1], beam_scores [B, K] (cumulative sum-logprobs). Returns (top-k2
    scores, parent beam ids, token ids, each [B, k2]) and the state."""
    logits, state = decode_step(params, cfg, tokens, rope_delta, state)
    lp = torch.log_softmax(logits.float(), dim=-1)  # [B*K, V]
    B, K = beam_scores.shape
    V = lp.shape[-1]
    cand = lp.reshape(B, K, V) + beam_scores[:, :, None]
    scores, idx = torch.topk(cand.reshape(B, K * V), k2, dim=-1)
    return scores, idx // V, idx % V, state


def _reorder_state_impl(state: DecoderState, idx: torch.Tensor) -> DecoderState:
    """Gather beams to their parents' slots. Every tensor carries batch on
    axis 1 (models/state.init_decoder_state); cum_len is shared. Returns a
    new state of fresh tensors."""
    return {
        k: (v.index_select(1, idx) if isinstance(v, torch.Tensor) else v)
        for k, v in state.items()
    }


class _Hyps:
    """transformers BeamHypotheses mirror (generation/beam_search.py:929-
    1001): at most K finished hypotheses, worst evicted, length-penalized
    scores over GENERATED length (decoder_prompt_len excluded)."""

    def __init__(self, k: int, length_penalty: float, early_stopping,
                 max_gen_len: int):
        self.k = k
        self.lp = length_penalty
        self.es = early_stopping
        self.max_gen_len = max_gen_len
        self.beams = []  # (penalized score, np tokens)
        self.worst = 1e9

    def add(self, tokens: np.ndarray, sum_logprobs: float, generated_len: int):
        score = sum_logprobs / (generated_len**self.lp)
        if len(self.beams) < self.k or score > self.worst:
            self.beams.append((score, tokens))
            if len(self.beams) > self.k:
                i = min(range(len(self.beams)), key=lambda j: self.beams[j][0])
                self.beams.pop(i)
            self.worst = min(s for s, _ in self.beams)

    def is_done(self, best_sum_logprobs: float, gen_len: int) -> bool:
        if len(self.beams) < self.k:
            return False
        if self.es is True:
            return True
        if self.es is False:
            return self.worst >= best_sum_logprobs / (gen_len**self.lp)
        # "never": bound by max_length when the penalty rewards length
        ref_len = self.max_gen_len if self.lp > 0.0 else gen_len
        return self.worst >= best_sum_logprobs / (ref_len**self.lp)

    def best(self) -> np.ndarray:
        return max(self.beams, key=lambda sb: sb[0])[1]


def beam_search(
    gen,  # generation.Generator
    input_ids: np.ndarray,  # [B, T]
    num_beams: int = 4,
    max_new_tokens: int = 128,
    eos_token_id: Optional[int] = None,
    length_penalty: float = 1.0,
    early_stopping=False,
) -> np.ndarray:
    """Greedy beam search, HF semantics (do_sample=False, num_return=1).
    Returns [B, <=max_new_tokens] generated tokens (prompt excluded), rows
    padded with eos. Text-only: the reference's beam path expands pixel
    tensors per beam (modeling_infinitevl.py:2221-2314), but for chat the
    ViT runs once at prefill here, so images would only multiply the
    prefill cost K-fold for identical features — feed multimodal prompts
    through Generator.generate and reserve beams for the text turn."""
    cfg = gen.cfg
    ids = np.asarray(input_ids)
    B, T = ids.shape
    K = int(num_beams)
    if K < 2:
        raise ValueError("num_beams must be >= 2 (use generate for greedy)")
    eos = eos_token_id if eos_token_id is not None else cfg.eos_token_id
    k2 = 2 * K

    pos, deltas = get_rope_index(cfg, ids)
    dev = gen.device
    state = init_decoder_state(cfg.text, B, dtype=gen.dtype, device=dev)
    t_ids = torch.as_tensor(ids, dtype=torch.long, device=dev)
    t_pos = torch.as_tensor(pos, device=dev)
    if T > gen.prefill_chunk_size:
        logits, state = prefill_chunked(gen.params, cfg, t_ids, t_pos, state,
                                        chunk=gen.prefill_chunk_size)
    else:
        logits, state = prefill(gen.params, cfg, t_ids, t_pos, state)
    # beam-expand: each prompt's state replicated into K adjacent slots
    rep = np.repeat(np.arange(B), K)
    state = _reorder_state_impl(state, torch.as_tensor(rep, device=dev))
    rope_delta = torch.as_tensor(np.repeat(deltas, K, axis=0), device=dev)

    lp0 = torch.log_softmax(logits.float(), dim=-1).cpu().numpy()  # [B, V]
    V = lp0.shape[-1]
    beam_scores = np.full((B, K), -1e9, np.float32)
    beam_scores[:, 0] = 0.0  # HF init: only beam 0 live at step 0

    hyps = [_Hyps(K, length_penalty, early_stopping, max_new_tokens)
            for _ in range(B)]
    done = [False] * B
    seqs = np.zeros((B, K, 0), np.int64)

    def process(b, sc, par, tok, gen_len):
        """BeamSearchScorer.process for one batch row: walk the 2K
        candidates best-first; eos candidates ranked < K finish a
        hypothesis, the rest fill the K running beams."""
        nsc = np.empty(K, np.float32)
        npar = np.empty(K, np.int64)
        ntok = np.empty(K, np.int64)
        j = 0
        for rank in range(k2):
            if int(tok[rank]) == eos:
                if rank >= K:
                    continue
                hyps[b].add(
                    seqs[b, int(par[rank])].copy(), float(sc[rank]), gen_len
                )
            else:
                nsc[j], npar[j], ntok[j] = sc[rank], par[rank], tok[rank]
                j += 1
            if j == K:
                break
        assert j == K, "fewer than K non-eos candidates in top 2K"
        done[b] = done[b] or hyps[b].is_done(float(sc.max()), gen_len)
        return nsc, npar, ntok

    step_tokens = np.zeros((B, K), np.int64)
    for t in range(max_new_tokens):
        if t == 0:
            cand = beam_scores[:, :, None] + lp0[:, None, :]
            flat = cand.reshape(B, K * V)
            idx = np.argpartition(-flat, k2 - 1, axis=1)[:, :k2]
            order = np.argsort(-np.take_along_axis(flat, idx, 1), axis=1)
            idx = np.take_along_axis(idx, order, 1)
            sc_all = np.take_along_axis(flat, idx, 1)
            par_all, tok_all = idx // V, idx % V
        else:
            sc_d, par_d, tok_d, state = _beam_step(
                gen.params, cfg,
                torch.as_tensor(step_tokens.reshape(B * K, 1), device=dev),
                rope_delta, state, torch.as_tensor(beam_scores, device=dev), k2,
            )
            sc_all = sc_d.cpu().numpy()
            par_all = par_d.cpu().numpy()
            tok_all = tok_d.cpu().numpy()
        parents = np.zeros((B, K), np.int64)
        for b in range(B):
            if done[b]:
                # HF pads finished rows; freeze their beams instead
                parents[b] = np.arange(K)
                step_tokens[b] = eos
                continue
            nsc, npar, ntok = process(
                b, sc_all[b], par_all[b], tok_all[b], gen_len=t + 1
            )
            beam_scores[b], parents[b], step_tokens[b] = nsc, npar, ntok
        seqs = np.concatenate(
            [
                np.take_along_axis(seqs, parents[:, :, None], axis=1),
                step_tokens[:, :, None],
            ],
            axis=2,
        )
        if all(done):
            break
        if t + 1 < max_new_tokens:
            gidx = (np.arange(B)[:, None] * K + parents).reshape(-1)
            state = _reorder_state_impl(state, torch.as_tensor(gidx, device=dev))

    # finalize (beam_search.py:326-366): top off each unfinished pool with
    # its running beams at full generated length
    for b in range(B):
        if not done[b]:
            for i in range(K):
                hyps[b].add(seqs[b, i], float(beam_scores[b, i]),
                            generated_len=seqs.shape[2])
    best = [hyps[b].best() for b in range(B)]
    L = max(len(x) for x in best)
    out = np.full((B, L), eos, np.int64)
    for b, row in enumerate(best):
        out[b, : len(row)] = row
    return out
