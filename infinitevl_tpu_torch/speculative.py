"""Lossless speculative decoding with prompt-lookup drafts (torch port of
infinitevl_tpu/speculative.py).

Batch-1 decode is bound by the weight read, so a K-token verify forward
costs about one decode step and every accepted draft token is nearly
free. Drafts come from prompt lookup (n-gram continuation from the context
itself): no draft model, no extra weights.

Losslessness: greedy output is IDENTICAL to Generator.generate; drafts are
verified against the model's own argmax and rejected tokens are never
committed.

State discipline: the port updates the state in place, so `spec_verify`
(generation.py) runs the K-token window on a COPY of the state; that copy
becomes the state only when every input token was accepted. On partial
acceptance the accepted prefix re-runs on the original state through
`spec_commit`, which advances it in place.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from .generation import decode_step, prefill, spec_commit, spec_verify
from .models.infinitevl import get_rope_index
from .models.state import init_decoder_state


def _tokens(gen, ids) -> torch.Tensor:
    return torch.as_tensor(np.asarray(ids), dtype=torch.long, device=gen.device)


def _host(logits: torch.Tensor) -> np.ndarray:
    return logits.float().cpu().numpy()


@dataclasses.dataclass
class SpecStats:
    """Acceptance instrumentation for one speculative generation.

    Acceptance is workload-dependent (prompt lookup hits on repetitive
    text), so the serving layers report MEASURED numbers per request:
    `tokens_per_forward` is the realized speedup proxy, tokens emitted per
    model forward (each about one weight read)."""

    windows: int = 0         # verify forwards (a draft was found)
    fallback_steps: int = 0  # ordinary decode steps (no lookup hit)
    commit_steps: int = 0    # partial-acceptance re-runs (extra forwards)
    drafted: int = 0         # draft tokens fed to verify windows
    accepted: int = 0        # draft tokens the model's argmax confirmed
    emitted: int = 0         # tokens appended to the output

    @property
    def forwards(self) -> int:
        """Model forwards after prefill (each ≈ one weight read)."""
        return self.windows + self.fallback_steps + self.commit_steps

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0

    @property
    def mean_accepted(self) -> float:
        """E[accepted draft tokens] per verify window."""
        return self.accepted / self.windows if self.windows else 0.0

    @property
    def tokens_per_forward(self) -> float:
        return self.emitted / self.forwards if self.forwards else 0.0

    def summary(self) -> str:
        return (
            f"spec: {self.emitted} tok / {self.forwards} forwards "
            f"({self.tokens_per_forward:.2f} tok/fwd), "
            f"accept {self.accepted}/{self.drafted} "
            f"({100 * self.acceptance_rate:.0f}%), "
            f"E[accepted|window]={self.mean_accepted:.2f}, "
            f"{self.fallback_steps} fallback steps"
        )


def prompt_lookup_draft(
    ctx: np.ndarray,  # [T] int token ids, prompt + generated so far
    k: int,
    ngram_max: int = 3,
    ngram_min: int = 1,
) -> np.ndarray:
    """Propose up to k continuation tokens by matching the longest n-gram
    suffix of `ctx` against its own history and copying what followed an
    earlier occurrence. Returns [<=k] (possibly empty).

    Occurrence choice: the LATEST occurrence whose continuation has all k
    tokens available; if none does, the occurrence with the longest
    available continuation (latest wins ties). Always taking the latest
    occurrence would truncate the draft whenever the match sits near the
    tail, the common case on repetitive text."""
    T = len(ctx)
    if T < 2 or k <= 0:
        return np.empty(0, dtype=ctx.dtype)
    for n in range(min(ngram_max, T - 1), ngram_min - 1, -1):
        pat = ctx[T - n :]
        win = np.lib.stride_tricks.sliding_window_view(ctx[:-1], n)
        hits = np.nonzero((win == pat).all(axis=1))[0]
        if len(hits):
            starts = hits + n
            avail = np.minimum(T - starts, k)
            start = int(starts[avail == avail.max()][-1])
            cand = ctx[start : start + k]
            if len(cand):
                return np.asarray(cand)
    return np.empty(0, dtype=ctx.dtype)


def generate_speculative(
    gen,  # generation.Generator
    input_ids: np.ndarray,  # [1, T] prompt (text or multimodal)
    max_new_tokens: int = 128,
    draft_k: int = 8,
    ngram_max: int = 3,
    eos_token_id: Optional[int] = None,
    stats: Optional[SpecStats] = None,
    pixel_values: Optional[np.ndarray] = None,
    image_grid_thw: Optional[np.ndarray] = None,
    pixel_values_videos: Optional[np.ndarray] = None,
    video_grid_thw: Optional[np.ndarray] = None,
    second_per_grid_ts=None,
    draft_fn=None,
) -> np.ndarray:
    """Greedy generation with prompt-lookup speculation. Returns [1, <=N].
    Pass a `SpecStats` to collect measured acceptance for this request.

    `draft_fn(ctx, k) -> np.ndarray[<=k]` overrides the draft source
    (default: prompt lookup). Losslessness is draft-source independent —
    every draft is verified against the model's own argmax — so this is
    both the hook for alternative drafters (a small draft model, a
    retrieval cache) and a way to force a chosen acceptance in a test.

    Multimodal prompts are first-class: the prefill runs the full
    ViT-scatter path (Generator.prefill_prompt) and the decode loop is
    text-only by construction — exactly where prompt lookup helps (long
    text answers about an image/video). Draft candidates copied from the
    vision-pad span of the prompt are verified like any other token: the
    model's argmax never emits a pad id, so they are simply rejected.

    Restriction (documented, loud): batch 1 — acceptance length diverges
    per row; use generate_speculative_batched for synchronized batches."""
    cfg = gen.cfg
    ids = np.asarray(input_ids)
    if ids.ndim != 2 or ids.shape[0] != 1:
        raise ValueError(
            "speculative decoding is batch-1 only (per-row acceptance "
            f"lengths diverge); got shape {ids.shape}"
        )
    if draft_k < 2:
        raise ValueError("draft_k must be >= 2 (one input slot + drafts)")
    eos = eos_token_id if eos_token_id is not None else cfg.eos_token_id

    logits, state, rope_delta = gen.prefill_prompt(
        ids,
        pixel_values=pixel_values,
        image_grid_thw=image_grid_thw,
        pixel_values_videos=pixel_values_videos,
        video_grid_thw=video_grid_thw,
        second_per_grid_ts=second_per_grid_ts,
    )

    last = int(torch.argmax(logits, dim=-1)[0])
    out: List[int] = [last]
    ctx = np.concatenate([ids[0], [last]])

    if draft_fn is None:
        def draft_fn(c, k):
            return prompt_lookup_draft(c, k, ngram_max=ngram_max)
    if stats is None:
        stats = SpecStats()  # local collection; caller's object if given
    emitted0 = stats.emitted  # accumulative across requests; see return
    while len(out) < max_new_tokens and last != eos:
        drafts = np.asarray(draft_fn(ctx, draft_k - 1)).astype(ctx.dtype)
        drafts = drafts[: draft_k - 1]  # over-long custom drafts: trim
        if len(drafts) == 0:
            # no lookup hit: ordinary single decode step (in place)
            logits, state = decode_step(gen.params, cfg, _tokens(gen, [[last]]),
                                        rope_delta, state)
            last = int(torch.argmax(logits, dim=-1)[0])
            out.append(last)
            ctx = np.append(ctx, last)
            stats.fallback_steps += 1
            stats.emitted += 1
            continue
        window = np.concatenate([[last], drafts]).astype(np.int64)[None]
        vlogits, vstate = spec_verify(gen.params, cfg, _tokens(gen, window),
                                      rope_delta, state)
        m = torch.argmax(vlogits, dim=-1)[0].cpu().numpy()  # [K] model argmax
        j = 0
        while j < len(drafts) and int(drafts[j]) == int(m[j]):
            j += 1
        committed = [int(t) for t in drafts[:j]] + [int(m[j])]
        if j == len(drafts):
            # every input token accepted: the verify state is exact
            state = vstate
        else:
            # re-run the accepted prefix on the ORIGINAL state (in place)
            _, state = spec_commit(gen.params, cfg, _tokens(gen, window[:, : j + 1]),
                                   rope_delta, state)
            stats.commit_steps += 1
        stats.windows += 1
        stats.drafted += len(drafts)
        stats.accepted += j
        stats.emitted += len(committed)
        out.extend(committed)
        ctx = np.concatenate([ctx, np.asarray(committed, dtype=ctx.dtype)])
        last = committed[-1]
        if eos in committed:
            out = out[: out.index(eos) + 1]
            break

    final = out[:max_new_tokens]
    # the loop counts whole committed windows, but eos truncation and the
    # max_new_tokens trim can drop up to draft_k-1 of those tokens from the
    # returned array — re-anchor emitted to what the caller actually gets
    # (len-1: the first token comes from prefill and was never counted), so
    # usage.speculation reports realized output, not pre-trim commits.
    stats.emitted = emitted0 + max(0, len(final) - 1)
    return np.asarray(final, dtype=np.int64)[None]


def processed_probs(
    logits: np.ndarray,  # [V] fp32
    temperature: float,
    top_k: int = 0,
    top_p: float = 1.0,
) -> np.ndarray:
    """The SAMPLING distribution: generation.sample_token's temperature /
    top-k / top-p processing mirrored in numpy, returned as probabilities.
    Rejection-sampled speculation must verify against exactly this
    distribution or it stops being lossless."""
    x = logits.astype(np.float64) / float(temperature)
    if top_k > 0:
        kth = np.sort(x)[-top_k]
        x = np.where(x < kth, -np.inf, x)
    if top_p < 1.0:
        sorted_x = np.sort(x)[::-1]
        e = np.exp(sorted_x - sorted_x[0])
        probs = e / e.sum()
        cum = np.cumsum(probs)
        cutoff_idx = int(np.sum(cum < top_p))
        cutoff = sorted_x[cutoff_idx]
        x = np.where(x < cutoff, -np.inf, x)
    x = x - x.max()
    p = np.exp(x)
    return (p / p.sum()).astype(np.float64)


def generate_speculative_sampled(
    gen,  # generation.Generator
    input_ids: np.ndarray,  # [1, T] prompt (text or multimodal)
    max_new_tokens: int = 128,
    draft_k: int = 8,
    temperature: float = 0.7,
    top_k: int = 0,
    top_p: float = 1.0,
    ngram_max: int = 3,
    seed: int = 0,
    eos_token_id: Optional[int] = None,
    stats: Optional[SpecStats] = None,
    pixel_values: Optional[np.ndarray] = None,
    image_grid_thw: Optional[np.ndarray] = None,
    pixel_values_videos: Optional[np.ndarray] = None,
    video_grid_thw: Optional[np.ndarray] = None,
    second_per_grid_ts=None,
) -> np.ndarray:
    """LOSSLESS sampled speculation: rejection sampling over prompt-lookup
    drafts, so draft_k composes with temperature/top-k/top-p.

    The draft distribution is a point mass q = one-hot(draft), so the
    speculative-sampling rule (Leviathan et al. / Chen et al.) reduces to:
    accept draft d_j with prob min(1, p_j(d_j)); on reject, resample from
    norm(max(p_j - q_j, 0)) = p_j with d_j zeroed, renormalized. The
    emitted token stream is distributed EXACTLY as sampling p_j directly —
    tested statistically in tests/test_speculative.py.

    p_j is the post-processing distribution (temperature/top-k/top-p,
    `processed_probs`), matching what Generator.generate samples.
    Multimodal prompts prefill through Generator.prefill_prompt like the
    greedy path. Batch-1 (per-row acceptance lengths diverge)."""
    cfg = gen.cfg
    ids = np.asarray(input_ids)
    if ids.ndim != 2 or ids.shape[0] != 1:
        raise ValueError(
            "speculative decoding is batch-1 only (per-row acceptance "
            f"lengths diverge); got shape {ids.shape}"
        )
    if draft_k < 2:
        raise ValueError("draft_k must be >= 2 (one input slot + drafts)")
    if temperature <= 0.0:
        raise ValueError(
            "temperature must be > 0 for sampled speculation; use "
            "generate_speculative for greedy"
        )
    eos = eos_token_id if eos_token_id is not None else cfg.eos_token_id
    rng = np.random.RandomState(seed)

    def draw(logits_row: np.ndarray) -> int:
        p = processed_probs(logits_row, temperature, top_k, top_p)
        return int(rng.choice(len(p), p=p))

    logits, state, rope_delta = gen.prefill_prompt(
        ids,
        pixel_values=pixel_values,
        image_grid_thw=image_grid_thw,
        pixel_values_videos=pixel_values_videos,
        video_grid_thw=video_grid_thw,
        second_per_grid_ts=second_per_grid_ts,
    )

    last = draw(_host(logits)[0])
    out: List[int] = [last]
    ctx = np.concatenate([ids[0], [last]])

    if stats is None:
        stats = SpecStats()
    emitted0 = stats.emitted
    while len(out) < max_new_tokens and last != eos:
        drafts = prompt_lookup_draft(ctx, draft_k - 1, ngram_max=ngram_max)
        if len(drafts) == 0:
            logits, state = decode_step(gen.params, cfg, _tokens(gen, [[last]]),
                                        rope_delta, state)
            last = draw(_host(logits)[0])
            out.append(last)
            ctx = np.append(ctx, last)
            stats.fallback_steps += 1
            stats.emitted += 1
            continue
        window = np.concatenate([[last], drafts]).astype(np.int64)[None]
        vlogits, vstate = spec_verify(gen.params, cfg, _tokens(gen, window),
                                      rope_delta, state)
        vl = _host(vlogits)[0]  # [K, V]
        j = 0
        resampled = None
        while j < len(drafts):
            p = processed_probs(vl[j], temperature, top_k, top_p)
            d = int(drafts[j])
            if rng.uniform() <= p[d]:
                j += 1
                continue
            # reject: residual distribution = p with the draft zeroed
            # (q is a point mass, so max(p - q, 0) keeps everything else)
            p = p.copy()
            p[d] = 0.0
            p = p / p.sum()
            resampled = int(rng.choice(len(p), p=p))
            break
        if resampled is None:
            # every draft accepted: bonus token from the window's last slot
            resampled = draw(vl[len(drafts)])
            state = vstate  # all inputs accepted -> verify state is exact
        else:
            _, state = spec_commit(gen.params, cfg, _tokens(gen, window[:, : j + 1]),
                                   rope_delta, state)
            stats.commit_steps += 1
        committed = [int(t) for t in drafts[:j]] + [resampled]
        stats.windows += 1
        stats.drafted += len(drafts)
        stats.accepted += j
        stats.emitted += len(committed)
        out.extend(committed)
        ctx = np.concatenate([ctx, np.asarray(committed, dtype=ctx.dtype)])
        last = committed[-1]
        if eos in committed:
            out = out[: out.index(eos) + 1]
            break

    final = out[:max_new_tokens]
    stats.emitted = emitted0 + max(0, len(final) - 1)
    return np.asarray(final, dtype=np.int64)[None]


def generate_speculative_batched(
    gen,  # generation.Generator
    input_ids: np.ndarray,  # [B, T] text-only prompts (same padded length)
    max_new_tokens: int = 128,
    draft_k: int = 8,
    ngram_max: int = 3,
    eos_token_id: Optional[int] = None,
    stats: Optional[SpecStats] = None,
) -> np.ndarray:
    """Batched greedy speculation with SYNCHRONIZED commits.

    The decoder state carries ONE shared cum_len (models/state.py),
    so all rows must advance together. Each round verifies a K-token
    window for every row and commits c = min_b(accepted_b) + 1 tokens:
    every committed token was verified against its own row's argmax, so
    each row's output is token-for-token identical to row-wise greedy
    decoding (tested). Rows that accepted more than c drafts simply
    re-verify the surplus next round — correctness is untouched; only the
    speedup degrades toward the slowest row (E[min acceptance] falls with
    B, which is why batch-1 remains the default serving route and this
    exists for small same-workload batches, e.g. n > 1 completions of one
    prompt).

    Rows that hit EOS freeze: their window slots turn into EOS padding
    (HF pad semantics) and their acceptance no longer drags the min.
    """
    cfg = gen.cfg
    ids = np.asarray(input_ids)
    B = ids.shape[0]
    if draft_k < 2:
        raise ValueError("draft_k must be >= 2 (one input slot + drafts)")
    eos = eos_token_id if eos_token_id is not None else cfg.eos_token_id
    K = draft_k  # window length: 1 input slot + K-1 drafts

    pos, deltas = get_rope_index(cfg, ids)
    state = init_decoder_state(cfg.text, B, dtype=gen.dtype, device=gen.device)
    logits, state = prefill(gen.params, cfg, _tokens(gen, ids),
                            torch.as_tensor(pos, device=gen.device), state)
    rope_delta = torch.as_tensor(deltas, device=gen.device)

    last = torch.argmax(logits, dim=-1).cpu().numpy().astype(np.int64)  # [B]
    out = [[int(t)] for t in last]
    ctx = [np.concatenate([ids[b], [last[b]]]) for b in range(B)]
    finished = np.asarray(
        [int(t) == eos or max_new_tokens <= 1 for t in last]
    )

    if stats is None:
        stats = SpecStats()
    emitted0 = stats.emitted
    while not finished.all():
        # per-row drafts, padded to a common K-1 with eos (finished rows)
        # or the row's last token (live rows without a lookup hit — their
        # acceptance is whatever the model's argmax happens to repeat)
        window = np.empty((B, K), np.int64)
        n_drafted = 0
        for b in range(B):
            window[b, 0] = last[b]
            if finished[b]:
                window[b, 1:] = eos
                continue
            d = prompt_lookup_draft(ctx[b], K - 1, ngram_max=ngram_max)
            # filler slots count as drafts too (they are verified like any)
            n_drafted += K - 1
            fill = np.full(K - 1, last[b], np.int64)
            fill[: len(d)] = d
            window[b, 1:] = fill
        vlogits, vstate = spec_verify(gen.params, cfg, _tokens(gen, window),
                                      rope_delta, state)
        m = torch.argmax(vlogits, dim=-1).cpu().numpy()  # [B, K]
        acc = np.zeros(B, np.int64)
        for b in range(B):
            if finished[b]:
                acc[b] = K - 1  # frozen rows never drag the min
                continue
            j = 0
            while j < K - 1 and window[b, j + 1] == m[b, j]:
                j += 1
            acc[b] = j
        live = ~finished
        c = int(min(acc[live]) + 1) if live.any() else K
        c = min(c, K)
        if c == K:
            state = vstate  # every row accepted its full window
        else:
            _, state = spec_commit(gen.params, cfg, _tokens(gen, window[:, :c]),
                                   rope_delta, state)
            stats.commit_steps += 1
        stats.windows += 1
        stats.drafted += n_drafted
        stats.accepted += int(np.minimum(acc[live], c - 1).sum()) if live.any() else 0
        for b in range(B):
            if finished[b]:
                continue
            # committed tokens for this row: verified drafts up to c-1,
            # then the model's own argmax at slot c-1 (equal to the draft
            # wherever the draft was accepted)
            row = [int(t) for t in window[b, 1:c]] + [int(m[b, c - 1])]
            for t in row:
                out[b].append(t)
                ctx[b] = np.append(ctx[b], t)
                stats.emitted += 1
                if t == eos or len(out[b]) >= max_new_tokens:
                    finished[b] = True
                    break
            last[b] = out[b][-1]

    L = min(max_new_tokens, max(len(o) for o in out))
    res = np.full((B, L), eos, np.int64)
    for b in range(B):
        row = out[b][:L]
        if eos in row:
            row = row[: row.index(eos) + 1]
        res[b, : len(row)] = row
    stats.emitted = emitted0 + sum(
        max(0, min(len(o), L) - 1) for o in out
    )
    return res
