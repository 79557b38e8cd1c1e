"""Long documents, one client in a closed loop: each request is a document
of `doc_lengths[i % len]` tokens plus a `question_tokens` question, token
ids drawn from the seed for request i (every document its own), answered
with `answer_tokens` greedy tokens through `Generator.generate_stream` at
B 1, the prompt prefilled in chunks of the Generator's 2,048. Time to first
token runs from the call to generate_stream to its first yielded token.

Set-up serves one request of the longest length (its own ids), which warms
every shape the window uses: prefill chunks of 2,048, the question's short
last chunk, decode steps, with the ring full.

Correctness: once the window has closed, `check_requests` finished
requests drawn from the seed, the longest document among them, are run by
the plain fp32 reference over the prompt and the served tokens. The number
compared is the mean, over the served tokens, of the gap by which a served
token's logit lies below the reference's best at its position. The widest
gap is printed beside it; with random weights the top logits lie close, so
bf16 rounding alone picks tokens up to ~0.8 below the best and the fp8
control's widest gap is under three times that."""

from __future__ import annotations

import time

import numpy as np


def prompt(traffic, seed: int, i: int) -> np.ndarray:
    """Request i's prompt ids [1, T]: its document and its question."""
    rng = np.random.default_rng([int(seed), 2, i])
    L = traffic["doc_lengths"][i % len(traffic["doc_lengths"])] + traffic["question_tokens"]
    return rng.integers(0, traffic["id_high"], size=(1, L), dtype=np.int64)


def warm_prompt(traffic, seed: int) -> np.ndarray:
    rng = np.random.default_rng([int(seed), 3])
    L = max(traffic["doc_lengths"]) + traffic["question_tokens"]
    return rng.integers(0, traffic["id_high"], size=(1, L), dtype=np.int64)


def served(chunks, eos: int) -> list:
    """The tokens a client receives: up to and with the first EOS."""
    out = []
    for c in chunks:
        for t in np.asarray(c).reshape(-1).tolist():
            out.append(int(t))
            if t == eos:
                return out
    return out


def run(ctx):
    import torch
    from harness import flops, trace
    from harness.context import DriverResult, Readings
    from harness.stats import median
    from harness.weights import build, port_config
    from infinitevl_tpu_torch.generation import Generator

    tr, spec, dev = ctx.cell.traffic, ctx.cell.config, ctx.device
    cfg = port_config(spec)
    params = build(spec, ctx.seed, dev, with_vision=False)
    gen = Generator({"text": params["text"]}, cfg, device=dev)
    new = tr["answer_tokens"]
    rf = torch.profiler.record_function

    def request(ids):
        t0 = time.perf_counter()
        with rf("bench.prefill_and_first_token"):
            stream = gen.generate_stream(ids, max_new_tokens=new)
            first = next(stream)
        t1 = time.perf_counter()
        with rf("bench.decode"):
            rest = list(stream)
        return t1 - t0, served([first] + rest, cfg.eos_token_id)

    request(warm_prompt(tr, ctx.seed))
    setup_s = time.perf_counter() - ctx.t_process

    done = []  # (request index, ttft seconds, served tokens)
    i = 0
    t_start = time.perf_counter()
    t_end = t_start + ctx.seconds
    while time.perf_counter() < t_end:
        ttft, toks = request(prompt(tr, ctx.seed, i))
        done.append((i, ttft, toks))
        i += 1

    summary, calls = None, {}
    if ctx.trace:
        n_traced = len(tr["doc_lengths"])
        traced = [prompt(tr, ctx.seed, j) for j in range(i, i + n_traced)]
        with trace.profiled() as prof:
            with trace.window_mark():
                for ids in traced:
                    request(ids)
        summary = trace.summarize(prof, n_traced)
        calls = declared_calls(cfg, [x.shape[1] for x in traced], gen.prefill_chunk_size)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    chunk = gen.prefill_chunk_size
    del gen, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    sample = check_sample(tr, ctx.seed, done)
    mean_gap, widest = compare(spec, ctx.seed, dev, tr, sample, chunk)
    checks = {"answer_gap_mean": mean_gap}
    ttfts = [t for _, t, _ in done]
    prompt_flops = sum(flops.prefill_flops(spec, prompt(tr, ctx.seed, j).shape[1], chunk)
                       for j, _, _ in done)
    e2e = {"ttft_p50_ms": 1e3 * median(ttfts), "setup_s": setup_s}
    window = {"prefill_flops": prompt_flops, "ttft_sum_s": sum(ttfts)}
    return DriverResult(end_to_end=e2e, attempted=len(done), failed=0, checks=checks,
                        memory_peak_bytes=int(peak),
                        readings=Readings(ctx.cell.bench_dir, summary, calls, window),
                        notes=[f"requests {len(done)}, checked {[j for j, _ in sample]}, "
                               f"widest gap {widest!r} (not compared: no control separates it)"],
                        checked=sample)


def control(cell, seed: int, dev, matmul, sample):
    """The control's reading on the requests a run of `seed` checked: at each
    of their served positions, the fp32 reference's gap of the token that
    `matmul`'s arithmetic puts first."""
    mean_gap, widest = compare(cell.config, seed, dev, cell.traffic, sample, 2048,
                               matmul=matmul, control=True)
    return {"answer_gap_mean": mean_gap, "answer_gap_widest": widest}


def check_sample(traffic, seed: int, done):
    """`check_requests` finished requests drawn from the seed, one of the
    longest documents among them: [(index, served tokens)]."""
    rng = np.random.default_rng([int(seed), 4])
    n = len(traffic["doc_lengths"])
    longest = max(traffic["doc_lengths"])
    idx = [k for k, (i, _, _) in enumerate(done) if traffic["doc_lengths"][i % n] == longest]
    first = idx[int(rng.integers(len(idx)))] if idx else int(rng.integers(len(done)))
    others = [k for k in range(len(done)) if k != first]
    pick = [first] + [int(k) for k in rng.choice(others, min(len(others),
                                                             traffic["check_requests"] - 1),
                                                 replace=False)]
    return [(done[k][0], done[k][2]) for k in sorted(pick)]


def declared_calls(cfg, lengths, chunk: int):
    """Kernel calls of the traced requests' prefills: C per DeltaNet layer
    and A1 per SWA layer for every chunk longer than the recurrence's
    threshold."""
    tc = cfg.text
    calls = {"delta_chunk": [], "swa_ring": []}
    for L in lengths:
        for t0 in range(0, L, chunk):
            T = min(chunk, L - t0)
            for i in range(tc.num_hidden_layers):
                role = tc.layer_role(i)
                if role == "linear_attention" and T > tc.recurrent_threshold:
                    calls["delta_chunk"].append(dict(B=1, T=T, H=tc.num_linear_heads,
                                                     K=tc.linear_head_dim, V=tc.head_v_dim))
                elif role == "sliding_attention" and T > 1:
                    calls["swa_ring"].append(dict(B=1, T=T, Hq=tc.num_attention_heads,
                                                  Hkv=tc.num_key_value_heads, D=tc.head_dim,
                                                  cap=tc.swa_capacity, cum_len=t0,
                                                  window=tc.sliding_window))
    return {k: c for k, c in calls.items() if c}


def compare(spec, seed, dev, traffic, sample, chunk: int, matmul=None, control=False):
    """The gaps, over the sampled requests' served tokens, between the
    reference's best logit and the served token's logit at its position:
    (their mean, the widest). With `control` the token judged at each
    position is the one `matmul`'s arithmetic puts first (the control's
    reading)."""
    import torch
    from harness.weights import build
    from reference import infinitevl as ref

    ref.fp32_exact()
    S = ref.Sizes(spec)
    params = build(spec, seed, dev, with_vision=False)
    gaps = []
    for i, toks in sample:
        ids = prompt(traffic, seed, i)[0]
        P, n = ids.shape[0], len(toks)
        seq = torch.as_tensor(np.concatenate([ids, np.asarray(toks[:-1], np.int64)]), device=dev)
        pos, conv_start = ref.text_sequence(P, n - 1, chunk, dev)
        at = list(range(P - 1, P - 1 + n))
        _, logits = ref.decoder(params["text"], S, ref.embed(params["text"], seq), pos, conv_start,
                                logits_at=at)
        judged = torch.as_tensor(toks, device=dev)
        if control:
            _, low = ref.decoder(params["text"], S, ref.embed(params["text"], seq), pos,
                                 conv_start, logits_at=at, mm=matmul)
            judged = low.argmax(-1)
        gaps += (logits.max(-1).values - logits.gather(1, judged[:, None])[:, 0]).tolist()
    return sum(gaps) / len(gaps), max(gaps)
