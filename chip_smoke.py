#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (`infinitevl_tpu_torch`) on one
NVIDIA H100.

    python3 chip_smoke.py                 # all phases; needs one CUDA card and nvcc
    python3 chip_smoke.py --kernels-only  # phases 1-3: build and kernel parity

Phases (each prints one line; any failure raises and the exit code is
non-zero):
  1. environment: torch / CUDA / nvcc versions, the card's name and power limit
  2. build: the kernels from infinitevl_tpu_torch/csrc/ with nvcc (sm_90a)
  3. kernel parity: each kernel against its plain torch version on the card,
     at the main path's shapes, with its time beside the plain version's
  4. cross-device check: a small fp32 model through the port's Generator on
     the CPU (plain versions) and on the card (kernels)
  5. main path: the InfiniteVL-3B text decoder (bf16, random weights from a
     seed) answering three requests through Generator, with the kernels'
     launch counts reset before and read after
Then a JSON line of per-kernel results, the card's line, and as the last
line {"ok": true, "device": {...}}. Without a CUDA card it exits non-zero
and prints no result."""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

BF16_TOL = 1e-2  # err_ratio of bf16 outputs: bf16 rounding (~4e-3) plus order
F32_TOL = 1e-5  # err_ratio of fp32 outputs: summation order only
MODEL_TOL = 1e-3  # logits err_ratio of the fp32 model, CPU vs card
TIMING_REPS = 20

# main-path shapes of the InfiniteVL-3B text decoder (GQA 16/2, head_dim
# 128, window = ring capacity 8192; 9 SWA + 27 DeltaNet layers, DeltaNet
# heads 16 x (K 128, V 256)); T = 2048 is the chunked-prefill chunk
A1_CASE = dict(Bs=(1, 2), Hq=16, Hkv=2, cap=8192, Ts=(257, 2048),
               cums=(0, 5000, 20000), timed=(1, 2048, 20000))
A2_CASE = dict(S=9, Hq=16, Hkv=2, cap=8192, Bs=(1, 4),
               cums=(0, 8191, 8192, 20000), timed=(1, 20000))
B_CASE = dict(L=27, H=16, K=128, V=256, Bs=(1, 4), layers=(0, 13, 26), timed=(1, 13))
# requests of phase 5: recurrent path, chunk path, chunked prefill + ring wrap
MAIN_PROMPTS = (50, 1000, 9000)
MAIN_NEW_TOKENS = 32


def err_ratio(x: torch.Tensor, ref: torch.Tensor) -> float:
    x, ref = x.double().cpu(), ref.double().cpu()
    return float((x - ref).abs().mean() / (ref.abs().mean() + 1e-12))


def max_abs(x: torch.Tensor, ref: torch.Tensor) -> float:
    return float((x.double() - ref.double()).abs().max())


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, reps: int = TIMING_REPS) -> float:
    """Median device time of fn() over `reps` runs (CUDA events)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phases


def phase_env() -> str:
    from infinitevl_tpu_torch.ops._build import find_nvcc

    nvcc = subprocess.run([find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    card = card_line()
    print(f"[1 env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} nvcc '{nvcc}' card '{card}' "
          f"devices {torch.cuda.device_count()}", flush=True)
    return card


def phase_build() -> None:
    from infinitevl_tpu_torch.ops import _build

    cached = _build.library_path().exists()
    t0 = time.perf_counter()
    _build.load_library()
    print(f"[2 build] {'loaded cached' if cached else 'built'} "
          f"{_build.library_path().name} in {time.perf_counter() - t0:.2f} s", flush=True)


def _a1_cases(dev, gen):
    from infinitevl_tpu_torch.ops.swa import swa_cached_attention
    from infinitevl_tpu_torch.ops.swa_kernels import swa_ring_flash_attention

    c = A1_CASE
    Hq, Hkv, D, cap = c["Hq"], c["Hkv"], 128, c["cap"]
    errs, mxs = [], []
    for B in c["Bs"]:
        for T in c["Ts"]:
            for cum in c["cums"]:
                mk = lambda *s: torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
                q, nk, nv = mk(B, T, Hq, D), mk(B, T, Hkv, D), mk(B, T, Hkv, D)
                rk, rv = mk(B, Hkv, cap, D), mk(B, Hkv, cap, D)
                rk0 = rk.clone()
                out = swa_ring_flash_attention(q, nk, nv, rk, rv, cum, cap)
                ref = swa_cached_attention(q, nk, nv, rk, rv, cum, cap, write_ring=False)
                torch.cuda.synchronize()
                e = err_ratio(out, ref)
                require(e <= BF16_TOL, f"A1 B={B} T={T} cum={cum} err_ratio {e:.3g}")
                require(torch.equal(rk, rk0), "A1 must not write the ring")
                errs.append(e)
                mxs.append(max_abs(out, ref))
                if (B, T, cum) == c["timed"]:
                    ms = time_ms(lambda: swa_ring_flash_attention(q, nk, nv, rk, rv, cum, cap))
                    plain = time_ms(lambda: swa_cached_attention(
                        q, nk, nv, rk, rv, cum, cap, write_ring=False))
    print(f"[3 parity] A1 swa_ring_flash_attention: max err_ratio {max(errs):.3g} "
          f"(tol {BF16_TOL}), max|diff| {max(mxs):.3g}; (B, T, cum_len)={c['timed']}: "
          f"kernel {ms:.3f} ms, plain {plain:.3f} ms", flush=True)
    return dict(max_abs_err=max(mxs), ms=ms, plain_ms=plain)


def _a2_cases(dev, gen):
    from infinitevl_tpu_torch.ops.swa import ring_write_stacked, swa_cached_attention
    from infinitevl_tpu_torch.ops.swa_kernels import swa_ring_flash_decode_stacked

    c = A2_CASE
    S, Hq, Hkv, D, cap = c["S"], c["Hq"], c["Hkv"], 128, c["cap"]
    errs, mxs = [], []
    for B in c["Bs"]:
        mk = lambda *s: torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
        rks, rvs = mk(S, B, Hkv, cap, D), mk(S, B, Hkv, cap, D)
        for i, cum in enumerate(c["cums"]):
            layer = (3 * i + B) % S
            q, nk, nv = mk(B, 1, Hq, D), mk(B, 1, Hkv, D), mk(B, 1, Hkv, D)
            k_krn, v_krn = rks.clone(), rvs.clone()
            k_ref, v_ref = rks.clone(), rvs.clone()
            out = swa_ring_flash_decode_stacked(q, nk, nv, k_krn, v_krn, layer, cum, cap)
            ref = swa_cached_attention(q, nk, nv, k_ref[layer], v_ref[layer], cum, cap,
                                       write_ring=False)
            ring_write_stacked(k_ref, v_ref, layer, nk, nv, cum)
            torch.cuda.synchronize()
            e = err_ratio(out, ref)
            require(e <= BF16_TOL, f"A2 B={B} cum={cum} layer={layer} err_ratio {e:.3g}")
            require(torch.equal(k_krn, k_ref) and torch.equal(v_krn, v_ref),
                    f"A2 B={B} cum={cum}: stacked rings differ from the plain write")
            errs.append(e)
            mxs.append(max_abs(out, ref))
            if (B, cum) == c["timed"]:
                ms = time_ms(lambda: swa_ring_flash_decode_stacked(
                    q, nk, nv, k_krn, v_krn, layer, cum, cap))

                def plain_fn():
                    swa_cached_attention(q, nk, nv, k_ref[layer], v_ref[layer], cum,
                                         cap, write_ring=False)
                    ring_write_stacked(k_ref, v_ref, layer, nk, nv, cum)

                plain = time_ms(plain_fn)
    print(f"[3 parity] A2 swa_ring_flash_decode_stacked: max err_ratio "
          f"{max(errs):.3g} (tol {BF16_TOL}), rings bit-equal; (B, cum_len)="
          f"{c['timed']}: kernel {ms:.3f} ms, plain {plain:.3f} ms", flush=True)
    return dict(max_abs_err=max(mxs), ms=ms, plain_ms=plain)


def _b_cases(dev, gen):
    from infinitevl_tpu_torch.ops.delta_kernels import delta_step_fused_stacked
    from infinitevl_tpu_torch.ops.delta_rule import delta_rule_step

    c = B_CASE
    L, H, K, V = c["L"], c["H"], c["K"], c["V"]
    errs, mxs = [], []
    for B in c["Bs"]:
        rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
        stack = rnd(L, B, H, K, V) * 0.1
        for layer in c["layers"]:
            q, k, v = rnd(B, H, K), rnd(B, H, K), rnd(B, H, V)
            g = -torch.rand((B, H), generator=gen, device=dev) * 0.5
            beta = torch.sigmoid(rnd(B, H))
            krn = stack.clone()
            o = delta_step_fused_stacked(q, k, v, g, beta, krn, layer)
            o_ref, h_ref = delta_rule_step(q, k, v, g, beta, stack[layer])
            torch.cuda.synchronize()
            e = max(err_ratio(o, o_ref), err_ratio(krn[layer], h_ref))
            require(e <= F32_TOL, f"B B={B} layer={layer} err_ratio {e:.3g}")
            others = [i for i in range(L) if i != layer]
            require(torch.equal(krn[others], stack[others]),
                    f"B B={B} layer={layer}: other layers of the state changed")
            errs.append(e)
            mxs.append(max(max_abs(o, o_ref), max_abs(krn[layer], h_ref)))
            if (B, layer) == c["timed"]:
                ms = time_ms(lambda: delta_step_fused_stacked(q, k, v, g, beta, krn, layer))

                def plain_fn():
                    _, h = delta_rule_step(q, k, v, g, beta, stack[layer])
                    stack[layer].copy_(h)

                plain = time_ms(plain_fn)
    print(f"[3 parity] B delta_step_fused_stacked: max err_ratio {max(errs):.3g} "
          f"(tol {F32_TOL}), other layers bit-equal; (B, layer)={c['timed']}: "
          f"kernel {ms:.3f} ms, plain {plain:.3f} ms", flush=True)
    return dict(max_abs_err=max(mxs), ms=ms, plain_ms=plain)


def phase_kernels(dev) -> dict:
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    return {"a1": _a1_cases(dev, gen), "a2": _a2_cases(dev, gen), "b": _b_cases(dev, gen)}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def phase_cross_device(dev) -> None:
    from infinitevl_tpu_torch.config import InfiniteVLConfig, TextConfig
    from infinitevl_tpu_torch.generation import Generator
    from infinitevl_tpu_torch.models.infinitevl import forward, get_rope_index
    from infinitevl_tpu_torch.models.params import init_text_params
    from infinitevl_tpu_torch.models.state import init_decoder_state

    vocab = 1024
    text = TextConfig(
        vocab_size=vocab, hidden_size=256, intermediate_size=512,
        num_hidden_layers=4, num_attention_heads=8, num_key_value_heads=2,
        head_dim=128, sliding_window=512, mrope_section=(16, 24, 24),
        num_linear_heads=2, num_linear_key_value_heads=2, linear_head_dim=128,
    )
    cfg = InfiniteVLConfig(text=text, eos_token_id=vocab - 7, bos_token_id=vocab - 6)
    gen = torch.Generator().manual_seed(1)
    p_cpu = {"text": init_text_params(text, gen, "cpu", torch.float32)}
    p_dev = _to(p_cpu, dev)
    rng = np.random.RandomState(1)

    # logits of a cached prefill (A1, chunk delta rule) and one decode step
    # (A2, B) with a wrapped ring
    ids = rng.randint(0, vocab - 8, (2, 700))
    pos, _ = get_rope_index(cfg, ids)
    worst = 0.0
    for params, device in ((p_cpu, "cpu"), (p_dev, dev)):
        st = init_decoder_state(text, 2, torch.float32, device)
        t_ids, t_pos = torch.as_tensor(ids, device=device), torch.as_tensor(pos, device=device)
        l1, st = forward(params, cfg, t_ids[:, :600], t_pos[:, :, :600], st)
        l2, st = forward(params, cfg, t_ids[:, 600:601], t_pos[:, :, 600:601], st)
        if device == "cpu":
            ref = (l1, l2)
        else:
            worst = max(err_ratio(l1, ref[0]), err_ratio(l2, ref[1]))
    require(worst <= MODEL_TOL, f"cross-device logits err_ratio {worst:.3g}")

    toks = []
    for params in (p_cpu, p_dev):
        g = Generator(params, cfg)
        g.prefill_chunk_size = 256  # 700 tokens: chunked prefill, ring wraps
        toks.append(g.generate(ids, max_new_tokens=16))
    require(np.array_equal(toks[0], toks[1]),
            f"greedy tokens differ CPU vs card:\n{toks[0]}\n{toks[1]}")
    print(f"[4 cross-device] fp32 4-layer model (hidden 256, head_dim 128, window "
          f"512): logits err_ratio {worst:.3g} (tol {MODEL_TOL}); greedy tokens "
          f"identical ({toks[0].shape[1]} tokens x 2 rows, 700-token prompt in "
          f"256-token chunks)", flush=True)


def phase_main_path(dev, card: str) -> dict:
    from infinitevl_tpu_torch.config import infinitevl_3b
    from infinitevl_tpu_torch.generation import Generator, decode_step
    from infinitevl_tpu_torch.models.params import init_text_params
    from infinitevl_tpu_torch.models.state import init_decoder_state, state_bytes
    from infinitevl_tpu_torch.ops.delta_kernels import delta_step_fused_stacked
    from infinitevl_tpu_torch.ops.swa_kernels import (
        swa_ring_flash_attention,
        swa_ring_flash_decode_stacked,
    )

    cfg = infinitevl_3b()
    tc = cfg.text
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = {"text": init_text_params(tc, gen, dev, torch.bfloat16)}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    g = Generator(params, cfg)
    expect_bytes = (
        2 * tc.num_swa_layers * tc.num_key_value_heads * tc.swa_capacity * tc.head_dim * 2
        + tc.num_linear_layers * tc.num_linear_heads * tc.linear_head_dim * tc.head_v_dim * 4
        + tc.num_linear_layers * tc.conv_size
        * (tc.num_linear_heads * tc.linear_head_dim + tc.linear_key_dim + tc.linear_value_dim) * 2
    )
    kernels = (swa_ring_flash_attention, swa_ring_flash_decode_stacked, delta_step_fused_stacked)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, tc.vocab_size, (1, n)) for n in MAIN_PROMPTS]
    new_tokens = MAIN_NEW_TOKENS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kfn in kernels:
        kfn.launches = 0
    results = []
    for ids in prompts:
        T = ids.shape[1]
        state = init_decoder_state(tc, 1, torch.bfloat16, dev)
        require(state_bytes(state) == expect_bytes, "state size before the request")
        t0 = time.perf_counter()
        chunks = []
        for chunk in g.generate_stream(ids, max_new_tokens=new_tokens, state=state):
            chunks.append(chunk)
            if len(chunks) == 1:
                t_first = time.perf_counter()
        t_end = time.perf_counter()
        out = np.concatenate(chunks, axis=1)
        require(out.shape == (1, new_tokens), f"{T}-token request: {out.shape} tokens")
        require(bool(((out >= 0) & (out < tc.vocab_size)).all()), "tokens outside the vocab")
        require(state["cum_len"] == T + new_tokens - 1, f"cum_len {state['cum_len']}")
        logits, state = decode_step(params, cfg, torch.as_tensor(out[:, -1:], device=dev),
                                    torch.zeros((1, 1), dtype=torch.long, device=dev), state)
        require(logits.shape == (1, tc.vocab_size) and bool(torch.isfinite(logits).all()),
                "decode logits not finite")
        require(state_bytes(state) == expect_bytes, "state size changed by the request")
        results.append(dict(prompt=T, prefill_s=t_first - t0,
                            decode_s=t_end - t_first, tokens=out[0, :8].tolist()))
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was not launched on the main path")
    again = g.generate(prompts[0], max_new_tokens=new_tokens)
    require(again[0, :8].tolist() == results[0]["tokens"],
            "Generator.generate disagrees with generate_stream on request 1")
    for r in results:
        print(f"[5 main path] 3B text decoder (36 layers: 9 SWA + 27 DeltaNet, bf16) "
              f"prompt {r['prompt']}: prefill {r['prompt'] / r['prefill_s']:.1f} tok/s "
              f"({r['prefill_s']:.3f} s incl. first token), decode "
              f"{(new_tokens - 1) / r['decode_s']:.2f} tok/s ({new_tokens - 1} steps, B=1) "
              f"on '{card}'", flush=True)
    print(f"[5 main path] weights init {init_s:.2f} s; state {expect_bytes / 1e6:.1f} MB "
          f"constant; peak memory {peak_gb:.2f} GB; launches {launches} on '{card}'",
          flush=True)
    return launches


def main(argv) -> int:
    kernels_only = "--kernels-only" in argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available (torch.cuda.is_available() is "
              "False); the port's kernels run only on an NVIDIA GPU (H100)",
              file=sys.stderr)
        return 2
    import infinitevl_tpu_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = phase_env()
    phase_build()
    res = phase_kernels(dev)
    if kernels_only:
        return 0
    phase_cross_device(dev)
    launches = phase_main_path(dev, card)
    rows = [
        ("swa_ring_flash_attention", "swa_ring_flash.cu",
         "infinitevl_tpu/ops/swa_pallas.py:113", res["a1"]),
        ("swa_ring_flash_decode_stacked", "swa_ring_flash.cu",
         "infinitevl_tpu/ops/swa_pallas.py:332", res["a2"]),
        ("delta_step_fused_stacked", "delta_step.cu",
         "infinitevl_tpu/ops/delta_pallas.py:251", res["b"]),
    ]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"infinitevl_tpu_torch/csrc/{src}",
         "replaces": rep, "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"]}
        for name, src, rep, r in rows
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
