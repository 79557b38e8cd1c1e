#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (`infinitevl_tpu_torch`) on one
NVIDIA H100.

    python3 chip_smoke.py                 # all phases; needs one CUDA card and nvcc
    python3 chip_smoke.py --kernels-only  # phases 1-3: build and kernel parity
    python3 chip_smoke.py --profile       # all phases, then a torch.profiler
                                          # breakdown of three steady frames

Phases (each prints its lines; any failure raises and the exit code is
non-zero):
  1. environment: torch / CUDA / nvcc versions, the card's name and power limit
  2. build: the kernels from infinitevl_tpu_torch/csrc/ with nvcc (sm_90a),
     one compiler per source, all started together
  3. kernel parity: each of the five kernels (A1, A2, B, C, E) against its
     plain torch version on the card, at the main paths' shapes, with its
     time beside the plain version's, its bound (the least time the card
     could take for the same bytes and operations) and, where one PyTorch
     call computes the same function (A1, A2, E:
     scaled_dot_product_attention with the explicit mask), that call's time.
     The library call is a yardstick only; the port never calls it
  4. cross-device check: a small fp32 model on the CPU (plain versions) and
     on the card (kernels), through Generator (text) and through
     StreamingEngine (prime, 3 frames, ask)
  5. text path: the InfiniteVL-3B decoder (bf16, random weights from seed 0)
     answering three requests through Generator (full depth; prompts of
     50, 1,000 and 9,000 tokens, 32 new tokens each: nothing was cut to
     make room for phase 6)
  6. streaming path, at full 3B width and depth (ViT 32 blocks, decoder 36
     layers): StreamingEngine at 448x448, prime, 48 raw frames (the ring
     wraps after 32), an `ask` in the middle and one at the end, the
     frames-ask-frames state held bit for bit against the same frames with
     no ask; then one Generator request with a 1344x1344 image, which
     reaches kernel E
Launch counts are set to 0 just before each of the three paths (the text
requests, the stream, the image request) and read just after it. Then a JSON line of per-kernel results, the card's line, and
as the last line {"ok": true, "device": {...}}. Without a CUDA card it
exits non-zero and prints no result."""

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
C_F32_TOL = 1e-4  # kernel C in fp32: forward substitution against the plain
#                   version's Newton-Schulz inverse, over up to 32 chained chunks
MODEL_TOL = 1e-3  # logits / state err_ratio of the fp32 model, CPU vs card
TIMING_REPS = 20

# published peaks of one H100 SXM (dense, no sparsity), for the bounds
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # outside the tensor cores

# main-path shapes of the InfiniteVL-3B text decoder (GQA 16/2, head_dim
# 128, window = ring capacity 8192; 9 SWA + 27 DeltaNet layers, DeltaNet
# heads 16 x (K 128, V 256)); T = 2048 is the chunked-prefill chunk
A1_CASE = dict(Bs=(1, 2), Hq=16, Hkv=2, cap=8192, Ts=(257, 2048),
               cums=(0, 5000, 20000), timed=(1, 2048, 20000))
A2_CASE = dict(S=9, Hq=16, Hkv=2, cap=8192, Bs=(1, 4),
               cums=(0, 8191, 8192, 20000), timed=(1, 20000))
B_CASE = dict(L=27, H=16, K=128, V=256, Bs=(1, 4), layers=(0, 13, 26), timed=(1, 13))
# kernel C at the DeltaNet layer's shape (16 heads, K 128, V 256): a 448x448
# frame is T = 257, a chunked-prefill chunk T = 2048, T = 100 a ragged tail
C_CASE = dict(H=16, K=128, V=256, Bs=(1, 2), Ts=(257, 2048, 100), timed=(257, 2048))
# kernel E at the ViT's shape (16 heads, head dim 80): S = 9216 is one
# 1344x1344 image, S = 4100 a ragged length just above the model's gate
E_CASE = dict(H=16, D=80, Ss=(9216, 4100), timed=9216)
# requests of phase 5: recurrent path, chunk path, chunked prefill + ring wrap
MAIN_PROMPTS = (50, 1000, 9000)
MAIN_NEW_TOKENS = 32
# phase 6: frames before the first ask (the 8192-slot ring wraps after 32
# frames of 257 tokens), between the asks, and after the second
STREAM_FRAMES = (36, 8, 4)
ASK_NEW_TOKENS = 17  # the first token, then 16 decode steps
HIRES_HW = 1344
HIRES_NEW_TOKENS = 8


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


def bound(n_bytes: float, flops: float, peak_flops: float) -> dict:
    """The least time the card could take: the larger of the bytes (each
    input read once, each output written once) over the memory rate and the
    operations over the peak rate of their type."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def sdpa(q, k, v, mask):
    """The library yardstick: q [B, Tq, H, D], k/v [B, Tk, H, D] (heads
    already repeated for GQA), mask [Tq, Tk] bool. Returns [B, Tq, H, D]."""
    out = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask)
    return out.transpose(1, 2)


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
    from infinitevl_tpu_torch.ops.swa import (
        ring_slot_positions,
        sliding_window_mask,
        swa_cached_attention,
    )
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
                    # the library call on the same keys and mask
                    G = Hq // Hkv
                    q_pos = cum + torch.arange(T, device=dev)
                    k_pos = torch.cat([ring_slot_positions(cum, cap, dev), q_pos])
                    mask = sliding_window_mask(q_pos, k_pos, cap)
                    k_all = torch.cat([rk.transpose(1, 2), nk], 1).repeat_interleave(G, 2)
                    v_all = torch.cat([rv.transpose(1, 2), nv], 1).repeat_interleave(G, 2)
                    e_lib = err_ratio(sdpa(q, k_all, v_all, mask), ref)
                    require(e_lib <= BF16_TOL, f"A1 library call err_ratio {e_lib:.3g}")
                    lib = time_ms(lambda: sdpa(q, k_all, v_all, mask))
                    seen = sum(min(cap, cum + t + 1) for t in range(T))  # keys per query
                    bnd = bound(2 * (2 * B * T * Hq * D + 2 * B * T * Hkv * D
                                     + 2 * B * Hkv * cap * D),
                                4 * B * Hq * D * seen, PEAK_BF16_FLOPS)
    print(f"[3 parity] A1 swa_ring_flash_attention: max err_ratio {max(errs):.3g} "
          f"(tol {BF16_TOL}), max|diff| {max(mxs):.3g}; (B, T, cum_len)={c['timed']}: "
          f"kernel {ms:.3f} ms, plain {plain:.3f} ms, library {lib:.3f} ms, bound "
          f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})", flush=True)
    return dict(max_abs_err=max(mxs), ms=ms, plain_ms=plain, library_ms=lib, **bnd)


def _a2_cases(dev, gen):
    from infinitevl_tpu_torch.ops.swa import (
        ring_slot_positions,
        ring_write_stacked,
        sliding_window_mask,
        swa_cached_attention,
    )
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
                # the library call over the ring after the write
                G = Hq // Hkv
                k_pos = ring_slot_positions(cum + 1, cap, dev)
                mask = sliding_window_mask(torch.tensor([cum], device=dev), k_pos, cap)
                k_all = k_ref[layer].transpose(1, 2).repeat_interleave(G, 2)
                v_all = v_ref[layer].transpose(1, 2).repeat_interleave(G, 2)
                e_lib = err_ratio(sdpa(q, k_all, v_all, mask), ref)
                require(e_lib <= BF16_TOL, f"A2 library call err_ratio {e_lib:.3g}")
                lib = time_ms(lambda: sdpa(q, k_all, v_all, mask))
                bnd = bound(2 * (2 * B * Hkv * cap * D + 2 * B * Hq * D + 2 * B * Hkv * D),
                            4 * B * Hq * D * min(cap, cum + 1), PEAK_BF16_FLOPS)
    print(f"[3 parity] A2 swa_ring_flash_decode_stacked: max err_ratio "
          f"{max(errs):.3g} (tol {BF16_TOL}), rings bit-equal; (B, cum_len)="
          f"{c['timed']}: kernel {ms:.3f} ms, plain {plain:.3f} ms, library "
          f"{lib:.3f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})", flush=True)
    return dict(max_abs_err=max(mxs), ms=ms, plain_ms=plain, library_ms=lib, **bnd)


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
                # the slab read and written once; two reductions, decay, rank-1 update
                bnd = bound(4 * (2 * B * H * K * V + 2 * B * H * K + 2 * B * H * V + 2 * B * H),
                            7 * B * H * K * V, PEAK_F32_FLOPS)
    print(f"[3 parity] B delta_step_fused_stacked: max err_ratio {max(errs):.3g} "
          f"(tol {F32_TOL}), other layers bit-equal; (B, layer)={c['timed']}: "
          f"kernel {ms:.3f} ms, plain {plain:.3f} ms, bound {bnd['bound_ms']:.4f} ms "
          f"({bnd['bound_by']})", flush=True)
    return dict(max_abs_err=max(mxs), ms=ms, plain_ms=plain, library_ms=None, **bnd)


def _c_bound(B, T, H, K, V, elt) -> dict:
    """Kernel C's bound: q, k, v read and o written once in the model's
    dtype, g and beta in fp32, the state read and written once; per chunk
    of 64 and head the strictly lower half of k k^T (C (C-1) K), the lower
    half of q k^T (C (C+1) K), the substitution (C (C-1) (K + V)), w S and
    q S (2 C K V each), the lower half of the masked product (C (C+1) V)
    and the state update (2 C K V), all in fp32."""
    C = 64
    n_chunks = -(-T // C)
    per_chunk = (C * (C - 1) * K + C * (C + 1) * K + C * (C - 1) * (K + V)
                 + 6 * C * K * V + C * (C + 1) * V)
    n_bytes = elt * (2 * B * T * H * K + 2 * B * T * H * V) + 4 * (2 * B * T * H + 2 * B * H * K * V)
    return bound(n_bytes, B * H * n_chunks * per_chunk, PEAK_F32_FLOPS)


def _c_cases(dev, gen):
    from infinitevl_tpu_torch.ops.delta_kernels import delta_rule_chunk_fused
    from infinitevl_tpu_torch.ops.delta_rule import delta_rule_chunk

    c = C_CASE
    H, K, V = c["H"], c["K"], c["V"]
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    errs, mxs, timed = {}, [], {}
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, C_F32_TOL)):
        errs[dtype] = []
        for B in c["Bs"]:
            for T in c["Ts"]:
                for init in (False, True):
                    q, k, v = rnd(B, T, H, K).to(dtype), rnd(B, T, H, K).to(dtype), \
                        rnd(B, T, H, V).to(dtype)
                    g = -torch.rand((B, T, H), generator=gen, device=dev) * 0.2
                    beta = torch.sigmoid(rnd(B, T, H))
                    h0 = rnd(B, H, K, V) * 0.1 if init else None
                    o, hT = delta_rule_chunk_fused(q, k, v, g, beta, h0)
                    o_ref, h_ref = delta_rule_chunk(q, k, v, g, beta, h0,
                                                    compute_dtype=torch.float32)
                    torch.cuda.synchronize()
                    e = max(err_ratio(o, o_ref), err_ratio(hT, h_ref))
                    require(e <= tol, f"C {dtype} B={B} T={T} init={init} err_ratio {e:.3g}")
                    require(o.dtype == dtype and hT.dtype == torch.float32, "C output dtypes")
                    if init:  # the model's call: the final state over the initial one
                        slab = h0.clone()
                        o2, h2 = delta_rule_chunk_fused(q, k, v, g, beta, slab, out_state=slab)
                        require(h2 is slab and torch.equal(slab, hT) and torch.equal(o2, o),
                                f"C {dtype} B={B} T={T}: in-place state differs")
                    errs[dtype].append(e)
                    if dtype == torch.bfloat16:
                        mxs.append(max(max_abs(o, o_ref), max_abs(hT, h_ref)))
                    if dtype == torch.bfloat16 and B == 1 and init and T in c["timed"]:
                        timed[T] = dict(
                            ms=time_ms(lambda: delta_rule_chunk_fused(q, k, v, g, beta, h0)),
                            plain_ms=time_ms(lambda: delta_rule_chunk(
                                q, k, v, g, beta, h0, compute_dtype=torch.float32)),
                            **_c_bound(1, T, H, K, V, 2))
    line = "; ".join(
        f"(B 1, T {T}, bf16, with state): kernel {r['ms']:.3f} ms, plain "
        f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
        for T, r in timed.items())
    print(f"[3 parity] C delta_rule_chunk_fused: max err_ratio bf16 "
          f"{max(errs[torch.bfloat16]):.3g} (tol {BF16_TOL}), fp32 "
          f"{max(errs[torch.float32]):.3g} (tol {C_F32_TOL}), o and final state, "
          f"B {c['Bs']} x T {c['Ts']} x with/without state, the state written in "
          f"place bit-equal; {line}", flush=True)
    frame, chunk = timed[c["timed"][0]], timed[c["timed"][1]]
    return dict(max_abs_err=max(mxs), library_ms=None, **frame,
                ms_t2048=chunk["ms"], plain_ms_t2048=chunk["plain_ms"],
                bound_ms_t2048=chunk["bound_ms"])


def _e_cases(dev, gen):
    from infinitevl_tpu_torch.ops.vit_flash import attention_segment_chunked
    from infinitevl_tpu_torch.ops.vit_kernels import segment_flash_attention

    c = E_CASE
    H, D = c["H"], c["D"]
    errs, mxs = {}, []
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        errs[dtype] = []
        for S in c["Ss"]:
            # q, k, v as slices of one [S, 3, H, D] projection, read where they lie
            q, k, v = torch.randn((S, 3, H, D), generator=gen, device=dev).to(dtype).unbind(1)
            # three segments of unequal length, with pads (-1) scattered over them
            seg = torch.zeros(S, dtype=torch.int32, device=dev)
            seg[S * 2 // 5: S * 3 // 4] = 1
            seg[S * 3 // 4:] = 2
            seg[torch.randperm(S, generator=gen, device=dev)[: S // 50]] = -1
            out = segment_flash_attention(q, k, v, seg)
            ref = attention_segment_chunked(q, k, v, seg)
            torch.cuda.synchronize()
            e = err_ratio(out, ref)
            require(e <= tol, f"E {dtype} S={S} err_ratio {e:.3g}")
            require(bool(torch.isfinite(out).all()), f"E {dtype} S={S}: pad rows not finite")
            errs[dtype].append(e)
            if dtype == torch.bfloat16:
                mxs.append(max_abs(out, ref))
    # timed at the main path's case: one 1344x1344 image is a single segment;
    # q and k are dense after the rotation, v is a slice of the projection
    S = c["timed"]
    q, k = (torch.randn((S, H, D), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    v = torch.randn((S, 3, H, D), generator=gen, device=dev).to(torch.bfloat16)[:, 2]
    seg = torch.zeros(S, dtype=torch.int32, device=dev)
    ms = time_ms(lambda: segment_flash_attention(q, k, v, seg))
    plain = time_ms(lambda: attention_segment_chunked(q, k, v, seg), reps=5)
    mask = seg[:, None] == seg[None, :]
    ref = attention_segment_chunked(q, k, v, seg)
    e_lib = err_ratio(sdpa(q[None], k[None], v[None], mask)[0], ref)
    require(e_lib <= BF16_TOL, f"E library call err_ratio {e_lib:.3g}")
    lib = time_ms(lambda: sdpa(q[None], k[None], v[None], mask))
    pairs = int((torch.bincount(seg - seg.min()).double() ** 2).sum())  # visible (q, k) pairs
    bnd = bound(2 * 4 * S * H * D + 4 * S, 4 * H * D * pairs, PEAK_BF16_FLOPS)
    print(f"[3 parity] E segment_flash_attention: max err_ratio bf16 "
          f"{max(errs[torch.bfloat16]):.3g} (tol {BF16_TOL}), fp32 "
          f"{max(errs[torch.float32]):.3g} (tol {F32_TOL}), S {c['Ss']}, 3 segments + "
          f"pads; S {S}, one segment, bf16: kernel {ms:.3f} ms, plain {plain:.3f} ms, "
          f"library {lib:.3f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})",
          flush=True)
    return dict(max_abs_err=max(mxs), ms=ms, plain_ms=plain, library_ms=lib, **bnd)


def phase_kernels(dev) -> dict:
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    return {"a1": _a1_cases(dev, gen), "a2": _a2_cases(dev, gen), "b": _b_cases(dev, gen),
            "c": _c_cases(dev, gen), "e": _e_cases(dev, gen)}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _state_tensors(state):
    return {k: v for k, v in state.items() if isinstance(v, torch.Tensor)}


def phase_cross_device(dev) -> None:
    from infinitevl_tpu_torch.config import InfiniteVLConfig, TextConfig, VisionConfig
    from infinitevl_tpu_torch.generation import Generator
    from infinitevl_tpu_torch.models.infinitevl import forward, get_rope_index
    from infinitevl_tpu_torch.models.params import init_params
    from infinitevl_tpu_torch.models.state import init_decoder_state
    from infinitevl_tpu_torch.streaming import StreamingEngine

    vocab = 1024
    text = TextConfig(
        vocab_size=vocab, hidden_size=256, intermediate_size=512,
        num_hidden_layers=4, num_attention_heads=8, num_key_value_heads=2,
        head_dim=128, sliding_window=512, mrope_section=(16, 24, 24),
        num_linear_heads=2, num_linear_key_value_heads=2, linear_head_dim=128,
    )
    vision = VisionConfig(depth=2, hidden_size=160, intermediate_size=320, num_heads=2,
                          out_hidden_size=256, fullatt_block_indexes=(1,))
    cfg = InfiniteVLConfig(
        text=text, vision=vision, image_token_id=vocab - 2, video_token_id=vocab - 3,
        vision_start_token_id=vocab - 4, vision_end_token_id=vocab - 5,
        bos_token_id=vocab - 6, eos_token_id=vocab - 7)
    gen = torch.Generator().manual_seed(1)
    p_cpu = init_params(cfg, gen, "cpu", torch.float32)
    p_dev = _to(p_cpu, dev)
    rng = np.random.RandomState(1)

    # logits of a cached prefill (A1, C) and one decode step (A2, B) with a
    # wrapped ring
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
    for params, device in ((p_cpu, "cpu"), (p_dev, dev)):
        g = Generator(params, cfg, device=device)
        g.prefill_chunk_size = 256  # 700 tokens: chunked prefill, ring wraps
        toks.append(g.generate(ids, max_new_tokens=16))
    require(np.array_equal(toks[0], toks[1]),
            f"greedy tokens differ CPU vs card:\n{toks[0]}\n{toks[1]}")
    print(f"[4 cross-device] fp32 4-layer model (hidden 256, head_dim 128, window "
          f"512): logits err_ratio {worst:.3g} (tol {MODEL_TOL}); greedy tokens "
          f"identical ({toks[0].shape[1]} tokens x 2 rows, 700-token prompt in "
          f"256-token chunks)", flush=True)

    # the streaming engine: 224x224 frames are 64 tokens + <vision_start>,
    # T = 65 > recurrent_threshold, so every frame runs kernel C on the card
    prompt = rng.randint(0, vocab - 8, (1, 6))
    frames = rng.randint(0, 256, (3, 224, 224, 3)).astype(np.uint8)
    question = rng.randint(0, vocab - 8, (1, 3))
    engines = []
    for params, device in ((p_cpu, "cpu"), (p_dev, dev)):
        eng = StreamingEngine(params, cfg, frame_hw=(224, 224), device=device)
        eng.prime(prompt)
        for f in frames:
            eng.push_frame_raw(f)
        engines.append((eng, eng.ask(question, max_new_tokens=8, eos_token_id=-1)))
    (e_cpu, a_cpu), (e_dev, a_dev) = engines
    require(a_cpu == a_dev and len(a_dev) == 8,
            f"ask tokens differ CPU vs card: {a_cpu} vs {a_dev}")
    require(e_cpu.state["cum_len"] == e_dev.state["cum_len"] == 6 + 3 * 65, "cum_len")
    worst = max(err_ratio(v, e_cpu.state[k]) for k, v in _state_tensors(e_dev.state).items())
    require(worst <= MODEL_TOL, f"cross-device stream state err_ratio {worst:.3g}")
    print(f"[4 cross-device] StreamingEngine, fp32, 2-block ViT (hidden 160, head_dim "
          f"80) + the 4-layer decoder: prime 6 tokens, 3 frames of 224x224 (T = 65), "
          f"ask 8 tokens: tokens identical, state err_ratio {worst:.3g} (tol "
          f"{MODEL_TOL})", flush=True)


def _kernel_wrappers():
    from infinitevl_tpu_torch.ops.delta_kernels import (
        delta_rule_chunk_fused,
        delta_step_fused_stacked,
    )
    from infinitevl_tpu_torch.ops.swa_kernels import (
        swa_ring_flash_attention,
        swa_ring_flash_decode_stacked,
    )
    from infinitevl_tpu_torch.ops.vit_kernels import segment_flash_attention

    return (swa_ring_flash_attention, swa_ring_flash_decode_stacked,
            delta_step_fused_stacked, delta_rule_chunk_fused, segment_flash_attention)


def _reset_launches() -> None:
    for kfn in _kernel_wrappers():
        kfn.launches = 0


def _read_launches(needed) -> dict:
    launches = {k.__name__: k.launches for k in _kernel_wrappers()}
    for name in needed:
        require(launches[name] > 0, f"kernel {name} was not launched on this path")
    return launches


def _expected_state_bytes(tc) -> int:
    return (
        2 * tc.num_swa_layers * tc.num_key_value_heads * tc.swa_capacity * tc.head_dim * 2
        + tc.num_linear_layers * tc.num_linear_heads * tc.linear_head_dim * tc.head_v_dim * 4
        + tc.num_linear_layers * tc.conv_size
        * (tc.num_linear_heads * tc.linear_head_dim + tc.linear_key_dim + tc.linear_value_dim) * 2
    )


def phase_text_path(dev, card: str, params, cfg) -> dict:
    from infinitevl_tpu_torch.generation import Generator, decode_step
    from infinitevl_tpu_torch.models.state import init_decoder_state, state_bytes

    tc = cfg.text
    g = Generator(params, cfg)
    expect_bytes = _expected_state_bytes(tc)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, tc.vocab_size, (1, n)) for n in MAIN_PROMPTS]
    new_tokens = MAIN_NEW_TOKENS
    torch.cuda.synchronize()
    _reset_launches()
    results = []
    for ids in prompts:
        T = ids.shape[1]
        state = init_decoder_state(tc, 1, torch.bfloat16)
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
    launches = _read_launches(("swa_ring_flash_attention", "swa_ring_flash_decode_stacked",
                               "delta_step_fused_stacked", "delta_rule_chunk_fused"))
    again = g.generate(prompts[0], max_new_tokens=new_tokens)
    require(again[0, :8].tolist() == results[0]["tokens"],
            "Generator.generate disagrees with generate_stream on request 1")
    for r in results:
        print(f"[5 text path] 3B text decoder (36 layers: 9 SWA + 27 DeltaNet, bf16) "
              f"prompt {r['prompt']}: prefill {r['prompt'] / r['prefill_s']:.1f} tok/s "
              f"({r['prefill_s']:.3f} s incl. first token), decode "
              f"{(new_tokens - 1) / r['decode_s']:.2f} tok/s ({new_tokens - 1} steps, B=1) "
              f"on '{card}'", flush=True)
    print(f"[5 text path] state {expect_bytes / 1e6:.1f} MB constant; launches "
          f"{launches} on '{card}'", flush=True)
    return launches


def _stream_engine(params, cfg, prompt):
    from infinitevl_tpu_torch.streaming import StreamingEngine

    eng = StreamingEngine(params, cfg, frame_hw=(448, 448))
    eng.prime(prompt)
    return eng


class _DecodeClock:
    """Times the decode of one `ask` inside that call: while it is active
    the engine's decode_chunk is wrapped so that each call is entered and
    left at a device sync. `first` is the time of the first entry (the
    question's prefill and first token end there), `decode_s` the time
    spent in the chunks."""

    def __enter__(self):
        import infinitevl_tpu_torch.streaming as streaming

        self.module, self.inner = streaming, streaming.decode_chunk
        self.first, self.decode_s = None, 0.0

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if self.first is None:
                self.first = t0
            out = self.inner(*args, **kwargs)
            torch.cuda.synchronize()
            self.decode_s += time.perf_counter() - t0
            return out

        streaming.decode_chunk = timed
        return self

    def __exit__(self, *exc):
        self.module.decode_chunk = self.inner


def phase_stream_path(dev, card: str, params, cfg, profile: bool) -> tuple:
    from infinitevl_tpu_torch.data.processing import normalize, patchify
    from infinitevl_tpu_torch.generation import Generator
    from infinitevl_tpu_torch.models.state import state_bytes

    tc, vc = cfg.text, cfg.vision
    expect_bytes = _expected_state_bytes(tc)
    rng = np.random.RandomState(0)
    prompt = rng.randint(0, tc.vocab_size - 1000, (1, 8))
    question = rng.randint(0, tc.vocab_size - 1000, (1, 6))
    n_frames = sum(STREAM_FRAMES)
    frames = rng.randint(0, 256, (n_frames, 448, 448, 3)).astype(np.uint8)

    # frames-ask-frames leaves the stream's state as the same frames with no
    # ask (before the counted run, so that its launches are not in the counts)
    with_ask, without = (_stream_engine(params, cfg, prompt) for _ in range(2))
    for f in frames[:3]:
        with_ask.push_frame_raw(f)
        without.push_frame_raw(f)
    with_ask.ask(question, max_new_tokens=4, eos_token_id=-1)
    for f in frames[3:5]:
        with_ask.push_frame_raw(f)
        without.push_frame_raw(f)
    require(with_ask.state["cum_len"] == without.state["cum_len"], "cum_len after ask")
    for key, t in _state_tensors(without.state).items():
        require(torch.equal(with_ask.state[key], t), f"ask changed the stream's {key}")
    del with_ask, without

    torch.cuda.synchronize()
    _reset_launches()
    eng = _stream_engine(params, cfg, prompt)
    require(eng.tokens_per_frame == 256 and state_bytes(eng.state) == expect_bytes,
            "frame tokens / state size after prime")
    asks = []

    def push(lo, hi):
        for f in frames[lo:hi]:
            eng.push_frame_raw(f)
            require(state_bytes(eng.state) == expect_bytes, "state size changed by a frame")

    def ask():
        torch.cuda.synchronize()
        with _DecodeClock() as clock:
            t0 = time.perf_counter()
            full = eng.ask(question, max_new_tokens=ASK_NEW_TOKENS, eos_token_id=-1,
                           chunk_size=ASK_NEW_TOKENS - 1)
            t1 = time.perf_counter()
        require(len(full) == ASK_NEW_TOKENS, f"ask returned {full}")
        require(all(0 <= t < tc.vocab_size for t in full), "ask tokens outside the vocab")
        require(state_bytes(eng.state) == expect_bytes, "state size changed by ask")
        asks.append(dict(frames=eng.frames, cum_len=eng.state["cum_len"], ask_s=t1 - t0,
                         ttft_s=clock.first - t0, decode_s=clock.decode_s, tokens=full[:6]))

    a, b, c = STREAM_FRAMES
    push(0, a)
    require(eng.state["cum_len"] > tc.sliding_window, "the ring has not wrapped")
    ask()
    push(a, a + b)
    ask()
    push(a + b, n_frames)
    require(eng.state["cum_len"] == 8 + n_frames * 257, f"cum_len {eng.state['cum_len']}")
    for key, t in _state_tensors(eng.state).items():
        require(bool(torch.isfinite(t.float()).all()), f"state {key} not finite")
    stream_launches = _read_launches(
        ("delta_rule_chunk_fused", "swa_ring_flash_attention",
         "swa_ring_flash_decode_stacked", "delta_step_fused_stacked"))
    require(stream_launches["delta_rule_chunk_fused"] == n_frames * tc.num_linear_layers,
            f"C launches {stream_launches['delta_rule_chunk_fused']}, expected "
            f"{n_frames} frames x {tc.num_linear_layers} layers")
    times = np.asarray(eng.frame_times_ms[1:])
    st = eng.stats()

    print(f"[6 stream path] 3B (ViT 32 blocks x 1280, decoder 36 layers, bf16), 448x448 "
          f"push_frame_raw x {n_frames}: per-frame median {np.median(times):.2f} ms, mean "
          f"{times.mean():.2f} ms (first frame {eng.frame_times_ms[0]:.1f} ms excluded), "
          f"{st['fps']:.2f} frames/s, {st['tokens']} tokens in a state of "
          f"{expect_bytes / 1e6:.1f} MB (constant over every frame and ask) on '{card}'",
          flush=True)
    for r in asks:
        print(f"[6 stream path] ask after {r['frames']} frames (cum_len {r['cum_len']}): "
              f"{r['ask_s'] * 1e3:.1f} ms for {ASK_NEW_TOKENS} tokens, of which time to "
              f"first token {r['ttft_s'] * 1e3:.1f} ms (state clone included) and decode "
              f"{r['decode_s'] * 1e3:.1f} ms = {(ASK_NEW_TOKENS - 1) / r['decode_s']:.2f} "
              f"tok/s ({ASK_NEW_TOKENS - 1} steps, timed inside the call), tokens "
              f"{r['tokens']} on '{card}'", flush=True)
    print(f"[6 stream path] frames-ask-frames state bit-equal to frames-frames (5 "
          f"frames, not counted); launches of the {n_frames} frames and 2 asks "
          f"{stream_launches} on '{card}'", flush=True)

    # one high-resolution image through Generator: S = 9216 reaches kernel E
    img = rng.randint(0, 256, (1, HIRES_HW, HIRES_HW, 3)).astype(np.uint8)
    pixels, grid = patchify(normalize(img), vc.patch_size, vc.temporal_patch_size,
                            vc.spatial_merge_size)
    n_img = grid[0] * grid[1] * grid[2] // vc.spatial_merge_unit
    ids = np.concatenate([
        prompt[0], [cfg.vision_start_token_id], [cfg.image_token_id] * n_img,
        [cfg.vision_end_token_id], question[0]])[None]
    g = Generator(params, cfg)
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    chunks = []
    for chunk in g.generate_stream(ids, pixel_values=pixels, image_grid_thw=np.array([grid]),
                                   max_new_tokens=HIRES_NEW_TOKENS, eos_token_id=-1):
        chunks.append(chunk)
        if len(chunks) == 1:
            t_first = time.perf_counter()
    out = np.concatenate(chunks, axis=1)
    require(out.shape == (1, HIRES_NEW_TOKENS), f"high-resolution request: {out.shape}")
    require(bool(((out >= 0) & (out < tc.vocab_size)).all()), "tokens outside the vocab")
    image_launches = _read_launches(("segment_flash_attention", "delta_rule_chunk_fused",
                                     "swa_ring_flash_attention"))
    n_e = image_launches["segment_flash_attention"]
    require(n_e == len(vc.fullatt_block_indexes),
            f"E launches {n_e} for one image, expected {len(vc.fullatt_block_indexes)}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[6 stream path] Generator, one {HIRES_HW}x{HIRES_HW} image ({pixels.shape[0]} "
          f"patches -> {n_img} tokens, prompt {ids.shape[1]} tokens): prefill "
          f"{(t_first - t0) * 1e3:.1f} ms incl. first token, launches {image_launches}; "
          f"peak memory over phases 5-6 {peak_gb:.2f} GB on '{card}'", flush=True)
    if profile:
        _profile_frames(eng, frames[:5], float(np.median(times)), card)
    return stream_launches, image_launches


def _device_profile(fn, reps: int = 3):
    """Device time of fn() from torch.profiler, per call: (total ms, kernel
    count, ms by kind, [(ms, count, name)] by kernel)."""
    from torch.profiler import ProfilerActivity, profile

    kinds = {"C delta_chunk": ("delta_chunk",), "A1 swa_prefill": ("swa_prefill",),
             "GEMM": ("gemm", "cutlass", "cublas", "xmma", "nvjet"),
             "copies and casts": ("copy_kernel",), "other": ()}
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    sums = dict.fromkeys(kinds, 0.0)
    count, rows = 0, []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
        if ev.device_type.name == "CUDA" or (dev_us and ev.cpu_time_total == 0):
            name = ev.key.lower()
            kind = next((k for k, pats in kinds.items() if any(p in name for p in pats)),
                        "other")
            sums[kind] += dev_us / 1e3 / reps
            count += ev.count
            rows.append((dev_us / 1e3 / reps, ev.count // reps, ev.key[:90]))
    return sum(sums.values()), count // reps, sums, sorted(rows, reverse=True)


def _host_ms(fn, reps: int = 5) -> float:
    """Median wall time of fn() ending in a device sync, without a profiler."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _profile_frames(eng, frames, frame_ms: float, card: str) -> None:
    """Where a steady frame's time goes: device time by kernel kind from
    torch.profiler, for the whole frame step and for the ViT alone, against
    wall times measured without the profiler (tracing slows the host
    several times over)."""
    from infinitevl_tpu_torch.models.vision import get_vision_plan, vision_forward
    from infinitevl_tpu_torch.streaming import _patchify_raw

    it = iter(np.tile(frames, (4, 1, 1, 1)))
    total, count, sums, rows = _device_profile(lambda: eng.push_frame_raw(next(it)))
    raw = torch.as_tensor(frames[0], device=eng.device)[None]
    plan = get_vision_plan(eng.grid_thw, eng.cfg.vision)

    def vit():
        return vision_forward(eng.params["visual"], eng.cfg.vision,
                              _patchify_raw(eng.params, eng.cfg, raw), plan)

    vit_wall = _host_ms(vit)
    vit_total, vit_count, vit_sums, _ = _device_profile(vit)
    print(f"[profile] one steady 448x448 frame: {frame_ms:.2f} ms unprofiled, device busy "
          f"{total:.2f} ms ({100 * total / frame_ms:.0f}%, idle "
          f"{100 - 100 * total / frame_ms:.0f}%), {count} device kernels; by "
          f"kind (ms): " + ", ".join(f"{k} {v:.2f}" for k, v in sums.items())
          + f" on '{card}'", flush=True)
    print(f"[profile] of which the ViT (patchify + 32 blocks + merger): {vit_wall:.2f} ms "
          f"unprofiled wall, device {vit_total:.2f} ms, {vit_count} device kernels; by "
          f"kind (ms): " + ", ".join(f"{k} {v:.2f}" for k, v in vit_sums.items())
          + f"; the decoder's share is the rest: device {total - vit_total:.2f} ms, "
          f"{count - vit_count} kernels on '{card}'", flush=True)
    for ms, n, name in rows[:12]:
        print(f"[profile]   {ms:8.3f} ms  x{n:<5d} {name}", flush=True)


def main(argv) -> int:
    kernels_only = "--kernels-only" in argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available (torch.cuda.is_available() is "
              "False); the port's kernels run only on an NVIDIA GPU (H100)",
              file=sys.stderr)
        return 2
    import infinitevl_tpu_torch  # noqa: F401  (fails outside a checkout)
    from infinitevl_tpu_torch.config import infinitevl_3b
    from infinitevl_tpu_torch.models.params import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = phase_env()
    phase_build()
    res = phase_kernels(dev)
    if kernels_only:
        return 0
    phase_cross_device(dev)

    cfg = infinitevl_3b()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))  # bf16, on the card
    torch.cuda.synchronize()
    print(f"[weights] InfiniteVL-3B random init from seed 0 in {time.perf_counter() - t0:.2f} s",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    text_launches = phase_text_path(dev, card, params, cfg)
    stream_launches, image_launches = phase_stream_path(
        dev, card, params, cfg, "--profile" in argv)
    rows = [
        ("swa_ring_flash_attention", "swa_ring_flash.cu",
         "infinitevl_tpu/ops/swa_pallas.py:113", res["a1"]),
        ("swa_ring_flash_decode_stacked", "swa_ring_flash.cu",
         "infinitevl_tpu/ops/swa_pallas.py:332", res["a2"]),
        ("delta_step_fused_stacked", "delta_step.cu",
         "infinitevl_tpu/ops/delta_pallas.py:251", res["b"]),
        ("delta_rule_chunk_fused", "delta_chunk.cu",
         "infinitevl_tpu/ops/delta_pallas.py:128", res["c"]),
        ("segment_flash_attention", "vit_flash.cu",
         "infinitevl_tpu/ops/vit_flash.py:100", res["e"]),
    ]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"infinitevl_tpu_torch/csrc/{src}",
         "replaces": rep,
         "launches": text_launches[name] + stream_launches[name] + image_launches[name],
         "launches_text_path": text_launches[name],
         "launches_stream_path": stream_launches[name],
         "launches_image_path": image_launches[name], **r}
        for name, src, rep, r in rows
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
