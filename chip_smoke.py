#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (`infinitevl_tpu_torch`) on one
NVIDIA H100.

    python3 chip_smoke.py                 # all phases; needs one CUDA card and nvcc
    python3 chip_smoke.py --kernels-only  # phases 1-3: build and kernel parity
    python3 chip_smoke.py --profile       # all phases, plus torch.profiler breakdowns
                                          # of one decode step, three steady frames,
                                          # one LoRA step and one stage-1 step
    python3 chip_smoke.py --kernels-only --only=h,f  # a subset of phase 3
    python3 chip_smoke.py --train-only    # phases 1-3, then the training phases alone
    python3 chip_smoke.py --text-only --profile --only=a2,d,b  # phases 1-3, then 5
    python3 chip_smoke.py --dt-only --only=h  # phases 1-3, 4's distillation steps, 10
    python3 chip_smoke.py --pref-only --only=h  # phases 1-3, 4's preference steps, 11
    python3 chip_smoke.py --long-only --only=h  # phases 1-3, 4's long-context and
                                                # optimizer steps, 12
    python3 chip_smoke.py --mamba2-only --only=h  # phases 1-3, 4's mamba2 and DoRA
                                                  # steps, 13
    python3 chip_smoke.py --parallel-only --only=h  # phases 1-3, 4's two-rank steps, 14, 15
    python3 chip_smoke.py --pp-only --only=h,c  # phases 1-3, then 16
    python3 chip_smoke.py --board-only --only=h  # phases 1-3, then 17

--kernels-only, --text-only, --train-only, --dt-only, --pref-only, --long-only,
--mamba2-only, --parallel-only, --pp-only and --board-only are shortcuts for
work on one part: they stop before the `kernels` line, the card's line and
the final `{"ok": ...}` line, so only the run without them is the whole
check. --only= is taken with one of the ten and refused otherwise.

Phases (each prints its lines; any failure raises and the exit code is
non-zero):
  1. environment: torch / CUDA / nvcc versions, the card's name and power limit
  2. build: the kernels from infinitevl_tpu_torch/csrc/ with nvcc (sm_90a),
     one compiler per source, all started together
  3. kernel parity: each of the nine kernels (A1, A2, B, C, E, G, D, F, H;
     H forward and backward, dq, dk, dv) against its plain torch version on
     the card, at the main paths' shapes, the gradients of the autograd
     wrappers of C, E and F against the plain versions', the ViT's gates
     measured, with its time beside the plain version's, its bound (the least
     time the card could take for the same bytes and operations) and,
     where one PyTorch call computes the same function (A1, A2, D, E, F:
     scaled_dot_product_attention with the explicit mask, and for E and F
     at their one-segment shapes also without it, on the flash backend;
     G: one bf16 matmul on the dequantised weight), that call's time; E's
     and F's device times in a CUDA graph, the consumer warpgroups a block
     that the wrapper launched them with, and their key tiles by kind as the
     walk's twin predicts them (ops/vit_kernels.vit_tile_walk; a prediction,
     printed, not measured); A2's and D's device times in a CUDA graph
     with the rings L2-cold (rotated over 9) at B 1 and 4, beside masked
     and unmasked SDPA timed the same way with the token's write on both
     sides, A2 in bf16 and fp32 under two windows and two calls held bit
     for bit; B in bf16 and fp32, its device kernels in one call (one) and
     its device time with the state L2-cold at B 1 and 4; C's bf16 body
     against the fp32 and the bf16 plain versions and the twin of its
     passes, over T 16,384 from a state, two calls bit for bit, its device
     times in a CUDA graph (unpacked and packed), its passes by the profiler
     and the scan under each value tile, its bound on the bf16 tensor cores
     and on fp32 FMA. The library call is a yardstick only; the port never
     calls it
  4. cross-device check: a small fp32 model on the CPU (plain versions) and
     on the card (kernels), through Generator (text; then int4 + fused
     projections, and speculative against greedy decoding on the card) and
     through StreamingEngine (prime, 3 frames, ask); then three training
     steps (full, LoRA with remat, one multimodal batch) on both devices,
     and one step on packed rows
  5. text path: the InfiniteVL-3B decoder (bf16, random weights from seed 0)
     answering three requests through Generator (full depth; prompts of
     50, 1,000 and 9,000 tokens, 32 new tokens each: nothing was cut to
     make room for phase 6); under --profile one decode step after the
     9,000-token request (the ring full) by kernel
  6. streaming path, at full 3B width and depth (ViT 32 blocks, decoder 36
     layers): StreamingEngine at 448x448, prime, 48 raw frames (the ring
     wraps after 32), an `ask` in the middle and one at the end, the
     frames-ask-frames state held bit for bit against the same frames with
     no ask; then one Generator request with a 1344x1344 image, which
     reaches kernel E; the native host preprocessing (infinitevl_tpu_torch
     .native, built with g++) on 8 of the raw frames against
     data/processing.preprocess_image, with FramePipeline, host ms a frame
     of each; under --profile a steady frame, the image's ViT and
     one `ask` (its device kernels and those of the T <= 64 recurrence)
  7. serving path, at full 3B width and depth: the weights quantised to
     int4 on the card, an HTTP chat server on a loopback port answering
     real requests (plain, streamed over SSE, n = 2 with a stop sequence,
     one with an image as a data URI), then on the same generator
     speculative decoding against greedy, beam search, a BatchingEngine
     burst of 8 requests; then per weight format (int4, bf16, int8, fused)
     one text request and 13 streamed frames
  8. training path, at 3B width and 12 layers (3 hybrid periods), through
     run_sft / Trainer:
     LoRA at 2,048 and 8,192 tokens, LoRA on packed rows (packing: true),
     QLoRA (int8 base), full finetuning,
     multimodal LoRA steps at 448x448 and 1344x1344, save / resume
  9. the ViT at window_size 224 (windows of 256 patches: kernel F), one
     1344x1344 image forward and one training step with gradients through
     F and E; then the step's peak memory at windows of 256 and 1,024
     patches, F's backward through its chunked twin and through the
     batched-dense plain version
 10. checkpoints and distillation, at 3B width and 4 layers (bf16, random
     weights from seed 0): the all-full_attention teacher twin with the ViT
     exported as HF safetensors in shards of 2 GB and read back (leaves and
     a 64-token prompt's logits bit-equal; bytes, seconds, GB/s); stage 1 of
     examples/train_3b_stage1.yaml through run_dt (teacher_model_path set
     to that checkpoint, data_parallel 1, 2 steps on packed rows of 8,192);
     stage 2 (cutoff 2,048, 2 steps, no train state written) with the
     handoff from stage 1's train state; one multimodal stage-2 step at 448x448; the teacher held
     bit-unchanged after each run and the launches per step held to the
     code's count; then the student exported through cli.cmd_export,
     served through cli._build_generator (32 greedy tokens equal to the
     in-memory student's), scored by cli.cmd_eval on examples/eval_mcq.yaml
     at 3B (each padded prediction equal to the prompt's alone without
     pads), and one cli.cmd_api request on a loopback port
11. the preference stages, at full 3B width (bf16, random weights from
     seed 0), through run_exp: rm, dpo (sigmoid, then orpo with no reference
     built) and kto at 4 layers, cutoff 1,024, two pairs (rows) a
     step, remat, 2 steps each, no train state written (DPO's first loss ln
     2, KTO's 0.5, the policy's and its frozen clone's first log-probs
     bit-equal, the clone bit-unchanged after the steps); then rm at 4
     layers from a 4-layer checkpoint with its train state saved, and ppo
     (fp32) at 4 layers from both: B 4 prompts of 256 tokens, 64 tokens
     sampled at temperature 1, 3 iterations, the first KL 0; launches per
     step held to the code's count
12. long-context training and the custom optimizers, at 3B (bf16, random
     weights from seed 0, B 1): examples/sft_32k_lora_yarn.yaml at cutoff
     32,768 and examples/sft_64k_qlora_yarn.yaml at 65,536 (4 layers each, 1 step each)
     through run_sft with gradient accumulation 8 -> 1, through the
     sequence-chunked SWA (kernel H over 2 windows), DeltaNet (kernel C from
     the carried state) and MLP layers; at 4 layers one LoRA step at 16,384 chunked
     against the full-T path (loss and LoRA gradients); galore, apollo,
     badam and adam_mini as full finetuning and loraplus on LoRA at 2,048 and
     4 layers, 3 steps; the frozen base bit-unchanged, no train state written, launches
     per step held to the code's count; GaLore's SVD of the tied embedding
13. the Mamba2 conversion mixer and the LoRA variants at 3B width and 12
     layers (bf16, random weights from seed 0, B 1): stage 1 of
     examples/train_3b_stage1.yaml with
     mixer mamba2 (data_parallel 1, 3 steps on packed rows of 8,192, the
     teacher the all-full_attention twin with the ViT; the weight copy held
     before step 1, the teacher and frozen leaves bit-unchanged after), the
     student served (16 raw 448x448 frames through StreamingEngine and an
     ask, its state constant and the stream untouched by the ask; a
     1,000-token text request through Generator); DoRA through run_sft at
     2,048 (its first loss the base model's), pissa_decompose on 4 layers
     (the base's logits back), loftq_init on 2 layers (below plain int8's
     error on every kernel), one LoRA step each
14. data parallelism at 3B, in one world of two gloo ranks sharing the card
     (NCCL refuses two ranks on one GPU): (a) stage 1 of
     examples/train_3b_stage1.yaml at 4 layers, data_parallel 2 under fsdp
     (warm-up 100 -> 0, 2 steps on packed rows of 2,048) against the same steps in one
     process at per_device_train_batch_size 2 (losses, and after step 1 the
     trainable leaves and their first moments), the teacher bit-unchanged on
     each rank, each rank holding exactly half the sharded bytes; (b) full
     finetuning through run_sft at 2,048 on data/demo.json streamed, fsdp and
     replicated at 4 layers (their losses equal); (d) DoRA, GaLore (its
     projection refresh), APOLLO and Adam-mini through run_sft at 2 layers,
     2 steps, data_parallel 2 under fsdp, each against one process at the
     same global batch; (c) the port's
     collectives (the layer gather forward and backward, the gradient and
     count all_reduce) in a world of one NCCL rank, bit-equal at world 1
15. tensor parallelism at 3B (the model axis: Megatron-style slices with
     their collectives in the forwards), gloo ranks sharing the card: in one
     world of two (model_parallel 2) (a) full finetuning through run_sft at
     8 layers, T 2,048, tp, 2 steps, against one process (losses, exactly
     half the model-sharded bytes a rank, each rank's peak, the all_reduce
     seconds and the head's share), and in fp32 every trainable leaf's
     gradient on the first batch, slice by slice; (b) stage 1 of train_3b_stage1.yaml at 4
     layers and packed rows of 8,192 (the teacher bit-unchanged); (d) one
     multimodal LoRA step at 4 layers with the ViT's 32 blocks (E and F)
     against one process; (e) generation.prefill of 1,000 tokens and 16
     decode_step calls on the sharded params and each rank's part of the
     state, at 4 layers in fp32 (greedy tokens equal, logits <= 1e-3) and
     8 in bf16 (fed tokens, logits <= 1e-2, beside the fp32 model's); (f)
     stage 1 with mixer mamba2 at 4 layers, packed rows of 2,048, against
     one process; (g) the Mamba2 student's prefill of 1,000 tokens and 16
     greedy decode steps in fp32 at 4 layers against one process (logits
     <= 1e-3, tokens equal, each rank exactly half of mamba_conv and
     mamba_h, the state's bytes flat); (h) DoRA, Adam-mini, GaLore and QLoRA
     through run_sft at 2 layers, 2 steps each, against one process; then
     in a world of four (data 2 x model 2) (c) full finetuning under fsdp
     at 4 layers against phase 14 (b)'s replicated run (the same global
     batch)
16. pipeline parallelism at 3B (parallel/pipeline.py and pipeline_seq.py
     through run_sft), one world of three gloo ranks sharing the card, pipe 3
     (36 layers are 9 pattern periods: 2 stages cannot cut them): (a) in fp32
     at 12 layers every trainable leaf's gradient on run_sft's first batch (2
     packed rows of 2,048, 2 microbatches) under gpipe and 1f1b against one
     process (err_ratio <= 1e-4), then full finetuning at 12 layers in bf16,
     2 steps under each schedule, against one process (losses within 5e-3;
     ms a step, peak and bytes held a rank: a third of the layers and the
     whole replicated leaves); (b) one step of each schedule at 2 and 6
     microbatches of one row at 36 layers, each step's peak (1f1b's must grow less than
     gpipe's); (c) pp_microbatch_axis sequence at T 16,384 (two chunks of
     one window), 12 layers, against the unpipelined chunked run; H and C
     launched on every rank, held to the code's counts in (a) and (b)
17. the training web board (serve/webui.py) at 3B width and 4 layers (one
     hybrid period, with the ViT; bf16, random weights from seed 0), in this
     process on a loopback port: the model exported as HF safetensors, then
     through the board's routes a LoRA run of 3 steps at cutoff 1,024 on
     data/demo.json (one log line a step, finite losses, the base
     bit-unchanged; its steps timed by utils/profiling.StepTimer, the MFU
     against the H100's 989 TFLOP/s), a second run aborted after its first
     logged step, an MCQ eval and a predict-mode eval, chat (a greedy text
     turn of 16 tokens equal to Generator.generate's, one turn with a
     448x448 image; the state's size constant), one chat turn under
     profiling.trace() read back for its CUDA kernel events, a decode step
     against decode_hbm_floor_ms of decode_weight_read_bytes, /api/export
     reloaded (the same greedy tokens); then scripts/torch_prefill_bench.py
     (LoRA step at 2,048), torch_cal_mfu.py --measure and
     torch_batch_infer.py on the exported checkpoint, all at 4 layers
Phase 3 also holds H on the chunked SWA layer's calls (2 windows, ids -1 /
row / -2), and A1, A2, H, B, C, E and F at the local shapes of
model_parallel 2 (GQA 8/1, 8 DeltaNet heads, 8 ViT heads). Phase 4 also takes one distillation step of each stage, one step
each of rm, dpo and kto, one PPO iteration at temperature 0, three steps
through the sequence-chunked layers and three of each custom optimizer, a
hybrid with Mamba2 layers (cached prefill, decode, greedy tokens), one
stage-1 step of the mamba2 conversion and one DoRA step on the small fp32
model, CPU against card, and two run_sft steps over two gloo ranks on the
card against one process at the same global batch (fsdp, packed rows; the
ranks' half runs first in phase 14's world). Every process the script
starts reads and writes Python bytecode under PYCACHE, filled beside the
kernels' compilers in phase 2.
Launch counts are set to 0 just before each path (the text requests, the
stream, the image request, the int4 serving requests, every training
recipe, the ViT path, every distillation run and CLI command, every preference
stage, every phase-12 run, phase 13's runs, frames, ask and request, each rank
of phase 14's, 15's and 16's runs, summed, phase 17's routes and scripts) and
read just after it. A `[time]`
line gives each phase's seconds. Then a JSON line of per-kernel results, the card's line, and
as the last line {"ok": true, "device": {...}}. Without a CUDA card it
exits non-zero and prints no result."""

from __future__ import annotations

import json
import os
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
PACKED_TOL = 1e-4  # one fp32 training step on packed rows, CPU vs card: loss, grads, params
TIMING_REPS = 20

# published peaks of one H100 SXM (dense, no sparsity), for the bounds
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # outside the tensor cores

# main-path shapes of the InfiniteVL-3B text decoder (GQA 16/2, head_dim
# 128, window = ring capacity 8192; 9 SWA + 27 DeltaNet layers, DeltaNet
# heads 16 x (K 128, V 256)); T = 2048 is the chunked-prefill chunk
# A1: T 257 is one 448x448 frame (the streaming path), T 2048 a prefill chunk;
# the frame's shape is split over the key tiles (split-KV) and is checked
# under every split of its plan. Timed: the frame, then the chunk (main)
A1_CASE = dict(Bs=(1, 2), Hq=16, Hkv=2, cap=8192, Ts=(257, 2048),
               cums=(0, 5000, 20000), split_T=257,
               timed=((1, 257, 20000), (1, 2048, 20000)))
# A2 and D: parity in bf16 and fp32 under the deployed window (= cap) and a
# window of half the ring (its lower edge inside the ring); the wrapper timed
# at (B, cum_len); device times L2-cold at (B, cum_len, window), the first
# the main one
A2_CASE = dict(S=9, Hq=16, Hkv=2, cap=8192, Bs=(1, 4),
               cums=(0, 8191, 8192, 20000), windows=(8192, 4096), timed=(1, 20000),
               cold=((1, 20000, 8192), (4, 20000, 8192), (1, 20000, 4096)),
               # shapes the wrapper takes beyond 3B's: (B, Hq, Hkv, cap, window,
               # cum_len) with 4 and 16 query heads a KV head (a padded n-tile, two
               # n-tiles) and rings of no multiple of the 64-slot tile
               extra=((1, 8, 2, 8192, 8192, 20000), (2, 32, 2, 8192, 8192, 20000),
                      (2, 16, 2, 8000, 8000, 20000), (1, 16, 2, 8000, 3000, 7999)))
# decode split plans timed beside the wrapper's own (A2, cold): (SMs a
# block, least tiles a split)
DECODE_PLANS = ((1, 2), (2, 1), (2, 2), (2, 4), (4, 2))
B_CASE = dict(L=27, H=16, K=128, V=256, Bs=(1, 4), layers=(0, 13, 26), timed=(1, 13))
# kernel C at the DeltaNet layer's shape (16 heads, K 128, V 256): a 448x448
# frame is T = 257, a chunked-prefill chunk T = 2048, T = 100 a ragged tail
C_CASE = dict(H=16, K=128, V=256, Bs=(1, 2), Ts=(257, 2048, 100), timed=(257, 2048))
# kernel E at the ViT's shape (16 heads, head dim 80): S = 9216 is one
# 1344x1344 image, S = 4100 a ragged length just above the model's gate
# (both three consumer warpgroups a block), S = 1024 one 448x448 frame and
# 1000 a ragged length below it (two); timed at the image and the frame
E_CASE = dict(H=16, D=80, Ss=(9216, 4100, 1024, 1000), timed=(9216, 1024))
# kernel H at the SWA layer's shape (GQA 16/2, head dim 128): (T, window,
# batch sizes); 8192 is the deployed window, T 4096 under a window of 1024
# exercises the band's lower edge, 257 a ragged length. The plain version's
# [T, T] scores at T 8192 leave room for B 1 only. Timed at B 1.
H_CASE = dict(Hq=16, Hkv=2,
              cases=((257, 8192, (1, 2)), (2048, 8192, (1, 2)), (4096, 1024, (1, 2)),
                     (8192, 8192, (1,))),
              timed=((2048, 8192), (8192, 8192), (4096, 1024)))
# kernel H as the sequence-chunked SWA layer calls it (models/text.swa_forward_seq_chunked):
# (prev ++ cur) = 2 windows = 16,384 positions at the deployed window, B 1, bf16, the ids
# not ascending: the first chunk's -1 (zero history), a later chunk's previous segments,
# then the row's, then -2 for tail pads. `cut` is where the row's second segment starts,
# `pad` the tail pads. Timed on the first chunk's ids.
H_CHUNK_CASE = dict(W=8192, cut=3000, pad=700, block=2048)
H_BWD_F32_TOL = 1e-4  # fp32 gradients: sums over up to 8192 keys and 8 heads, in another order
# kernel F at the ViT's shape: (S, win_len) with pads; 9216 patches are one
# 1344x1344 image, 1024 one 448x448 frame; 64 is the deployed window
# (window_size 112), 256 that of window_size 224
F_CASE = dict(H=16, D=80, cases=((9216, 64), (9216, 256), (9216, 1024), (1024, 64), (1000, 40)),
              timed=((9216, 256), (9216, 64), (1024, 64), (9216, 1024)))
GATE_FULL_SEQS = (1024, 2048, 4096, 6144)
# requests of phase 5: recurrent path, chunk path, chunked prefill + ring wrap
MAIN_PROMPTS = (50, 1000, 9000)
MAIN_NEW_TOKENS = 32
# phase 6: frames before the first ask (the 8192-slot ring wraps after 32
# frames of 257 tokens), between the asks, and after the second
STREAM_FRAMES = (36, 8, 4)
ASK_NEW_TOKENS = 17  # the first token, then 16 decode steps
# kernel G at the 3B widths: (d_in, d_out, group size). MLP up and down,
# the k/v projection, the fused DeltaNet projection (12320 columns: a ragged
# last strip), the ViT MLP (3420 columns are no multiple of 16; d_in 3420
# has a half of 1710 rows, so the column is one group), per-column scales.
# Ms: decode, beams, the verify window (9), the bf16 tile edges (64 rows:
# one warpgroup; 65 and 128: two), a frame's 257 tokens, a ViT frame's 1024
# patches, a prefill chunk (big_M, on the first shape). Timed: (d_in, d_out,
# M) on the MLP shapes and, at M 1024, the ViT MLP's
G_CASE = dict(shapes=((2048, 11008, 128), (11008, 2048, 128), (2048, 256, 128),
                      (2048, 12320, 128), (1280, 3420, 128), (3420, 1280, 128),
                      (2048, 2048, 1 << 20)),
              Ms=(1, 3, 8, 9, 64, 65, 128, 257, 1024), big_M=2048,
              # scale groups of 32 input rows (32 rows per plane: below a 64-row
              # stage, a fold per 16-row k-step), 48 (k-step folds whose groups
              # straddle stages), 64 (one stage) and 8 (splits a k-step: the FMA
              # tiles), at decode, the verify window, the two-warpgroup edge and
              # a frame; 32 and 64 timed at M 257
              group_shapes=((2048, 11008, 32), (2048, 11008, 64), (11008, 2048, 32),
                            (11008, 2048, 64), (1280, 3420, 64), (3072, 256, 48),
                            (2048, 256, 8)),
              group_Ms=(1, 9, 65, 257), group_timed=257,
              timed=tuple((d_in, d_out, M) for d_in, d_out in ((2048, 11008), (11008, 2048))
                          for M in (1, 9, 257, 2048))
              + ((1280, 3420, 1024), (3420, 1280, 1024)))
NATIVE_FRAMES = 8  # phase 6: frames through the native host preprocessing
NATIVE_TOL = 1e-5  # its difference from the numpy path (tests/test_native.py's, same-size resize)
HIRES_HW = 1344
HIRES_NEW_TOKENS = 8
# phase 7
SERVE_NEW_TOKENS = 24  # per HTTP request
SERVE_IMAGE_HW = 448
SPEC_NEW_TOKENS = 32
SPEC_DRAFT_K = 8
BEAM_NEW_TOKENS = 12
BURST = 8  # BatchingEngine requests of one length
BURST_NEW_TOKENS = 16
MODE_NEW_TOKENS = 32  # decode rate per weight format
MODE_FRAMES = 13  # streamed frames per weight format
# bf16 logits of two decodings of one context (a K-token window against
# single steps) differ by rounding; a token that differs must be a near tie
TIE_TOL = 0.25
# err_ratio of a verify window's bf16 logits against the single steps' (36
# layers of bf16 rounding on two routes: A1 + recurrence + M = 8 matmuls
# against A2 + B + M = 1; the unquantised bf16 weights are held to the same
# limit beside int4, and the fp32 model of phase 4 to MODEL_TOL); wrong
# positions or conv history would give ~1
SPEC_LOGIT_TOL = 0.15


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


def time_graph_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Device time of one fn() with the host out of the way: `calls` calls
    captured into a CUDA graph (the wrappers launch on the current stream,
    which is the capturing one), the graph replayed `reps` times between
    two events."""
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):  # warm up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * reps)


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


# Python's bytecode for every process of the run, kept under the checkout's
# build directory: where site-packages holds no bytecode that the interpreter
# can use or write, each process compiles torch's modules from source, and
# phases 4 and 14-16 start a fresh interpreter for every rank of every world
PYCACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "infinitevl_tpu_torch",
                       "_build", "pycache")
# what a rank imports: at its start, at its first collective and first backward
WARM_IMPORTS = ("torch", "torch.distributed", "torch.distributed.fsdp",
                "torch.distributed.tensor", "torch._dynamo",
                "torch.fx.experimental.symbolic_shapes", "sympy", "numpy",
                "infinitevl_tpu_torch.train.trainer", "infinitevl_tpu_torch.parallel.launch",
                "infinitevl_tpu_torch.parallel.pipeline", "infinitevl_tpu_torch.parallel.pipeline_seq",
                "infinitevl_tpu_torch.serve.webui", "infinitevl_tpu_torch.cli")


def start_bytecode_cache() -> subprocess.Popen:
    """Point this process and every process it starts at PYCACHE, and start
    one interpreter that imports WARM_IMPORTS into it (phase_build waits for
    it, so it runs beside the kernels' compilers)."""
    os.makedirs(PYCACHE, exist_ok=True)
    os.environ["PYTHONPYCACHEPREFIX"] = PYCACHE
    sys.pycache_prefix = PYCACHE
    sys.dont_write_bytecode = False
    env = {k: v for k, v in os.environ.items() if k != "PYTHONDONTWRITEBYTECODE"}
    prog = ("import importlib, sys\n"
            f"for m in {WARM_IMPORTS!r}:\n"
            "    try:\n"
            "        importlib.import_module(m)\n"
            "    except Exception as e:\n"
            "        print(f'{m}: {e!r}', file=sys.stderr)\n")
    return subprocess.Popen([sys.executable, "-c", prog], env=env,
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)


def phase_build(warm: subprocess.Popen = None) -> None:
    from infinitevl_tpu_torch.ops import _build

    cached = _build.library_path().exists()
    t0 = time.perf_counter()
    try:
        _build.load_library()
    finally:
        if warm is not None:
            _, err = warm.communicate()
    print(f"[2 build] {'loaded cached' if cached else 'built'} "
          f"{_build.library_path().name} in {time.perf_counter() - t0:.2f} s", flush=True)
    if warm is not None:
        n = sum(len(files) for _, _, files in os.walk(PYCACHE))
        print(f"[2 build] bytecode cache: {n} files under {PYCACHE} (exit code "
              f"{warm.returncode}{'; ' + err.strip() if err.strip() else ''}), waited for "
              f"with the build", flush=True)


def _a1_cases(dev, gen):
    from infinitevl_tpu_torch.ops import swa_kernels as sk
    from infinitevl_tpu_torch.ops.swa import (
        ring_slot_positions,
        sliding_window_mask,
        swa_cached_attention,
        swa_cached_attention_split,
    )
    from infinitevl_tpu_torch.ops.swa_kernels import swa_ring_flash_attention

    c = A1_CASE
    Hq, Hkv, D, cap = c["Hq"], c["Hkv"], 128, c["cap"]
    G = Hq // Hkv
    target = sk.PREFILL_TARGET_BLOCKS

    def force(B, T, split):
        """A1's plan with `split` splits of the key tiles."""
        sk.PREFILL_TARGET_BLOCKS = -(-T * G // sk.PREFILL_ROWS) * B * Hkv * split
        got = sk.prefill_split_plan(B, T, Hq, Hkv, cap).split
        require(got == split, f"A1: forced split {split}, the plan gives {got}")

    mk = lambda *s: torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
    errs, mxs, e_split = [], [], []
    for B in c["Bs"]:
        for T in c["Ts"]:
            for cum in c["cums"]:
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
                if B == 1 and T == c["split_T"]:
                    # every split of the frame's plan against the plain split-and-
                    # combine (split-KV is exact up to rounding) and the plain attention
                    plan = sk.prefill_split_plan(B, T, Hq, Hkv, cap).split
                    for split in range(1, plan + 1):
                        force(B, T, split)
                        o_s = swa_ring_flash_attention(q, nk, nv, rk, rv, cum, cap)
                        r_s = swa_cached_attention_split(q, nk, nv, rk, rv, cum, cap, split)
                        torch.cuda.synchronize()
                        e = max(err_ratio(o_s, ref), err_ratio(o_s, r_s))
                        require(e <= BF16_TOL, f"A1 T={T} cum={cum} split={split} "
                                               f"err_ratio {e:.3g}")
                        e_split.append(e)
                    sk.PREFILL_TARGET_BLOCKS = target

    timed = {}
    for B, T, cum in c["timed"]:
        q, nk, nv = mk(B, T, Hq, D), mk(B, T, Hkv, D), mk(B, T, Hkv, D)
        rk, rv = mk(B, Hkv, cap, D), mk(B, Hkv, cap, D)
        kern = lambda: swa_ring_flash_attention(q, nk, nv, rk, rv, cum, cap)
        ms = time_ms(kern)
        plain = time_ms(lambda: swa_cached_attention(q, nk, nv, rk, rv, cum, cap,
                                                     write_ring=False))
        ref = swa_cached_attention(q, nk, nv, rk, rv, cum, cap, write_ring=False)
        # the library call on the same keys and mask
        q_pos = cum + torch.arange(T, device=dev)
        k_pos = torch.cat([ring_slot_positions(cum, cap, dev), q_pos])
        mask = sliding_window_mask(q_pos, k_pos, cap)
        k_all = torch.cat([rk.transpose(1, 2), nk], 1).repeat_interleave(G, 2)
        v_all = torch.cat([rv.transpose(1, 2), nv], 1).repeat_interleave(G, 2)
        e_lib = err_ratio(sdpa(q, k_all, v_all, mask), ref)
        require(e_lib <= BF16_TOL, f"A1 library call err_ratio {e_lib:.3g}")
        lib = time_ms(lambda: sdpa(q, k_all, v_all, mask))
        seen = sum(min(cap, cum + t + 1) for t in range(T))  # keys per query
        bnd = bound(2 * (2 * B * T * Hq * D + 2 * B * T * Hkv * D + 2 * B * Hkv * cap * D),
                    4 * B * Hq * D * seen, PEAK_BF16_FLOPS)
        plan = sk.prefill_split_plan(B, T, Hq, Hkv, cap)
        # every split up to the plan's and one beyond
        by_split = {}
        for split in range(1, plan.split + 2):
            force(B, T, split)
            by_split[str(split)] = time_ms(kern)
        sk.PREFILL_TARGET_BLOCKS = target
        timed[T] = dict(ms=ms, plain_ms=plain, library_ms=lib, split=plan.split,
                        scratch_bytes=plan.scratch_bytes, ms_by_split=by_split, **bnd)
        print(f"[3 parity] A1 timed (B, T, cum_len) ({B}, {T}, {cum}), bf16: kernel {ms:.3f} ms "
              f"(plan: split {plan.split}, scratch "
              f"{plan.scratch_bytes / 1e6:.1f} MB), plain {plain:.3f} ms, library {lib:.3f} ms, "
              f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); ms by split: "
              + ", ".join(f"{k} {v:.3f}" for k, v in by_split.items()), flush=True)
    print(f"[3 parity] A1 swa_ring_flash_attention: max err_ratio {max(errs):.3g} "
          f"(tol {BF16_TOL}), max|diff| {max(mxs):.3g} over B {c['Bs']} x T {c['Ts']} x "
          f"cum_len {c['cums']}; T {c['split_T']} under every split of its plan against the "
          f"plain attention and the plain split-and-combine: "
          f"{max(e_split):.3g}", flush=True)
    frame = timed[c["split_T"]]
    main = timed[c["timed"][-1][1]]
    return dict(max_abs_err=max(mxs), **main,
                **{f"{k}_t{c['split_T']}": v for k, v in frame.items()})


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
    errs, mxs = {torch.bfloat16: [], torch.float32: []}, []
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        for B in c["Bs"]:
            mk = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)
            rks, rvs = mk(S, B, Hkv, cap, D), mk(S, B, Hkv, cap, D)
            for window in c["windows"]:
                for i, cum in enumerate(c["cums"]):
                    layer = (3 * i + B) % S
                    q, nk, nv = mk(B, 1, Hq, D), mk(B, 1, Hkv, D), mk(B, 1, Hkv, D)
                    k_krn, v_krn = rks.clone(), rvs.clone()
                    k_ref, v_ref = rks.clone(), rvs.clone()
                    out = swa_ring_flash_decode_stacked(q, nk, nv, k_krn, v_krn, layer, cum,
                                                        window)
                    ref = swa_cached_attention(q, nk, nv, k_ref[layer], v_ref[layer], cum,
                                               window, write_ring=False)
                    ring_write_stacked(k_ref, v_ref, layer, nk, nv, cum)
                    torch.cuda.synchronize()
                    e = err_ratio(out, ref)
                    what = f"A2 {dtype} B={B} window={window} cum={cum} layer={layer}"
                    require(e <= tol, f"{what} err_ratio {e:.3g}")
                    require(torch.equal(k_krn, k_ref) and torch.equal(v_krn, v_ref),
                            f"{what}: stacked rings differ from the plain write")
                    # bit-reproducible: the same call on equal inputs
                    k_two, v_two = rks.clone(), rvs.clone()
                    out_two = swa_ring_flash_decode_stacked(q, nk, nv, k_two, v_two, layer,
                                                            cum, window)
                    require(torch.equal(out_two, out) and torch.equal(k_two, k_krn)
                            and torch.equal(v_two, v_krn), f"{what}: two calls differ")
                    errs[dtype].append(e)
                    if dtype == torch.bfloat16:
                        mxs.append(max_abs(out, ref))
                    if (dtype, B, cum, window) == (torch.bfloat16, *c["timed"], cap):
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
                        del k_all, v_all
            del rks, rvs, k_krn, v_krn, k_ref, v_ref, k_two, v_two
        for B, hq, hkv, cp, window, cum in c["extra"]:
            mk = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)
            rks, rvs = mk(2, B, hkv, cp, D), mk(2, B, hkv, cp, D)
            q, nk, nv = mk(B, 1, hq, D), mk(B, 1, hkv, D), mk(B, 1, hkv, D)
            ref = swa_cached_attention(q, nk, nv, rks[1], rvs[1], cum, window,
                                       write_ring=False)
            k_ref, v_ref = rks.clone(), rvs.clone()
            ring_write_stacked(k_ref, v_ref, 1, nk, nv, cum)
            out = swa_ring_flash_decode_stacked(q, nk, nv, rks, rvs, 1, cum, window)
            torch.cuda.synchronize()
            e = err_ratio(out, ref)
            what = f"A2 {dtype} (B, Hq, Hkv, cap, window, cum_len) {(B, hq, hkv, cp, window, cum)}"
            require(e <= tol, f"{what} err_ratio {e:.3g}")
            require(torch.equal(rks, k_ref) and torch.equal(rvs, v_ref),
                    f"{what}: stacked rings differ from the plain write")
            errs[dtype].append(e)
    print(f"[3 parity] A2 swa_ring_flash_decode_stacked: max err_ratio bf16 "
          f"{max(errs[torch.bfloat16]):.3g} (tol {BF16_TOL}), fp32 "
          f"{max(errs[torch.float32]):.3g} (tol {F32_TOL}) over B {c['Bs']} x window "
          f"{c['windows']} x cum_len {c['cums']} and (B, Hq, Hkv, cap, window, cum_len) "
          f"{c['extra']}; rings bit-equal to the plain write, two calls bit-equal at "
          f"3B's shapes; (B, cum_len)={c['timed']}: kernel {ms:.3f} ms around the "
          f"wrapper, plain {plain:.3f} ms, library {lib:.3f} ms", flush=True)
    res = dict(max_abs_err=max(mxs), ms=ms, plain_ms=plain, library_ms=lib)
    for B, cum, window in c["cold"]:
        r = _decode_cold(dev, gen, B, cum, window, stacked=True)
        tag = "" if (B, cum, window) == c["cold"][0] else f"_b{B}_w{window}"
        res.update({f"{k}{tag}": v for k, v in r.items() if not (tag and k == "bound_by")})
    return res


def _decode_cold(dev, gen, B: int, cum: int, window: int, stacked: bool) -> dict:
    """A2 (stacked) or D's device time in a CUDA graph with the rings cold
    in L2, beside scaled_dot_product_attention's on the same work: the calls
    rotate over 9 rings (the layers of one stack for A2, 9 separate rings
    for D; 75 MB at B 1 against the 50 MB L2), as in a decode step, where
    the other layers' rings, the DeltaNet state and the weights pass between
    two reads of one ring. The token's write is on both sides: the kernel
    writes it itself, the library side by two index copies before the
    attention call (masked: the window's mask over the ring with the heads
    repeated, [B, cap, Hq, D]; unmasked, where the window covers the full
    ring: the same heads-repeated copy, and the flash backend with
    enable_gqa over the ring as it lies, [B, Hkv, cap, D], where torch
    takes it). Also the kernel's L2-warm time (one ring) and, for A2, its
    cold time under other split plans."""
    from infinitevl_tpu_torch.ops import swa_kernels as sk
    from infinitevl_tpu_torch.ops.swa import (
        ring_slot_positions,
        sliding_window_mask,
        swa_cached_attention,
    )

    c = A2_CASE
    S, Hq, Hkv, D, cap = c["S"], c["Hq"], c["Hkv"], 128, c["cap"]
    G = Hq // Hkv
    mk = lambda *s: torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
    q, nk, nv = mk(B, 1, Hq, D), mk(B, 1, Hkv, D), mk(B, 1, Hkv, D)
    if stacked:
        stack_k, stack_v = mk(S, B, Hkv, cap, D), mk(S, B, Hkv, cap, D)
        rings = [(stack_k[i], stack_v[i]) for i in range(S)]
    else:
        rings = [(mk(B, Hkv, cap, D), mk(B, Hkv, cap, D)) for _ in range(S)]
    turn = [0]

    def call(i):
        if stacked:
            return sk.swa_ring_flash_decode_stacked(q, nk, nv, stack_k, stack_v, i, cum, window)
        return sk.swa_ring_flash_decode(q, nk, nv, rings[i][0], rings[i][1], cum, window)

    def rot(fn):
        def run():
            turn[0] += 1
            return fn(turn[0] % S)
        return run

    device_ms = time_graph_ms(rot(call))
    warm_ms = time_graph_ms(lambda: call(0))
    by_plan = {}
    if stacked and hasattr(sk, "DECODE_SMS_PER_BLOCK"):
        kept = sk.DECODE_SMS_PER_BLOCK, sk.DECODE_MIN_TILES
        for per_block, least in DECODE_PLANS:
            sk.DECODE_SMS_PER_BLOCK, sk.DECODE_MIN_TILES = per_block, least
            plan = sk.decode_split_plan(B, Hq, Hkv, cap, cum, window, sk.sm_count(dev.index))
            by_plan[f"{per_block}x{least}:{plan.split}x{plan.tiles_per_split}"] = \
                time_graph_ms(rot(call))
        sk.DECODE_SMS_PER_BLOCK, sk.DECODE_MIN_TILES = kept
    # the library: every ring's heads repeated, the write as two index copies
    slot = cum % cap
    reps = [(rk.transpose(1, 2).repeat_interleave(G, 2), rv.transpose(1, 2).repeat_interleave(G, 2))
            for rk, rv in rings]
    nk_rep, nv_rep = nk[:, 0].repeat_interleave(G, 1), nv[:, 0].repeat_interleave(G, 1)
    mask = sliding_window_mask(torch.tensor([cum], device=dev),
                               ring_slot_positions(cum + 1, cap, dev), window)
    full = window == cap and cum + 1 >= cap  # every slot visible: no mask needed

    def lib(m):
        def one(i):
            k_all, v_all = reps[i]
            k_all[:, slot] = nk_rep
            v_all[:, slot] = nv_rep
            return sdpa(q, k_all, v_all, m)
        return one

    def gqa(i):  # the flash backend over the ring as it lies, heads not repeated
        from torch.nn.attention import SDPBackend, sdpa_kernel

        rk, rv = rings[i]
        rk[:, :, slot] = nk[:, 0]
        rv[:, :, slot] = nv[:, 0]
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), rk, rv, enable_gqa=True).transpose(1, 2)

    ref = swa_cached_attention(q, nk, nv, *rings[0], cum, window, write_ring=False)
    checks = [("masked", lib(mask))] + ([("unmasked", lib(None)), ("gqa", gqa)] if full else [])
    lib_ms = {}
    for name, fn in checks:
        try:
            e = err_ratio(fn(0), ref)
        except RuntimeError as err:  # the flash backend refused enable_gqa
            lib_ms[name] = None
            print(f"[3 parity]   library {name}: not available ({str(err)[:80]})", flush=True)
            continue
        require(e <= BF16_TOL, f"decode library call ({name}) err_ratio {e:.3g}")
        lib_ms[name] = time_graph_ms(rot(fn))
    n_vis = min(cum + 1, window)
    bnd = bound(2 * (2 * B * Hkv * n_vis * D + 2 * B * Hq * D + 4 * B * Hkv * D),
                4 * B * Hq * D * n_vis, PEAK_BF16_FLOPS)
    kind = "A2" if stacked else "D"
    fmt = lambda v: "not available" if v is None else f"{v:.4f} ms"
    print(f"[3 parity] {kind} device time (CUDA graph), B {B}, cum_len {cum}, window {window}, "
          f"bf16, rings L2-cold (rotated over {S}): kernel {device_ms:.4f} ms (L2-warm, one "
          f"ring: {warm_ms:.4f}), library with the write: masked {fmt(lib_ms['masked'])}"
          + (f", unmasked {fmt(lib_ms['unmasked'])}, unmasked flash with enable_gqa "
             f"{fmt(lib_ms['gqa'])}" if full else "")
          + f"; bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), device roofline share "
          f"{100 * bnd['bound_ms'] / device_ms:.1f}%"
          + ("; cold ms by plan (SMs a block x least tiles: splits x tiles a split) "
             + ", ".join(f"{k} {v:.4f}" for k, v in by_plan.items()) if by_plan else "")
          + f" on '{card_line()}'", flush=True)
    del reps, rings
    return dict(device_ms=device_ms, device_warm_ms=warm_ms,
                library_device_ms=lib_ms["masked"],
                library_unmasked_device_ms=lib_ms.get("unmasked"),
                library_gqa_device_ms=lib_ms.get("gqa"), **bnd)


def _b_timings(dev, gen) -> dict:
    """Kernel B at the 3B DeltaNet layer (bf16 q, k, v; g, beta fp32), per
    batch size: the device kernels one call of the wrapper runs (from the
    profiler) and the device time of a call in a CUDA graph with the state
    cold in L2, as in a decode step (the rings and the weights pass between
    two reads of one layer's slab): the calls rotate over the layers of two
    stacks (113 MB at B 1). Only what it measures; no check."""
    from infinitevl_tpu_torch.ops.delta_kernels import delta_step_fused_stacked

    c = B_CASE
    L, H, K, V = c["L"], c["H"], c["K"], c["V"]
    out = {}
    for B in c["Bs"]:
        rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
        stacks = (rnd(L, B, H, K, V) * 0.1, rnd(L, B, H, K, V) * 0.1)
        q, k, v = (rnd(B, H, d).to(torch.bfloat16) for d in (K, K, V))
        g = -torch.rand((B, H), generator=gen, device=dev) * 0.5
        beta = torch.sigmoid(rnd(B, H))
        _, n_k, _, rows = _device_profile(
            lambda: delta_step_fused_stacked(q, k, v, g, beta, stacks[0], c["timed"][1]))
        turn = [0]

        def cold():
            turn[0] += 1
            i = turn[0] % (2 * L)
            return delta_step_fused_stacked(q, k, v, g, beta, stacks[i % 2], i // 2)

        out[B] = dict(kernels=n_k, rows=rows, device_ms=time_graph_ms(cold))
        del stacks
    return out


def _b_cases(dev, gen):
    from infinitevl_tpu_torch.ops.delta_kernels import delta_step_fused_stacked
    from infinitevl_tpu_torch.ops.delta_rule import delta_rule_step

    c = B_CASE
    L, H, K, V = c["L"], c["H"], c["K"], c["V"]
    errs, mxs = {}, []
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        errs[dtype] = []
        for B in c["Bs"]:
            rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
            stack = rnd(L, B, H, K, V) * 0.1
            for layer in c["layers"]:
                # q, k, v in the layer's dtype, g and beta fp32, as the model calls it
                q, k, v = rnd(B, H, K).to(dtype), rnd(B, H, K).to(dtype), rnd(B, H, V).to(dtype)
                g = -torch.rand((B, H), generator=gen, device=dev) * 0.5
                beta = torch.sigmoid(rnd(B, H))
                krn = stack.clone()
                o = delta_step_fused_stacked(q, k, v, g, beta, krn, layer)
                o_ref, h_ref = delta_rule_step(q, k, v, g, beta, stack[layer])
                torch.cuda.synchronize()
                require(o.dtype == dtype, f"B {dtype}: o in {o.dtype}")
                e = max(err_ratio(o, o_ref), err_ratio(krn[layer], h_ref))
                require(e <= tol, f"B {dtype} B={B} layer={layer} err_ratio {e:.3g}")
                others = [i for i in range(L) if i != layer]
                require(torch.equal(krn[others], stack[others]),
                        f"B {dtype} B={B} layer={layer}: other layers of the state changed")
                errs[dtype].append(e)
                if dtype == torch.bfloat16:
                    mxs.append(max(max_abs(o, o_ref), max_abs(krn[layer], h_ref)))
                if dtype == torch.bfloat16 and (B, layer) == c["timed"]:
                    ms = time_ms(lambda: delta_step_fused_stacked(q, k, v, g, beta, krn, layer))

                    def plain_fn():
                        _, h = delta_rule_step(q, k, v, g, beta, stack[layer])
                        stack[layer].copy_(h)

                    plain = time_ms(plain_fn)
    timed = _b_timings(dev, gen)
    # the slab read and written once, q, k, v and o in bf16, g and beta fp32;
    # two reductions, decay, rank-1 update
    bnds = {B: bound(4 * 2 * B * H * K * V + 2 * (2 * B * H * K + 2 * B * H * V) + 4 * 2 * B * H,
                     7 * B * H * K * V, PEAK_F32_FLOPS) for B in c["Bs"]}
    B1, B4 = c["Bs"]
    print(f"[3 parity] B delta_step_fused_stacked: max err_ratio fp32 "
          f"{max(errs[torch.float32]):.3g} (tol {F32_TOL}), bf16 {max(errs[torch.bfloat16]):.3g} "
          f"(tol {BF16_TOL}), B {c['Bs']} x layers {c['layers']}, other layers bit-equal; device "
          f"kernels in one call (bf16): " + ", ".join(
              f"B {B} {r['kernels']} ({'; '.join(f'{nm[:40]} {t * 1e3:.2f} us' for t, _, nm in r['rows'])})"
              for B, r in timed.items())
          + f"; (B, layer)={c['timed']}: kernel {ms:.3f} ms around the wrapper, device in a "
          f"CUDA graph with the state L2-cold B {B1} {timed[B1]['device_ms']:.4f} ms, B {B4} "
          f"{timed[B4]['device_ms']:.4f} ms, plain {plain:.3f} ms, bound B {B1} "
          f"{bnds[B1]['bound_ms']:.4f} ms / B {B4} {bnds[B4]['bound_ms']:.4f} ms "
          f"({bnds[B1]['bound_by']})", flush=True)
    for B, r in timed.items():
        require(r["kernels"] == 1,
                f"B: one call of the wrapper ran {r['kernels']} device kernels at B {B}")
    return dict(max_abs_err=max(mxs), ms=ms, device_ms=timed[B1]["device_ms"],
                device_ms_b4=timed[B4]["device_ms"], plain_ms=plain, library_ms=None,
                kernels_per_call=timed[B1]["kernels"], bound_ms_b4=bnds[B4]["bound_ms"],
                **bnds[B1])


def _c_bound(B, T, H, K, V, elt, peak=PEAK_F32_FLOPS) -> dict:
    """Kernel C's bound: q, k, v read and o written once in the model's
    dtype, g and beta in fp32, the state read and written once; per chunk
    of 64 and head the strictly lower half of k k^T (C (C-1) K), the lower
    half of q k^T (C (C+1) K), the inverse applied to the right-hand sides
    (C (C-1) (K + V)), w S and q S (2 C K V each), the lower half of the
    masked product (C (C+1) V) and the state update (2 C K V), at `peak`:
    the fp32 FMA rate (the fp32 body) or the bf16 tensor cores' (the bf16
    body)."""
    C = 64
    n_chunks = -(-T // C)
    per_chunk = (C * (C - 1) * K + C * (C + 1) * K + C * (C - 1) * (K + V)
                 + 6 * C * K * V + C * (C + 1) * V)
    n_bytes = elt * (2 * B * T * H * K + 2 * B * T * H * V) + 4 * (2 * B * T * H + 2 * B * H * K * V)
    return bound(n_bytes, B * H * n_chunks * per_chunk, peak)


def _c_inputs(dev, gen, B, T, dtype, packed=False):
    """q, k, v in `dtype`, g, beta, an initial state and (packed) segment
    ids at the DeltaNet layer's shape."""
    c = C_CASE
    H, K, V = c["H"], c["K"], c["V"]
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    q, k, v = rnd(B, T, H, K).to(dtype), rnd(B, T, H, K).to(dtype), rnd(B, T, H, V).to(dtype)
    g = -torch.rand((B, T, H), generator=gen, device=dev) * 0.2
    beta = torch.sigmoid(rnd(B, T, H))
    h0 = rnd(B, H, K, V) * 0.1
    return q, k, v, g, beta, h0, (_c_segments(B, T, dev) if packed else None)


def _c_timings(dev, gen) -> dict:
    """Kernel C's device times in a CUDA graph (bf16 with a state unless
    said): B 1 at T 257 (one frame) and T 2,048 (a prefill chunk), B 2 at T
    2,048 unpacked and packed (_c_segments), the fp32 body at B 1, T 2,048;
    the time of each pass from the profiler at T 257 and 2,048; and, where
    the wrapper has a V-tile plan, the scan under each tile. Only what it
    measures; no check."""
    from infinitevl_tpu_torch.ops import delta_kernels as dk

    shapes = dict(t257=(1, 257, torch.bfloat16, False), t2048=(1, 2048, torch.bfloat16, False),
                  b2_t2048=(2, 2048, torch.bfloat16, False),
                  b2_t2048_packed=(2, 2048, torch.bfloat16, True),
                  f32_t2048=(1, 2048, torch.float32, False))
    out, passes, sweep = {}, {}, {}
    for name, (B, T, dtype, packed) in shapes.items():
        q, k, v, g, beta, h0, seg = _c_inputs(dev, gen, B, T, dtype, packed)
        call = lambda: dk.delta_rule_chunk_fused(q, k, v, g, beta, h0, segment_ids=seg)
        out[name] = time_graph_ms(call)
        if name in ("t257", "t2048"):
            _, _, _, rows = _device_profile(call)
            passes[name] = [(nm, t) for t, _, nm in rows if "delta_chunk" in nm.lower()]
        if name in ("t257", "t2048", "b2_t2048"):
            if hasattr(dk, "SCAN_V_TILES"):
                kept = dk.SCAN_V_TILES
                for bv in kept:
                    dk.SCAN_V_TILES = (bv,)
                    sweep[f"{name}_bv{bv}"] = time_graph_ms(call)
                dk.SCAN_V_TILES = kept
    return dict(device_ms=out, passes=passes, sweep=sweep)


def _c_cases(dev, gen):
    from infinitevl_tpu_torch.ops.delta_kernels import delta_chunk_passes, delta_rule_chunk_fused
    from infinitevl_tpu_torch.ops.delta_rule import delta_rule_chunk

    c = C_CASE
    H, K, V = c["H"], c["K"], c["V"]
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    errs, mxs, timed = {}, [], {}
    errs_b16, errs_twin = [], []
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
                    o3, h3 = delta_rule_chunk_fused(q, k, v, g, beta, h0)
                    require(torch.equal(o3, o) and torch.equal(h3, hT),
                            f"C {dtype} B={B} T={T}: two calls differ")
                    errs[dtype].append(e)
                    if dtype == torch.bfloat16:
                        mxs.append(max(max_abs(o, o_ref), max_abs(hT, h_ref)))
                        # the JAX model path's bf16 precision (the plain chunk form
                        # on bf16 inputs), and the twin of the kernel's passes
                        for ref_fn, acc in ((delta_rule_chunk, errs_b16),
                                            (delta_chunk_passes, errs_twin)):
                            ro, rh = ref_fn(q, k, v, g, beta, h0)
                            e = max(err_ratio(o, ro), err_ratio(hT, rh))
                            require(e <= BF16_TOL, f"C bf16 B={B} T={T} init={init} against "
                                    f"{ref_fn.__name__}: err_ratio {e:.3g}")
                            acc.append(e)
                    if dtype == torch.bfloat16 and B == 1 and init and T in c["timed"]:
                        timed[T] = dict(
                            ms=time_ms(lambda: delta_rule_chunk_fused(q, k, v, g, beta, h0)),
                            plain_ms=time_ms(lambda: delta_rule_chunk(
                                q, k, v, g, beta, h0, compute_dtype=torch.float32)),
                            bound_fp32=_c_bound(1, T, H, K, V, 2),
                            **_c_bound(1, T, H, K, V, 2, PEAK_BF16_FLOPS))
    # drift over a long prefill: 256 chunks from an initial state, bf16 against fp32
    T = 16384
    q, k, v, g, beta, h0, _ = _c_inputs(dev, gen, 1, T, torch.bfloat16)
    o, hT = delta_rule_chunk_fused(q, k, v, g, beta, h0)
    o_ref, h_ref = delta_rule_chunk(q, k, v, g, beta, h0, compute_dtype=torch.float32)
    drift = (err_ratio(o, o_ref), err_ratio(hT, h_ref))
    require(max(drift) <= BF16_TOL, f"C bf16 at T {T}: err_ratio o {drift[0]:.3g}, state "
            f"{drift[1]:.3g}")
    del q, k, v, g, beta, h0, o, hT, o_ref, h_ref
    torch.cuda.empty_cache()
    line = "; ".join(
        f"(B 1, T {T}, bf16, with state): kernel {r['ms']:.3f} ms, plain "
        f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}; bf16 "
        f"tensor cores), {r['bound_fp32']['bound_ms']:.4f} ms ({r['bound_fp32']['bound_by']}; "
        f"fp32 FMA)" for T, r in timed.items())
    print(f"[3 parity] C delta_rule_chunk_fused: max err_ratio bf16 "
          f"{max(errs[torch.bfloat16]):.3g} against the fp32 plain version, "
          f"{max(errs_b16):.3g} against the bf16 one (delta_rule_chunk, the JAX model path's "
          f"precision), {max(errs_twin):.3g} against the twin of the passes (tol {BF16_TOL}); "
          f"fp32 {max(errs[torch.float32]):.3g} (tol {C_F32_TOL}), o and final state, "
          f"B {c['Bs']} x T {c['Ts']} x with/without state, the state written in "
          f"place bit-equal, two calls bit-equal; B 1, T {T} from a state, bf16 against "
          f"fp32: o {drift[0]:.3g}, state {drift[1]:.3g} (tol {BF16_TOL}); {line}", flush=True)
    seg_res = _c_segment_cases(dev, gen)
    tm = _c_timings(dev, gen)
    dm = tm["device_ms"]
    print("[3 parity] C timed, device ms in a CUDA graph (bf16, with state): "
          + ", ".join(f"{k} {v_:.4f}" for k, v_ in dm.items())
          + f"; packed / unpacked at B 2: {dm['b2_t2048_packed'] / dm['b2_t2048']:.3f}; "
          + "passes by the profiler (ms): " + "; ".join(
              f"{k}: " + ", ".join(f"{nm[:48]} {t:.4f}" for nm, t in rows)
              for k, rows in tm["passes"].items())
          + "; the scan's V-tile sweep (device ms): "
          + (", ".join(f"{k} {v_:.4f}" for k, v_ in tm["sweep"].items()) or "no plan"),
          flush=True)
    frame, chunk = timed[c["timed"][0]], timed[c["timed"][1]]
    frame_fp32 = frame.pop("bound_fp32")
    return dict(max_abs_err=max(mxs + [seg_res.pop("max_abs_err")]), library_ms=None, **frame,
                bound_ms_fp32_fma=frame_fp32["bound_ms"], device_ms=dm["t257"],
                ms_t2048=chunk["ms"], plain_ms_t2048=chunk["plain_ms"],
                bound_ms_t2048=chunk["bound_ms"],
                bound_ms_t2048_fp32_fma=chunk["bound_fp32"]["bound_ms"],
                device_ms_t2048=dm["t2048"], device_ms_b2_t2048=dm["b2_t2048"],
                device_ms_b2_t2048_packed=dm["b2_t2048_packed"],
                device_ms_f32_t2048=dm["f32_t2048"], scan_v_tile_sweep=tm["sweep"],
                drift_t16384=max(drift), **seg_res)


def _c_segments(B: int, T: int, dev) -> torch.Tensor:
    """Packed rows for kernel C: row 0 has boundaries inside chunks (100,
    1500), one exactly at a chunk edge (640) and three inside one chunk (710,
    720, 740); row 1 a boundary at an edge (1024) and right after it (1030);
    both end in a tail of pads (id 0) whose start is no chunk edge."""
    seg = torch.ones((B, T), dtype=torch.int32, device=dev)
    for r, cuts in enumerate(((100, 640, 710, 720, 740, 1500), (1024, 1030, 1700))[:B]):
        for i, t in enumerate(cuts):
            if t < T:
                seg[r, t:] = i + 2
    seg[:, T - T // 40:] = 0
    return seg


def _c_segment_cases(dev, gen) -> dict:
    """Kernel C's packed path against the plain chunk form with the same
    segment ids (fp32 arithmetic), at B 2 and the DeltaNet layer's shape:
    T 2048 and a ragged T 2000, with and without an initial state; then
    gated_delta_rule with segment ids on the card launches C."""
    from infinitevl_tpu_torch.ops.delta_kernels import delta_rule_chunk_fused
    from infinitevl_tpu_torch.ops.delta_rule import delta_rule_chunk, gated_delta_rule

    c = C_CASE
    H, K, V = c["H"], c["K"], c["V"]
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    errs, mxs = {torch.bfloat16: [], torch.float32: []}, []
    B = 2
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, C_F32_TOL)):
        for T in (2048, 2000):
            seg = _c_segments(B, T, dev)
            for init in (False, True):
                q, k, v = rnd(B, T, H, K).to(dtype), rnd(B, T, H, K).to(dtype), \
                    rnd(B, T, H, V).to(dtype)
                g = -torch.rand((B, T, H), generator=gen, device=dev) * 0.2
                beta = torch.sigmoid(rnd(B, T, H))
                h0 = rnd(B, H, K, V) * 0.1 if init else None
                o, hT = delta_rule_chunk_fused(q, k, v, g, beta, h0, segment_ids=seg)
                o_ref, h_ref = delta_rule_chunk(q, k, v, g, beta, h0, segment_ids=seg,
                                                compute_dtype=torch.float32)
                torch.cuda.synchronize()
                e = max(err_ratio(o, o_ref), err_ratio(hT, h_ref))
                require(e <= tol, f"C packed {dtype} T={T} init={init} err_ratio {e:.3g}")
                errs[dtype].append(e)
                if dtype == torch.bfloat16:
                    mxs.append(max(max_abs(o, o_ref), max_abs(hT, h_ref)))
    # the dispatch: segment ids on a CUDA tensor go to kernel C
    n0 = delta_rule_chunk_fused.launches
    gated_delta_rule(q, k, v, g, beta, segment_ids=seg)
    require(delta_rule_chunk_fused.launches == n0 + 1, "gated_delta_rule did not launch C")
    T = 2048
    seg = _c_segments(1, T, dev)
    q, k, v = (rnd(1, T, H, d).to(torch.bfloat16) for d in (K, K, V))
    g = -torch.rand((1, T, H), generator=gen, device=dev) * 0.2
    beta = torch.sigmoid(rnd(1, T, H))
    h0 = rnd(1, H, K, V) * 0.1
    ms = time_ms(lambda: delta_rule_chunk_fused(q, k, v, g, beta, h0, segment_ids=seg))
    plain = time_ms(lambda: delta_rule_chunk(q, k, v, g, beta, h0, segment_ids=seg,
                                             compute_dtype=torch.float32))
    bnd = _c_bound(1, T, H, K, V, 2, PEAK_BF16_FLOPS)
    print(f"[3 parity] C packed rows (segment ids: boundaries inside chunks, at a chunk edge, "
          f"three in one chunk, a pad tail): max err_ratio bf16 "
          f"{max(errs[torch.bfloat16]):.3g} (tol {BF16_TOL}), fp32 "
          f"{max(errs[torch.float32]):.3g} (tol {C_F32_TOL}), B 2 x T (2048, 2000) x "
          f"with/without state; gated_delta_rule with ids launches C; timed (B 1, T {T}, bf16, "
          f"with state, 4 sequences): kernel {ms:.3f} ms, plain {plain:.3f} ms, bound "
          f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})", flush=True)
    return dict(max_abs_err=max(mxs), ms_t2048_packed=ms, plain_ms_t2048_packed=plain)


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
    print(f"[3 parity] E segment_flash_attention: max err_ratio bf16 "
          f"{max(errs[torch.bfloat16]):.3g} (tol {BF16_TOL}), fp32 "
          f"{max(errs[torch.float32]):.3g} (tol {F32_TOL}), S {c['Ss']}, 3 segments + "
          f"pads", flush=True)
    # timed at the main paths' cases: one 1344x1344 image and one 448x448
    # frame are a single segment; q and k are dense after the rotation, v is
    # a slice of the projection
    timed = {}
    for S in c["timed"]:
        q, k = (torch.randn((S, H, D), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        v = torch.randn((S, 3, H, D), generator=gen, device=dev).to(torch.bfloat16)[:, 2]
        seg = torch.zeros(S, dtype=torch.int32, device=dev)
        ms = time_ms(lambda: segment_flash_attention(q, k, v, seg))
        dev_ms = time_graph_ms(lambda: segment_flash_attention(q, k, v, seg))
        plain = time_ms(lambda: attention_segment_chunked(q, k, v, seg), reps=5)
        mask = seg[:, None] == seg[None, :]
        ref = attention_segment_chunked(q, k, v, seg)
        for m in (mask, None):  # one segment: the unmasked call is the same function
            e_lib = err_ratio(sdpa(q[None], k[None], v[None], m)[0], ref)
            require(e_lib <= BF16_TOL, f"E library call (mask {m is not None}) err_ratio "
                    f"{e_lib:.3g}")
        lib = time_ms(lambda: sdpa(q[None], k[None], v[None], mask))
        lib_flash = time_ms(lambda: sdpa(q[None], k[None], v[None], None))
        pairs = int((torch.bincount(seg - seg.min()).double() ** 2).sum())  # visible pairs
        bnd = bound(2 * 4 * S * H * D + 4 * S, 4 * H * D * pairs, PEAK_BF16_FLOPS)
        timed[S] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain, library_ms=lib,
                        library_unmasked_ms=lib_flash, **bnd)
        print(f"[3 parity] E timed S {S}, one segment, bf16: kernel {ms:.3f} ms (device "
              f"{dev_ms:.4f} ms), plain {plain:.3f} ms, library: SDPA with the mask "
              f"{lib:.3f} ms, unmasked {lib_flash:.3f} ms, bound {bnd['bound_ms']:.4f} ms "
              f"({bnd['bound_by']}); {_walk_line(seg, 0, H)}", flush=True)
    main = c["timed"][0]
    return dict(max_abs_err=max(mxs), **timed[main],
                other_shapes={f"S{S}": r for S, r in timed.items() if S != main})


def _walk_line(seg: torch.Tensor, win_len: int, H: int) -> str:
    """The consumer warpgroups a block that the wrapper chooses for this
    shape on this card (ops/vit_kernels.vit_warpgroups, passed to the
    kernel), and the key tiles of one head's blocks by kind as the walk's
    plain twin predicts them (ops/vit_kernels.vit_tile_walk): whole (no
    per-element mask), skip (never loaded), mask."""
    from infinitevl_tpu_torch.ops.vit_kernels import (
        TILE, sm_count, vit_tile_walk, vit_warpgroups)

    cwg = vit_warpgroups(seg.numel(), H, win_len, sm_count(seg.device.index))
    counts = dict(whole=0, skip=0, mask=0)
    for tiles in vit_tile_walk(seg, win_len, cwg * TILE):
        for _, kind in tiles:
            counts[kind] += 1
    return (f"launched with {cwg} consumer warpgroup(s) a block; key tiles a head whole / "
            f"skipped / masked as the walk's twin predicts them {counts['whole']} / "
            f"{counts['skip']} / {counts['mask']}")


def _g_cases(dev, gen):
    from infinitevl_tpu_torch.models.quant import dequantize_kernel_int4, quantize_kernel_int4
    from infinitevl_tpu_torch.ops.int4_kernels import (
        int4_matmul_fused,
        int4_matmul_plain,
        launch_plan,
    )

    from infinitevl_tpu_torch.ops.int4_kernels import tile_kernel

    c = G_CASE
    errs, mxs, timed = {torch.bfloat16: [], torch.float32: []}, [], {}
    routes, group_timed = set(), {}
    for d_in, d_out, gs in c["shapes"] + c["group_shapes"]:
        w = torch.randn((d_in, d_out), generator=gen, device=dev) * 0.02
        node = quantize_kernel_int4(w, gs)
        G = node["scale4"].shape[0]
        grouped = (d_in, d_out, gs) in c["group_shapes"]
        if grouped:
            require(G == d_in // gs, f"G: group {gs} at d_in {d_in} gave {G} groups")
            routes.add((gs, tile_kernel(d_in // 2, G, torch.bfloat16)))
        Ms = (c["group_Ms"] if grouped else
              c["Ms"] + ((c["big_M"],) if (d_in, d_out) == c["shapes"][0][:2] else ()))
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
            for M in Ms:
                x = torch.randn((M, d_in), generator=gen, device=dev).to(dtype)
                if M in (3, 65):  # a strided view: rows of a wider projection, 2 leading dims
                    wide = torch.randn((M, d_in + 64), generator=gen, device=dev).to(dtype)
                    x = wide[:, 32:32 + d_in].reshape(1, M, d_in)
                    require(not x.is_contiguous(), "G: the strided case is contiguous")
                out = int4_matmul_fused(x, node)
                ref = int4_matmul_plain(x, node)
                torch.cuda.synchronize()
                e = err_ratio(out, ref)
                require(out.shape == ref.shape and out.dtype == dtype, "G output shape/dtype")
                require(e <= tol, f"G {dtype} {d_in}x{d_out} G={G} M={M} err_ratio {e:.3g}")
                errs[dtype].append(e)
                if dtype == torch.bfloat16:
                    mxs.append(max_abs(out, ref))
        if grouped and gs in (32, 64) and d_out != 3420:
            M = c["group_timed"]
            x = torch.randn((M, d_in), generator=gen, device=dev).to(torch.bfloat16)
            wdq = dequantize_kernel_int4(node, torch.bfloat16)
            group_timed[f"{d_in}x{d_out}_g{gs}_m{M}"] = dict(
                device_ms=time_graph_ms(lambda: int4_matmul_fused(x, node)),
                library_device_ms=time_graph_ms(lambda: x @ wdq),
                **bound(node["kernel_q4"].numel() + 4 * node["scale4"].numel()
                        + 2 * M * d_in + 2 * M * d_out, 2 * M * d_in * d_out, PEAK_BF16_FLOPS))
            del wdq
            continue
        if grouped:
            continue
        timed_Ms = [M for i, o, M in c["timed"] if (i, o) == (d_in, d_out)]
        if timed_Ms:
            # the caller finds the weights cold (a decode step walks 2 GB of
            # them): rotate over copies that together exceed the 50 MB L2
            n_copies = -(-120_000_000 // node["kernel_q4"].numel())
            nodes = [{k: v.clone() for k, v in node.items()} for _ in range(n_copies)]
            wdq = [dequantize_kernel_int4(n, torch.bfloat16) for n in nodes]
            for M in timed_Ms:
                x = torch.randn((M, d_in), generator=gen, device=dev).to(torch.bfloat16)
                turn = [0]

                def rot(fn, pool):
                    def run():
                        turn[0] += 1
                        return fn(x, pool[turn[0] % n_copies])
                    return run

                e_lib = err_ratio(x @ wdq[0], int4_matmul_plain(x, node))
                require(e_lib <= BF16_TOL, f"G library call err_ratio {e_lib:.3g}")
                n_bytes = (node["kernel_q4"].numel() + 4 * node["scale4"].numel()
                           + 2 * M * d_in + 2 * M * d_out)
                timed[(d_in, d_out, M)] = dict(
                    ms=time_ms(rot(int4_matmul_fused, nodes)),
                    plain_ms=time_ms(rot(int4_matmul_plain, nodes), reps=5),
                    library_ms=time_ms(rot(torch.matmul, wdq)),
                    device_ms=time_graph_ms(rot(int4_matmul_fused, nodes)),
                    library_device_ms=time_graph_ms(rot(torch.matmul, wdq)),
                    plan=launch_plan(M, d_in // 2, d_out, torch.bfloat16),
                    **bound(n_bytes, 2 * M * d_in * d_out, PEAK_BF16_FLOPS))
            del nodes, wdq
    for k, r in timed.items():
        print(f"[3 parity] G timed {k[0]}->{k[1]} M={k[2]} bf16, cold weights, plan (tile_m, "
              f"rows per block, splits) {r['plan']}: kernel {r['ms']:.4f} ms around the wrapper "
              f"and {r['device_ms']:.4f} ms of device time in a CUDA graph, plain "
              f"{r['plain_ms']:.3f} ms, library (bf16 matmul on the dequantised copy) "
              f"{r['library_ms']:.4f} ms and {r['library_device_ms']:.4f} ms in a graph, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), device roofline share "
              f"{100 * r['bound_ms'] / r['device_ms']:.1f}%", flush=True)
    print(f"[3 parity] G int4_matmul_fused: max err_ratio bf16 "
          f"{max(errs[torch.bfloat16]):.3g} (tol {BF16_TOL}), fp32 "
          f"{max(errs[torch.float32]):.3g} (tol {F32_TOL}) over {len(c['shapes'])} shapes "
          f"(grouped, G = 1, ragged 3420 and 12320 columns) x M {c['Ms']} (+{c['big_M']}), "
          f"strided x at M 3 and 65; scale groups {sorted(routes)} (group, bf16 tile kernel) "
          f"on {len(c['group_shapes'])} shapes x M {c['group_Ms']}", flush=True)
    for k, r in group_timed.items():
        print(f"[3 parity] G timed {k} bf16 (warm weights): device {r['device_ms']:.4f} ms in a "
              f"CUDA graph, library {r['library_device_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
    first = c["timed"][0]
    extra = {}
    for (d_in, d_out, M), r in timed.items():
        if (d_in, d_out, M) != first:
            tag = f"{d_in}x{d_out}_m{M}"
            extra.update({f"{key}_{tag}": r[key] for key in (
                "ms", "device_ms", "plain_ms", "library_ms", "library_device_ms", "bound_ms")})
    main = {k: v for k, v in timed[first].items() if k != "plan"}
    return dict(max_abs_err=max(mxs), **main, **extra, groups=group_timed)


def _d_cases(dev, gen):
    from infinitevl_tpu_torch.ops.swa import ring_slot_positions, sliding_window_mask
    from infinitevl_tpu_torch.ops.swa_kernels import (
        swa_ring_decode_plain,
        swa_ring_flash_decode,
    )

    c = A2_CASE  # kernel D is A2 on one unstacked ring: the same shapes
    Hq, Hkv, D, cap = c["Hq"], c["Hkv"], 128, c["cap"]
    errs, mxs = {torch.bfloat16: [], torch.float32: []}, []
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        for B in c["Bs"]:
            mk = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)
            rk, rv = mk(B, Hkv, cap, D), mk(B, Hkv, cap, D)
            for window in c["windows"]:
                for cum in c["cums"]:
                    q, nk, nv = mk(B, 1, Hq, D), mk(B, 1, Hkv, D), mk(B, 1, Hkv, D)
                    k_krn, v_krn, k_ref, v_ref = rk.clone(), rv.clone(), rk.clone(), rv.clone()
                    out = swa_ring_flash_decode(q, nk, nv, k_krn, v_krn, cum, window)
                    ref = swa_ring_decode_plain(q, nk, nv, k_ref, v_ref, cum, window)
                    torch.cuda.synchronize()
                    e = err_ratio(out, ref)
                    what = f"D {dtype} B={B} window={window} cum={cum}"
                    require(e <= tol, f"{what} err_ratio {e:.3g}")
                    require(torch.equal(k_krn, k_ref) and torch.equal(v_krn, v_ref),
                            f"{what}: the ring differs from the plain write")
                    k_two, v_two = rk.clone(), rv.clone()
                    out_two = swa_ring_flash_decode(q, nk, nv, k_two, v_two, cum, window)
                    require(torch.equal(out_two, out) and torch.equal(k_two, k_krn)
                            and torch.equal(v_two, v_krn), f"{what}: two calls differ")
                    errs[dtype].append(e)
                    if dtype == torch.bfloat16:
                        mxs.append(max_abs(out, ref))
                    if (dtype, B, cum, window) == (torch.bfloat16, *c["timed"], cap):
                        ms = time_ms(lambda: swa_ring_flash_decode(q, nk, nv, k_krn, v_krn,
                                                                   cum, cap))
                        plain = time_ms(lambda: swa_ring_decode_plain(q, nk, nv, k_ref, v_ref,
                                                                      cum, cap))
                        G = Hq // Hkv
                        k_pos = ring_slot_positions(cum + 1, cap, dev)
                        mask = sliding_window_mask(torch.tensor([cum], device=dev), k_pos, cap)
                        k_all = k_ref.transpose(1, 2).repeat_interleave(G, 2)
                        v_all = v_ref.transpose(1, 2).repeat_interleave(G, 2)
                        e_lib = err_ratio(sdpa(q, k_all, v_all, mask), ref)
                        require(e_lib <= BF16_TOL, f"D library call err_ratio {e_lib:.3g}")
                        lib = time_ms(lambda: sdpa(q, k_all, v_all, mask))
                        del k_all, v_all
    print(f"[3 parity] D swa_ring_flash_decode (one unstacked ring): max err_ratio bf16 "
          f"{max(errs[torch.bfloat16]):.3g} (tol {BF16_TOL}), fp32 "
          f"{max(errs[torch.float32]):.3g} (tol {F32_TOL}) over B {c['Bs']} x window "
          f"{c['windows']} x cum_len {c['cums']}; ring bit-equal, two calls bit-equal; "
          f"(B, cum_len)={c['timed']}: kernel {ms:.3f} ms around the wrapper, plain "
          f"{plain:.3f} ms, library {lib:.3f} ms", flush=True)
    res = dict(max_abs_err=max(mxs), ms=ms, plain_ms=plain, library_ms=lib)
    for B, cum, window in c["cold"][:2]:
        r = _decode_cold(dev, gen, B, cum, window, stacked=False)
        tag = "" if B == c["cold"][0][0] else f"_b{B}_w{window}"
        res.update({f"{k}{tag}": v for k, v in r.items() if not (tag and k == "bound_by")})
    return res


def _band_pairs(T: int, window: int) -> int:
    """Visible (query, key) pairs of one row of the causal band."""
    w = min(window, T)
    return w * (w + 1) // 2 + (T - w) * w


def _packed_segments(B: int, T: int, dev) -> torch.Tensor:
    """Three packed sequences of unequal length and a tail of pads (id 0)."""
    seg = torch.ones((B, T), dtype=torch.int32, device=dev)
    seg[:, T * 2 // 5: T * 3 // 4] = 2
    seg[:, T * 3 // 4:] = 3
    seg[:, T - max(T // 50, 1):] = 0
    return seg


def _grads(fn, inputs, cot):
    leaves = [x.detach().requires_grad_(True) for x in inputs]
    out = fn(*leaves)
    return out, torch.autograd.grad(out, leaves, cot)


def _h_cases(dev, gen):
    from infinitevl_tpu_torch.ops.swa import sliding_window_mask, swa_prefill_reference
    from infinitevl_tpu_torch.ops import swa_kernels
    from infinitevl_tpu_torch.ops.swa_kernels import swa_train_flash_attention

    c = H_CASE
    target = swa_kernels.BWD_TARGET_BLOCKS
    Hq, Hkv, D = c["Hq"], c["Hkv"], 128
    G = Hq // Hkv
    errs = {"fwd": {}, "bwd": {}}
    mxs = []
    for dtype, tol_f, tol_b in ((torch.bfloat16, BF16_TOL, BF16_TOL),
                                (torch.float32, F32_TOL, H_BWD_F32_TOL)):
        errs["fwd"][dtype], errs["bwd"][dtype] = [], []
        for T, W, Bs in c["cases"]:
            for B in Bs:
                for packed in (False, True):
                    mk = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)
                    q, k, v = mk(B, T, Hq, D), mk(B, T, Hkv, D), mk(B, T, Hkv, D)
                    cot = mk(B, T, Hq, D)
                    seg = _packed_segments(B, T, dev) if packed else None
                    out, gk = _grads(lambda a, b_, c_: swa_train_flash_attention(
                        a, b_, c_, W, None, seg), (q, k, v), cot)
                    ref, gr = _grads(lambda a, b_, c_: swa_prefill_reference(
                        a, b_, c_, W, 0, None, seg), (q, k, v), cot)
                    torch.cuda.synchronize()
                    what = f"H {dtype} B={B} T={T} W={W} packed={packed}"
                    e = err_ratio(out, ref)
                    require(e <= tol_f, f"{what} forward err_ratio {e:.3g}")
                    errs["fwd"][dtype].append(e)
                    for name, a, b_ in zip(("dq", "dk", "dv"), gk, gr):
                        require(bool(torch.isfinite(a).all()), f"{what} {name} not finite")
                        eb = err_ratio(a, b_)
                        require(eb <= tol_b, f"{what} {name} err_ratio {eb:.3g}")
                        errs["bwd"][dtype].append(eb)
                    if dtype == torch.bfloat16:
                        mxs.append(max_abs(out, ref))
                    del out, gk, ref, gr
    # a second backward of the same inputs gives the same bits (no atomics)
    q, k, v, cot = (torch.randn((1, 1000, h, D), generator=gen, device=dev).to(torch.bfloat16)
                    for h in (Hq, Hkv, Hkv, Hq))
    fn = lambda a, b_, c_: swa_train_flash_attention(a, b_, c_, 300)
    g1, g2 = _grads(fn, (q, k, v), cot)[1], _grads(fn, (q, k, v), cot)[1]
    require(all(torch.equal(a, b_) for a, b_ in zip(g1, g2)), "H backward not reproducible")

    timed = {}
    for T, W in c["timed"]:
        B = 1
        mk = lambda *s: torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
        q, k, v, cot = mk(B, T, Hq, D), mk(B, T, Hkv, D), mk(B, T, Hkv, D), mk(B, T, Hq, D)
        ql, kl, vl = (x.detach().requires_grad_(True) for x in (q, k, v))

        def fwd_bwd(fn, leaves):
            torch.autograd.grad(fn(*leaves), leaves, cot)

        kern = lambda a, b_, c_: swa_train_flash_attention(a, b_, c_, W)
        plain = lambda a, b_, c_: swa_prefill_reference(a, b_, c_, W)
        pos = torch.arange(T, device=dev)
        mask = sliding_window_mask(pos, pos, W)
        kr, vr = (x.repeat_interleave(G, 2).detach().requires_grad_(True) for x in (k, v))
        lib = lambda a, b_, c_: sdpa(a, b_, c_, mask)
        e_lib = err_ratio(lib(q, kr, vr), plain(q, k, v))
        require(e_lib <= BF16_TOL, f"H library call err_ratio {e_lib:.3g}")
        with torch.no_grad():
            f_ms = time_ms(lambda: kern(q, k, v))
            f_plain = time_ms(lambda: plain(q, k, v), reps=5)
            f_lib = time_ms(lambda: lib(q, kr, vr))
        fb_ms = time_ms(lambda: fwd_bwd(kern, (ql, kl, vl)))
        fb_plain = time_ms(lambda: fwd_bwd(plain, (ql, kl, vl)), reps=5)
        fb_lib = time_ms(lambda: fwd_bwd(lib, (ql, kr, vr)))
        # the backward's kernels apart: device time by kernel name
        _, _, _, rows = _device_profile(lambda: fwd_bwd(kern, (ql, kl, vl)))
        parts = {key: sum(ms for ms, _, name in rows if pat in name)
                 for key, pat in (("dq", "dq_wgmma"), ("dkv", "dkv_wgmma"),
                                  ("reduce", "train_reduce"), ("delta", "train_delta"),
                                  ("fwd", "fwd_wgmma"))}

        # the GQA split of dK/dV, measured: each split of the 8 query heads
        splits = {}
        for n_split in (1, 2, 4, 8):
            base = -(-T // swa_kernels.BWD_TILE) * Hkv * B
            swa_kernels.BWD_TARGET_BLOCKS = base * n_split
            splits[n_split] = time_ms(lambda: fwd_bwd(kern, (ql, kl, vl))) - f_ms
        swa_kernels.BWD_TARGET_BLOCKS = target
        plan = swa_kernels.bwd_split_plan(B, T, Hq, Hkv)
        pairs = B * Hq * _band_pairs(T, W)
        qo, kv = 2 * B * T * Hq * D, 2 * B * T * Hkv * D  # bytes of one q-shaped / kv-shaped
        lse = 4 * B * Hq * T
        b_f = bound(2 * qo + 2 * kv + lse, 4 * D * pairs, PEAK_BF16_FLOPS)
        # backward: reads q, k, v, out, d_out, lse; writes dq, dk, dv; five products
        b_b = bound(4 * qo + 4 * kv + lse, 10 * D * pairs, PEAK_BF16_FLOPS)
        timed[(T, W)] = dict(ms=f_ms, plain_ms=f_plain, library_ms=f_lib, **b_f,
                             fwd_device_ms=parts["fwd"],
                             bwd_ms=fb_ms - f_ms, fwd_bwd_ms=fb_ms,
                             plain_fwd_bwd_ms=fb_plain, library_fwd_bwd_ms=fb_lib,
                             bwd_bound_ms=b_b["bound_ms"], bwd_bound_by=b_b["bound_by"],
                             library_bwd_ms=fb_lib - f_lib, dq_device_ms=parts["dq"],
                             bwd_device_ms=sum(parts[k] for k in ("delta", "dq", "dkv", "reduce")),
                             dkv_device_ms=parts["dkv"], reduce_device_ms=parts["reduce"],
                             split=plan.split, scratch_bytes=plan.scratch_bytes,
                             bwd_ms_by_split={str(k): v for k, v in splits.items()})
        print(f"[3 parity] H timed B 1, T {T}, W {W}, bf16: forward kernel {f_ms:.3f} ms, "
              f"plain {f_plain:.3f}, library {f_lib:.3f}, bound {b_f['bound_ms']:.4f} "
              f"({b_f['bound_by']}); forward+backward kernel {fb_ms:.3f} ms (backward "
              f"{fb_ms - f_ms:.3f}), plain {fb_plain:.3f}, library {fb_lib:.3f} (backward "
              f"{fb_lib - f_lib:.3f}), backward bound {b_b['bound_ms']:.4f} ({b_b['bound_by']}); "
              f"device ms per forward+backward (torch.profiler): dQ {parts['dq']:.3f}, dK/dV "
              f"{parts['dkv']:.3f}, reduce {parts['reduce']:.3f}, delta {parts['delta']:.3f} "
              f"(backward {timed[(T, W)]['bwd_device_ms']:.3f}; the wall time above holds the "
              f"host's autograd and launches), forward {parts['fwd']:.3f}; split of the GQA sum {plan.split} (scratch "
              f"{plan.scratch_bytes / 1e6:.1f} MB); backward ms by split "
              + ", ".join(f"{k}: {v:.3f}" for k, v in splits.items()), flush=True)
        del q, k, v, cot, ql, kl, vl, kr, vr, mask
    print(f"[3 parity] H swa_train_flash_attention: max err_ratio forward bf16 "
          f"{max(errs['fwd'][torch.bfloat16]):.3g} (tol {BF16_TOL}), fp32 "
          f"{max(errs['fwd'][torch.float32]):.3g} (tol {F32_TOL}); backward (dq, dk, dv) "
          f"bf16 {max(errs['bwd'][torch.bfloat16]):.3g} (tol {BF16_TOL}), fp32 "
          f"{max(errs['bwd'][torch.float32]):.3g} (tol {H_BWD_F32_TOL}); (T, W, Bs) "
          f"{c['cases']}, each with and without packed segments; backward bit-reproducible",
          flush=True)
    main_case = timed[c["timed"][0]]
    other = {f"T{T}_W{W}": r for (T, W), r in timed.items()}
    other["T16384_W8192_chunk_ids"] = _h_chunk_cases(dev, gen)
    return dict(max_abs_err=max(mxs), **main_case, other_shapes=other)


def _h_chunk_ids(kind: str, dev) -> torch.Tensor:
    """[1, 2W] ids of one chunked-SWA call: `first` chunk -1 x W (the zero
    history), then the row's segments 1 and 2, then -2 pads; a `later` chunk
    the previous chunk's segments 1 and 2, then the row's 2 (continued) and
    3, then -2 pads."""
    c = H_CHUNK_CASE
    W, cut, pad = c["W"], c["cut"], c["pad"]
    first = kind == "first"
    prev = [-1] * W if first else [1] * (W // 2) + [2] * (W - W // 2)
    a, b = (1, 2) if first else (2, 3)
    row = [a] * cut + [b] * (W - cut - pad) + [-2] * pad
    return torch.tensor([prev + row], dtype=torch.int32, device=dev)


def _swa_blocked_plain(q, k, v, window, seg, block):
    """H's plain version (ops/swa.attention_dense under the band and segment
    mask) in query blocks of `block` rows, each a checkpoint, so that only
    one block's [block, T] scores exist at a time (the whole [T, T] at T
    16,384 would not fit next to its gradient)."""
    from torch.utils.checkpoint import checkpoint

    from infinitevl_tpu_torch.ops.swa import attention_dense, sliding_window_mask

    T = q.shape[1]
    pos = torch.arange(T, device=q.device)

    def one(qb, kk, vv, t0):
        mask = (sliding_window_mask(pos[t0:t0 + block], pos, window)[None]
                & (seg[:, t0:t0 + block, None] == seg[:, None, :]))
        return attention_dense(qb, kk, vv, mask)

    return torch.cat([checkpoint(one, q[:, t0:t0 + block], k, v, t0, use_reentrant=False)
                      for t0 in range(0, T, block)], dim=1)


def _h_chunk_cases(dev, gen) -> dict:
    """H forward and backward against its plain version on the chunked SWA
    layer's calls (H_CHUNK_CASE), then timed: kernel, plain, SDPA with the
    explicit mask, and the bound over the pairs these ids leave visible."""
    from infinitevl_tpu_torch.ops.swa_kernels import swa_train_flash_attention

    c = H_CHUNK_CASE
    W, Hq, Hkv, D = c["W"], H_CASE["Hq"], H_CASE["Hkv"], 128
    T = 2 * W
    mk = lambda *s: torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)  # noqa: E731
    errs = []
    for kind in ("first", "later"):
        seg = _h_chunk_ids(kind, dev)
        q, k, v, cot = mk(1, T, Hq, D), mk(1, T, Hkv, D), mk(1, T, Hkv, D), mk(1, T, Hq, D)
        out, gk = _grads(lambda a, b_, c_: swa_train_flash_attention(a, b_, c_, W, None, seg),
                         (q, k, v), cot)
        ref, gr = _grads(lambda a, b_, c_: _swa_blocked_plain(a, b_, c_, W, seg, c["block"]),
                         (q, k, v), cot)
        what = f"H on the chunked layer's ids ({kind} chunk), T {T}, W {W}"
        e = [err_ratio(out, ref)] + [err_ratio(a, b_) for a, b_ in zip(gk, gr)]
        require(all(bool(torch.isfinite(a).all()) for a in (out, *gk)), f"{what}: not finite")
        require(max(e) <= BF16_TOL, f"{what}: err_ratio out / dq / dk / dv {e}")
        errs.append(e)
        mx = max_abs(out, ref)
        del out, gk, ref, gr
    seg = _h_chunk_ids("first", dev)
    q, k, v, cot = mk(1, T, Hq, D), mk(1, T, Hkv, D), mk(1, T, Hkv, D), mk(1, T, Hq, D)
    ql, kl, vl = (x.detach().requires_grad_(True) for x in (q, k, v))
    kern = lambda a, b_, c_: swa_train_flash_attention(a, b_, c_, W, None, seg)  # noqa: E731
    pos = torch.arange(T, device=dev)
    from infinitevl_tpu_torch.ops.swa import sliding_window_mask

    mask = sliding_window_mask(pos, pos, W) & (seg[0, :, None] == seg[0, None, :])
    G = Hq // Hkv
    kr, vr = (x.repeat_interleave(G, 2).detach().requires_grad_(True) for x in (k, v))
    lib = lambda a, b_, c_: sdpa(a, b_, c_, mask)  # noqa: E731
    e_lib = err_ratio(lib(q, kr, vr), kern(q, k, v))
    require(e_lib <= BF16_TOL, f"H chunk ids: library call err_ratio {e_lib:.3g}")

    def fwd_bwd(fn, leaves):
        torch.autograd.grad(fn(*leaves), leaves, cot)

    with torch.no_grad():
        f_ms = time_ms(lambda: kern(q, k, v))
        f_plain = time_ms(lambda: _swa_blocked_plain(q, k, v, W, seg, c["block"]), reps=3)
        f_lib = time_ms(lambda: lib(q, kr, vr))
    fb_ms = time_ms(lambda: fwd_bwd(kern, (ql, kl, vl)))
    fb_lib = time_ms(lambda: fwd_bwd(lib, (ql, kr, vr)), reps=5)
    # the pairs these ids leave visible: the band within each run of one id
    runs = torch.unique_consecutive(seg[0], return_counts=True)[1].tolist()
    pairs = Hq * sum(_band_pairs(n, W) for n in runs)
    qo, kv = 2 * T * Hq * D, 2 * T * Hkv * D
    b_f = bound(2 * qo + 2 * kv + 4 * T + 4 * Hq * T, 4 * D * pairs, PEAK_BF16_FLOPS)
    b_b = bound(4 * qo + 4 * kv + 4 * T + 4 * Hq * T, 10 * D * pairs, PEAK_BF16_FLOPS)
    print(f"[3 parity] H on the chunked SWA layer's calls, B 1, T {T} (2 windows of {W}), bf16, "
          f"ids -1 / row / -2 (first chunk) and prev / row / -2 (later chunk): err_ratio out, "
          f"dq, dk, dv {[[round(x, 5) for x in e] for e in errs]} (tol {BF16_TOL}) against the "
          f"plain version in query blocks of {c['block']}; timed (first chunk's ids): forward "
          f"kernel {f_ms:.3f} ms, plain {f_plain:.3f}, library {f_lib:.3f}, bound "
          f"{b_f['bound_ms']:.4f} ({b_f['bound_by']}, {pairs} visible pairs); forward+backward "
          f"kernel {fb_ms:.3f} (backward {fb_ms - f_ms:.3f}, bound {b_b['bound_ms']:.4f}), "
          f"library {fb_lib:.3f} (backward {fb_lib - f_lib:.3f})", flush=True)
    del q, k, v, cot, ql, kl, vl, kr, vr, mask
    return dict(ms=f_ms, plain_ms=f_plain, library_ms=f_lib, **b_f, max_abs_err=mx,
                bwd_ms=fb_ms - f_ms, fwd_bwd_ms=fb_ms, library_bwd_ms=fb_lib - f_lib,
                bwd_bound_ms=b_b["bound_ms"], err_ratios=errs)


def _window_segments(S: int, L: int, dev, gen) -> torch.Tensor:
    """Window ids in window order, with pads (-2 - w) scattered over them."""
    wi = torch.arange(S, device=dev, dtype=torch.int32) // L
    pad = torch.zeros(S, dtype=torch.bool, device=dev)
    pad[torch.randperm(S, generator=gen, device=dev)[: S // 20]] = True
    return torch.where(pad, -2 - wi, wi).to(torch.int32)


def _f_cases(dev, gen):
    from infinitevl_tpu_torch.ops.vit_flash import window_attention_reference
    from infinitevl_tpu_torch.ops.vit_kernels import window_flash_attention

    c = F_CASE
    H, D = c["H"], c["D"]
    errs, mxs = {}, []
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        errs[dtype] = []
        for S, L in c["cases"]:
            q, k, v = torch.randn((S, 3, H, D), generator=gen, device=dev).to(dtype).unbind(1)
            seg = _window_segments(S, L, dev, gen)
            out = window_flash_attention(q, k, v, seg, L)
            ref = window_attention_reference(q, k, v, seg, L)
            torch.cuda.synchronize()
            e = err_ratio(out, ref)
            require(e <= tol, f"F {dtype} S={S} L={L} err_ratio {e:.3g}")
            require(bool(torch.isfinite(out).all()), f"F {dtype} S={S} L={L}: pads not finite")
            errs[dtype].append(e)
            if dtype == torch.bfloat16:
                mxs.append(max_abs(out, ref))
    timed = {}
    for S, L in c["timed"]:
        q, k = (torch.randn((S, H, D), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        v = torch.randn((S, 3, H, D), generator=gen, device=dev).to(torch.bfloat16)[:, 2]
        seg = torch.arange(S, device=dev, dtype=torch.int32) // L
        ms = time_ms(lambda: window_flash_attention(q, k, v, seg, L))
        dev_ms = time_graph_ms(lambda: window_flash_attention(q, k, v, seg, L))
        plain = time_ms(lambda: window_attention_reference(q, k, v, seg, L))
        nW = S // L
        qb, kb, vb = (x.reshape(nW, L, H, D) for x in (q, k, v))
        mask = (seg.reshape(nW, L)[:, :, None] == seg.reshape(nW, L)[:, None, :])[:, None]
        ref = window_attention_reference(q, k, v, seg, L)
        for m in (mask, None):  # one segment a window: the unmasked call is the same function
            e_lib = err_ratio(sdpa(qb, kb, vb, m).reshape(S, H, D), ref)
            require(e_lib <= BF16_TOL, f"F library call (mask {m is not None}) err_ratio "
                    f"{e_lib:.3g}")
        lib = time_ms(lambda: sdpa(qb, kb, vb, mask))
        lib_flash = time_ms(lambda: sdpa(qb, kb, vb, None))
        bnd = bound(2 * 4 * S * H * D + 4 * S, 4 * H * D * S * L, PEAK_BF16_FLOPS)
        timed[(S, L)] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain, library_ms=lib,
                             library_unmasked_ms=lib_flash, **bnd)
        print(f"[3 parity] F timed S {S}, win_len {L}, bf16: kernel {ms:.3f} ms (device "
              f"{dev_ms:.4f} ms), plain (batched dense) {plain:.3f} ms, library: SDPA with "
              f"the mask {lib:.3f} ms, unmasked {lib_flash:.3f} ms, bound "
              f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); {_walk_line(seg, L, H)}",
              flush=True)
    print(f"[3 parity] F window_flash_attention: max err_ratio bf16 "
          f"{max(errs[torch.bfloat16]):.3g} (tol {BF16_TOL}), fp32 "
          f"{max(errs[torch.float32]):.3g} (tol {F32_TOL}); (S, win_len) {c['cases']} "
          f"with pads", flush=True)
    return dict(max_abs_err=max(mxs), **timed[c["timed"][0]],
                other_shapes={f"S{S}_L{L}": r for (S, L), r in timed.items()})


def _gate_cases(dev, gen) -> None:
    """The ViT's gates, measured: E against the dense full-attention path
    around S = 4096 (F against the batched-dense window path is in F's
    timed lines)."""
    from infinitevl_tpu_torch.ops.swa import attention_dense
    from infinitevl_tpu_torch.ops.vit_kernels import segment_flash_attention

    H, D = E_CASE["H"], E_CASE["D"]
    parts = []
    for S in GATE_FULL_SEQS:
        q, k, v = (torch.randn((S, H, D), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        seg = torch.zeros(S, dtype=torch.int32, device=dev)
        mask = (seg[:, None] == seg[None, :])[None]
        ms = time_ms(lambda: segment_flash_attention(q, k, v, seg))
        dense = time_ms(lambda: attention_dense(q[None], k[None], v[None], mask)[0])
        parts.append(f"S {S}: E {ms:.3f} ms, dense {dense:.3f} ms")
    print("[3 gates] full-attention block, one segment, bf16: " + "; ".join(parts), flush=True)


def _grad_cases(dev, gen) -> dict:
    """The autograd wrappers of C, E and F: forward through the kernel,
    backward through the plain version. Gradients against autograd through
    the plain version alone, and the time of forward + backward."""
    from infinitevl_tpu_torch.ops.delta_kernels import delta_rule_chunk_fused
    from infinitevl_tpu_torch.ops.delta_rule import delta_rule_chunk
    from infinitevl_tpu_torch.ops.vit_flash import (
        attention_segment_chunked,
        window_attention_reference,
    )
    from infinitevl_tpu_torch.ops.vit_kernels import (
        segment_flash_attention,
        window_flash_attention,
    )

    res = {}
    bf = torch.bfloat16
    mk = lambda *s: torch.randn(s, generator=gen, device=dev).to(bf)
    # C at the DeltaNet layer's shape
    cc = C_CASE
    H, K, V = cc["H"], cc["K"], cc["V"]
    for T in (257, 2048):
        q, k, v = mk(1, T, H, K), mk(1, T, H, K), mk(1, T, H, V)
        g = -torch.rand((1, T, H), generator=gen, device=dev) * 0.1
        beta = torch.rand((1, T, H), generator=gen, device=dev)
        cot = mk(1, T, H, V)
        kern = lambda *a: delta_rule_chunk_fused(*a)[0]
        plain = lambda *a: delta_rule_chunk(*a, compute_dtype=torch.float32)[0]
        n0 = delta_rule_chunk_fused.launches
        _, gk = _grads(kern, (q, k, v, g, beta), cot)
        require(delta_rule_chunk_fused.launches == n0 + 1, "C's autograd forward did not launch")
        _, gr = _grads(plain, (q, k, v, g, beta), cot)
        for name, a, b_ in zip(("dq", "dk", "dv", "dg", "dbeta"), gk, gr):
            e = err_ratio(a, b_)
            require(e <= BF16_TOL, f"C autograd T={T} {name} err_ratio {e:.3g}")
        if T == 2048:
            leaves = [x.detach().requires_grad_(True) for x in (q, k, v, g, beta)]
            res["c_fwd_bwd_ms"] = time_ms(
                lambda: torch.autograd.grad(kern(*leaves), leaves, cot), reps=5)
    # E and F at the ViT's shape
    H, D = E_CASE["H"], E_CASE["D"]
    for name, S, L in (("e", 4100, 0), ("f", 2304, 256)):
        q, k, v, cot = (mk(S, H, D) for _ in range(4))
        if L:
            seg = _window_segments(S, L, dev, gen)
            kern = lambda a, b_, c_: window_flash_attention(a, b_, c_, seg, L)
            plain = lambda a, b_, c_: window_attention_reference(a, b_, c_, seg, L)
        else:
            seg = (torch.arange(S, device=dev) * 3 // S).to(torch.int32)
            kern = lambda a, b_, c_: segment_flash_attention(a, b_, c_, seg)
            plain = lambda a, b_, c_: attention_segment_chunked(a, b_, c_, seg)
        _, gk = _grads(kern, (q, k, v), cot)
        _, gr = _grads(plain, (q, k, v), cot)
        for gname, a, b_ in zip(("dq", "dk", "dv"), gk, gr):
            e = err_ratio(a, b_)
            require(e <= BF16_TOL, f"{name.upper()} autograd {gname} err_ratio {e:.3g}")
    S = E_CASE["timed"][0]
    q, k, v, cot = (mk(S, H, D) for _ in range(4))
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    seg = torch.zeros(S, dtype=torch.int32, device=dev)
    res["e_fwd_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
        segment_flash_attention(*leaves, seg), leaves, cot), reps=3)
    wseg = torch.arange(S, device=dev, dtype=torch.int32) // 256
    res["f_fwd_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
        window_flash_attention(*leaves, wseg, 256), leaves, cot), reps=5)
    # F's backward alone: peak memory and time of forward + backward at one
    # 1344x1344 image (S 9216) with windows of 1,024 and of the whole image,
    # recomputing through the chunked twin and through the batched-dense
    # plain version it replaced ([nW, H, L, L] fp32 scores held at once)
    from infinitevl_tpu_torch.ops import vit_kernels

    chunked = vit_kernels.window_attention_chunked
    res["f_bwd_peak_gb"] = {}
    for L in (1024, 9216):
        wseg = torch.arange(S, device=dev, dtype=torch.int32) // L
        for twin in ("chunked", "dense"):
            if twin == "dense":
                vit_kernels.window_attention_chunked = window_attention_reference
            try:
                run = lambda: torch.autograd.grad(window_flash_attention(*leaves, wseg, L),
                                                  leaves, cot)
                run()
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                ms = _host_ms(run, reps=3)
                peak = (torch.cuda.max_memory_allocated() - base) / 1e9
            finally:
                vit_kernels.window_attention_chunked = chunked
            res["f_bwd_peak_gb"][f"L{L}_{twin}"] = dict(peak_gb=peak, fwd_bwd_ms=ms)
    print(f"[3 parity] F forward + backward at S {S}, bf16, memory above the inputs and time: "
          + "; ".join(f"{k} {v['peak_gb']:.2f} GB {v['fwd_bwd_ms']:.1f} ms"
                      for k, v in res["f_bwd_peak_gb"].items()), flush=True)
    print(f"[3 parity] gradients of C, E, F (kernel forward, plain-torch backward) equal "
          f"autograd through the plain versions (bf16, tol {BF16_TOL}); forward + backward: "
          f"C T 2048 {res['c_fwd_bwd_ms']:.3f} ms, E S {S} {res['e_fwd_bwd_ms']:.3f} ms, "
          f"F S {S} win_len 256 {res['f_fwd_bwd_ms']:.3f} ms", flush=True)
    return res


# the local shapes that model_parallel 2 hands the kernels at 3B: SWA GQA 16/2 -> 8/1,
# DeltaNet 16 -> 8 heads, the ViT 16 -> 8 heads (head dims unchanged)
TP_LOCAL = dict(Hq=8, Hkv=1, H=8, vit_H=8)


def _tp_local_cases(dev, gen) -> dict:
    """Phase 3 at the tensor-parallel path's local shapes: A1 (a 2,048-token
    chunk over a full ring), A2 (the decode write and attend, stacked
    rings), H (forward and backward at T 2,048), B (a decode step, 27
    layers), C (T 2,048 from a state), E (S 9,216, three segments) and F
    (S 9,216, windows of 64), bf16, each against its plain version."""
    from infinitevl_tpu_torch.ops.delta_kernels import (
        delta_rule_chunk_fused,
        delta_step_fused_stacked,
    )
    from infinitevl_tpu_torch.ops.delta_rule import delta_rule_chunk, delta_rule_step
    from infinitevl_tpu_torch.ops.swa import (
        ring_write_stacked,
        swa_cached_attention,
        swa_prefill_reference,
    )
    from infinitevl_tpu_torch.ops.swa_kernels import (
        swa_ring_flash_attention,
        swa_ring_flash_decode_stacked,
        swa_train_flash_attention,
    )
    from infinitevl_tpu_torch.ops.vit_flash import (
        attention_segment_chunked,
        window_attention_reference,
    )
    from infinitevl_tpu_torch.ops.vit_kernels import (
        segment_flash_attention,
        window_flash_attention,
    )

    c = TP_LOCAL
    Hq, Hkv, H, D, cap = c["Hq"], c["Hkv"], c["H"], 128, 8192
    bf = torch.bfloat16
    mk = lambda *s: torch.randn(s, generator=gen, device=dev).to(bf)
    errs = {}
    # A1
    q, nk, nv = mk(1, 2048, Hq, D), mk(1, 2048, Hkv, D), mk(1, 2048, Hkv, D)
    rk, rv = mk(1, Hkv, cap, D), mk(1, Hkv, cap, D)
    errs["A1"] = max(err_ratio(swa_ring_flash_attention(q, nk, nv, rk, rv, cum, cap),
                               swa_cached_attention(q, nk, nv, rk, rv, cum, cap,
                                                    write_ring=False))
                     for cum in (0, 5000, 20000))
    # A2: the stacked rings of 9 SWA layers, the token written in the kernel
    rks, rvs = mk(9, 1, Hkv, cap, D), mk(9, 1, Hkv, cap, D)
    e = 0.0
    for layer, cum in ((0, 0), (4, 8191), (8, 20000)):
        q, nk, nv = mk(1, 1, Hq, D), mk(1, 1, Hkv, D), mk(1, 1, Hkv, D)
        k_krn, v_krn, k_ref, v_ref = rks.clone(), rvs.clone(), rks.clone(), rvs.clone()
        out = swa_ring_flash_decode_stacked(q, nk, nv, k_krn, v_krn, layer, cum, cap)
        ref = swa_cached_attention(q, nk, nv, k_ref[layer], v_ref[layer], cum, cap,
                                   write_ring=False)
        ring_write_stacked(k_ref, v_ref, layer, nk, nv, cum)
        require(torch.equal(k_krn, k_ref) and torch.equal(v_krn, v_ref),
                f"A2 local shapes layer {layer} cum {cum}: the rings differ from the plain write")
        e = max(e, err_ratio(out, ref))
    errs["A2"] = e
    # H, forward and backward
    q, k, v, cot = mk(1, 2048, Hq, D), mk(1, 2048, Hkv, D), mk(1, 2048, Hkv, D), mk(1, 2048, Hq, D)
    out, gk = _grads(lambda a, b_, c_: swa_train_flash_attention(a, b_, c_, 8192), (q, k, v), cot)
    ref, gr = _grads(lambda a, b_, c_: swa_prefill_reference(a, b_, c_, 8192, 0), (q, k, v), cot)
    errs["H"] = max([err_ratio(out, ref)] + [err_ratio(a, b_) for a, b_ in zip(gk, gr)])
    # B
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    stack = rnd(27, 1, H, D, 256) * 0.1
    q, k, v = rnd(1, H, D).to(bf), rnd(1, H, D).to(bf), rnd(1, H, 256).to(bf)
    g, beta = -torch.rand((1, H), generator=gen, device=dev) * 0.5, torch.sigmoid(rnd(1, H))
    krn = stack.clone()
    o = delta_step_fused_stacked(q, k, v, g, beta, krn, 13)
    o_ref, h_ref = delta_rule_step(q, k, v, g, beta, stack[13])
    errs["B"] = max(err_ratio(o, o_ref), err_ratio(krn[13], h_ref))
    # C from a state
    q, k, v = rnd(1, 2048, H, D).to(bf), rnd(1, 2048, H, D).to(bf), rnd(1, 2048, H, 256).to(bf)
    g = -torch.rand((1, 2048, H), generator=gen, device=dev) * 0.2
    beta, h0 = torch.sigmoid(rnd(1, 2048, H)), rnd(1, H, D, 256) * 0.1
    o, hT = delta_rule_chunk_fused(q, k, v, g, beta, h0)
    o_ref, h_ref = delta_rule_chunk(q, k, v, g, beta, h0, compute_dtype=torch.float32)
    errs["C"] = max(err_ratio(o, o_ref), err_ratio(hT, h_ref))
    # E and F at the ViT's local heads, q / k / v slices of one projection
    S, vh = 9216, c["vit_H"]
    q, k, v = torch.randn((S, 3, vh, 80), generator=gen, device=dev).to(bf).unbind(1)
    seg = torch.zeros(S, dtype=torch.int32, device=dev)
    seg[S * 2 // 5: S * 3 // 4] = 1
    seg[S * 3 // 4:] = 2
    errs["E"] = err_ratio(segment_flash_attention(q, k, v, seg),
                          attention_segment_chunked(q, k, v, seg))
    wseg = torch.arange(S, device=dev, dtype=torch.int32) // 64
    errs["F"] = err_ratio(window_flash_attention(q, k, v, wseg, 64),
                          window_attention_reference(q, k, v, wseg, 64))
    torch.cuda.synchronize()
    for name, e in errs.items():
        require(e <= BF16_TOL, f"{name} at the tensor-parallel local shapes: err_ratio {e:.3g}")
    print(f"[3 parity] tensor-parallel local shapes (model_parallel 2 at 3B: SWA GQA {Hq}/{Hkv}, "
          f"DeltaNet {H} heads, ViT {vh} heads), bf16, against the plain versions, tol "
          f"{BF16_TOL}: " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + " (A1 over a full ring at cum_len 0 / 5,000 / 20,000, T 2,048; A2 at three (layer, "
          "cum_len), its rings bit-equal to the plain write; H forward, dq, dk, dv at T 2,048; B "
          "at layer 13 of 27; C at T 2,048 from a state; E at S 9,216 in 3 segments; F at S "
          "9,216, windows of 64)", flush=True)
    return {"max_err": max(errs.values()), **{f"err_{k}": v for k, v in errs.items()}}


def phase_kernels(dev, only=None) -> dict:
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = {"a1": _a1_cases, "a2": _a2_cases, "b": _b_cases, "c": _c_cases,
             "e": _e_cases, "g": _g_cases, "d": _d_cases, "h": _h_cases, "f": _f_cases,
             "grad": _grad_cases, "gates": _gate_cases, "tp": _tp_local_cases}
    res = {}
    for name, fn in cases.items():
        if only is None or name in only:
            res[name] = fn(dev, gen)
            torch.cuda.empty_cache()
    if "grad" in res:
        for k in ("c", "e", "f"):
            if k in res:
                res[k]["fwd_bwd_ms"] = res["grad"][f"{k}_fwd_bwd_ms"]
        if "f" in res:
            res["f"]["bwd_peak_gb"] = res["grad"]["f_bwd_peak_gb"]
    return res


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _state_tensors(state):
    return {k: v for k, v in state.items() if isinstance(v, torch.Tensor)}


def _small_config():
    """A narrow fp32 model whose head dims are the kernels' own (text head
    dim 128, DeltaNet K 128, ViT head dim 80), for CPU-against-card checks."""
    from infinitevl_tpu_torch.config import InfiniteVLConfig, TextConfig, VisionConfig

    vocab = 1024
    text = TextConfig(
        vocab_size=vocab, hidden_size=256, intermediate_size=512,
        num_hidden_layers=4, num_attention_heads=8, num_key_value_heads=2,
        head_dim=128, sliding_window=512, mrope_section=(16, 24, 24),
        num_linear_heads=2, num_linear_key_value_heads=2, linear_head_dim=128,
    )
    vision = VisionConfig(depth=2, hidden_size=160, intermediate_size=320, num_heads=2,
                          out_hidden_size=256, fullatt_block_indexes=(1,))
    return InfiniteVLConfig(
        text=text, vision=vision, image_token_id=vocab - 2, video_token_id=vocab - 3,
        vision_start_token_id=vocab - 4, vision_end_token_id=vocab - 5,
        bos_token_id=vocab - 6, eos_token_id=vocab - 7)


def _clone_tree(tree, device):
    if isinstance(tree, dict):
        return {k: _clone_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone_tree(v, device) for v in tree]
    return tree.detach().to(device, copy=True).requires_grad_(tree.requires_grad)


def phase_train_cross_device(dev) -> None:
    """Three training steps on the CPU (plain versions) and on the card
    (kernels H, C, E, F with their gradients) from the same fp32 weights
    and batches: full finetuning, LoRA with remat, and a multimodal batch.
    The rows have unequal lengths and are padded at their tail, as the
    collators pad them (segment id 1 for tokens, 0 for pads)."""
    from infinitevl_tpu_torch.models.infinitevl import get_rope_index
    from infinitevl_tpu_torch.models.params import init_params
    from infinitevl_tpu_torch.train.lora import init_lora, make_lora_sft_step
    from infinitevl_tpu_torch.train.step import (
        make_mm_sft_train_step,
        make_optimizer,
        make_sft_train_step,
        read_segment_layout,
        set_trainable,
        sft_loss_fn,
        tree_leaves_with_path,
    )

    cfg = _small_config()
    vocab = cfg.text.vocab_size
    base = init_params(cfg, torch.Generator().manual_seed(2), "cpu", torch.float32)
    rng = np.random.RandomState(2)
    B, T = 2, 300
    text_batches = []
    for lengths in ((300, 211), (257, 300), (120, 70)):
        seg = (np.arange(T)[None] < np.asarray(lengths)[:, None]).astype(np.int32)
        ids = rng.randint(0, vocab - 8, (B, T)) * seg
        text_batches.append(dict(
            input_ids=ids,
            labels=np.where((rng.uniform(size=(B, T)) < 0.7) & (seg > 0), ids, -100),
            position_ids=np.broadcast_to(np.arange(T)[None, None], (3, B, T)).copy(),
            segment_ids=seg))
        require(read_segment_layout(seg) == "tail_pad", "rows are not tail-padded")
    # the DeltaNet rule runs without the ids of tail padding: the same loss as
    # with them (the plain packed rule on the CPU)
    tb = {k: torch.from_numpy(v) for k, v in text_batches[0].items()}
    with torch.no_grad():
        lp, lt = (float(sft_loss_fn(base["text"], cfg.text, tb["input_ids"], tb["labels"],
                                    tb["position_ids"], tb["segment_ids"], segment_layout=lay))
                  for lay in ("packed", "tail_pad"))
    require(abs(lp - lt) <= 1e-5 * abs(lp),
            f"tail padding: loss {lt} without the ids in the delta rule, {lp} with them")
    # one 448x448 image: 32x32 patches = 1,024 (E and F on the card), 256 tokens
    grid = ((1, 32, 32),)
    n_img = 32 * 32 // 4
    ids = np.concatenate([rng.randint(0, vocab - 8, 6), [cfg.vision_start_token_id],
                          [cfg.image_token_id] * n_img, [cfg.vision_end_token_id],
                          rng.randint(0, vocab - 8, 30), np.zeros(20, np.int64)])[None]
    am = (np.arange(ids.shape[1])[None] < ids.shape[1] - 20).astype(np.int64)  # 20 pads
    pos, _ = get_rope_index(cfg, ids, image_grid_thw=np.asarray(grid), attention_mask=am)
    mm_batch = dict(
        input_ids=ids,
        labels=np.where((np.arange(ids.shape[1])[None] > n_img + 8) & (am > 0), ids, -100),
        position_ids=np.asarray(pos), segment_ids=am.astype(np.int32),
        pixel_values=rng.standard_normal((32 * 32, 3 * 2 * 14 * 14)).astype(np.float32))

    def run(kind, device):
        params = _clone_tree(base, device)
        tx = make_optimizer(1e-3, warmup_steps=1, total_steps=3)
        losses = []
        if kind == "lora":
            set_trainable(params, lambda path, leaf: False)
            tree = init_lora(params, torch.Generator().manual_seed(3), rank=4)
            tree = _clone_tree(tree, device)
            step = make_lora_sft_step(cfg.text, tx, base_params=params, alpha=8.0, rank=4,
                                      remat=True)
        else:
            set_trainable(params, lambda path, leaf: True)
            tree = params
            step = (make_mm_sft_train_step(cfg, tx) if kind == "mm"
                    else make_sft_train_step(cfg.text, tx))
        state = tx.init(tree)
        for i in range(3):
            if kind == "mm":
                _, _, loss = step(tree, state, dict(mm_batch), grid, None)
            else:
                _, _, loss = step(tree, state, dict(text_batches[i]))
            losses.append(float(loss))
        return losses, tree

    from infinitevl_tpu_torch.ops.delta_kernels import delta_rule_chunk_fused
    from infinitevl_tpu_torch.ops.swa_kernels import swa_train_flash_attention
    from infinitevl_tpu_torch.ops.vit_kernels import (
        segment_flash_attention,
        window_flash_attention,
    )

    parts = []
    for kind in ("full", "lora", "mm"):
        for w in (swa_train_flash_attention, delta_rule_chunk_fused,
                  segment_flash_attention, window_flash_attention):
            w.launches = 0
        swa_train_flash_attention.launches_bwd = 0
        l_cpu, t_cpu = run(kind, "cpu")
        require(swa_train_flash_attention.launches == 0, "a kernel launched for CPU tensors")
        l_dev, t_dev = run(kind, dev)
        torch.cuda.synchronize()
        e_loss = max(abs(a - b) / abs(a) for a, b in zip(l_cpu, l_dev))
        cpu_leaves = dict(tree_leaves_with_path(t_cpu))
        e_par = max(err_ratio(v.detach(), cpu_leaves[k].detach())
                    for k, v in tree_leaves_with_path(t_dev) if cpu_leaves[k].abs().sum() > 0)
        require(e_loss <= MODEL_TOL, f"training {kind}: loss differs CPU vs card {e_loss:.3g}")
        require(e_par <= MODEL_TOL, f"training {kind}: params differ CPU vs card {e_par:.3g}")
        require(swa_train_flash_attention.launches > 0
                and swa_train_flash_attention.launches_bwd > 0
                and delta_rule_chunk_fused.launches > 0, f"training {kind}: H or C not launched")
        if kind == "mm":
            require(segment_flash_attention.launches > 0 and window_flash_attention.launches > 0,
                    "training mm: E or F not launched")
        parts.append(f"{kind}: losses {[round(x, 4) for x in l_dev]}, loss err {e_loss:.2g}, "
                     f"params err_ratio {e_par:.2g}")
    print(f"[4 cross-device] three training steps on tail-padded rows (B 2, lengths 70-300 "
          f"of 300; the multimodal row with 20 pads), fp32 small model, CPU (plain) against "
          f"card (H, C, E, F and their gradients), tol {MODEL_TOL}: " + "; ".join(parts),
          flush=True)

    # one step on packed rows (several sequences in a row, positions restarting
    # at each, a pad tail): H, the conv and kernel C's packed path mask across
    # the boundaries, which fall inside chunks and on a chunk edge (64)
    seg = np.zeros((B, T), np.int32)
    for r, starts in enumerate(((0, 70, 128, 131, 250), (0, 64, 200))):
        for i, t0 in enumerate(starts):
            seg[r, t0:] = i + 1
    seg[:, 280:] = 0
    pos = np.zeros((B, T), np.int64)
    for r in range(B):
        for t in range(1, T):
            pos[r, t] = pos[r, t - 1] + 1 if seg[r, t] == seg[r, t - 1] else 0
    ids = rng.randint(0, vocab - 8, (B, T)) * (seg > 0)
    packed = dict(input_ids=ids,
                  labels=np.where((rng.uniform(size=(B, T)) < 0.7) & (seg > 0), ids, -100),
                  position_ids=np.broadcast_to(pos[None], (3, B, T)).copy(), segment_ids=seg)
    require(read_segment_layout(seg) == "packed", "the packed rows read as another layout")

    def packed_step(device):
        """The gradients of the packed loss, then one step of the trainer's
        step function (no warm-up: its first step moves every weight)."""
        params = _clone_tree(base, device)
        set_trainable(params, lambda path, leaf: True)
        b = {k: torch.from_numpy(v).to(device) for k, v in packed.items()}
        named = list(tree_leaves_with_path(params["text"], "text"))
        loss = sft_loss_fn(params["text"], cfg.text, b["input_ids"], b["labels"],
                           b["position_ids"], b["segment_ids"])
        grads = torch.autograd.grad(loss, [v for _, v in named], allow_unused=True)
        grads = {k: g.detach() for (k, _), g in zip(named, grads) if g is not None}
        tx = make_optimizer(1e-3, warmup_steps=0, total_steps=3)
        make_sft_train_step(cfg.text, tx)(params, tx.init(params), dict(packed))
        moved = min(float((v.detach().cpu() - base_leaves[k]).abs().max())
                    for k, v in tree_leaves_with_path(params) if k in grads)
        return float(loss.detach()), grads, params, moved

    base_leaves = dict(tree_leaves_with_path(base))

    delta_rule_chunk_fused.launches = 0
    l_cpu, g_cpu, p_cpu, moved_cpu = packed_step("cpu")
    require(delta_rule_chunk_fused.launches == 0, "C launched for CPU tensors")
    l_dev, g_dev, p_dev, moved_dev = packed_step(dev)
    torch.cuda.synchronize()
    e_loss = abs(l_cpu - l_dev) / abs(l_cpu)
    require(g_cpu.keys() == g_dev.keys(), "packed step: gradients of other leaves CPU vs card")
    e_grad = max(err_ratio(g_dev[k], g) for k, g in g_cpu.items() if g.abs().sum() > 0)
    # weights held to PACKED_TOL are those that were not zero before the step. A
    # leaf that starts at zero (the biases) holds the AdamW update alone after
    # one step, g / (|g| + eps) per element, which maps rounding noise in a
    # vanishing gradient (the k-projection bias along the slow rotary
    # dimensions shifts a row's scores alike, which the softmax ignores) to
    # +-lr on either device; its gradient is held to PACKED_TOL above.
    cpu_leaves = dict(tree_leaves_with_path(p_cpu))
    par = {k: err_ratio(v.detach(), cpu_leaves[k].detach())
           for k, v in tree_leaves_with_path(p_dev) if cpu_leaves[k].abs().sum() > 0}
    e_par = max(e for k, e in par.items() if base_leaves[k].abs().sum() > 0)
    e_new, k_new = max((e, k) for k, e in par.items() if base_leaves[k].abs().sum() == 0)
    require(delta_rule_chunk_fused.launches > 0, "packed step: C not launched on the card")
    require(moved_cpu > 0 and moved_dev > 0,
            f"packed step: a weight with a gradient did not move (largest change of the least "
            f"moved: CPU {moved_cpu:.3g}, card {moved_dev:.3g})")
    require(e_loss <= PACKED_TOL and e_grad <= PACKED_TOL and e_par <= PACKED_TOL,
            f"packed step: loss err {e_loss:.3g}, grads err_ratio {e_grad:.3g}, params "
            f"err_ratio {e_par:.3g} CPU vs card")
    print(f"[4 cross-device] gradients and one full-finetuning step (lr 1e-3, no warm-up) on "
          f"packed rows (B 2, 5 and 3 sequences in a row, boundaries inside chunks and at the "
          f"chunk edge 64, pad tails), fp32 small model, CPU against card (C's packed path, H "
          f"and the conv masked by segment), tol {PACKED_TOL}: loss {l_dev:.6f}, loss err "
          f"{e_loss:.2g}, grads err_ratio {e_grad:.2g} (worst of {len(g_cpu)} leaves), params "
          f"err_ratio {e_par:.2g} (leaves not zero before the step; those that were, the "
          f"update alone: {e_new:.2g} in {k_new}, not held to a tolerance), least moved weight "
          f"changed by {moved_dev:.2g} on the card, C launches "
          f"{delta_rule_chunk_fused.launches}", flush=True)


def phase_dt_cross_device(dev) -> None:
    """One distillation step of each stage on the small fp32 model, CPU
    (plain versions) against the card (kernels), from the same teacher, the
    same fresh mixers and the same batch: a dense full-attention teacher
    (H with an unbounded window) converted with layer 0 kept; stage 1 on
    tail-padded rows (B 2, T 300: the ids stay exact, C's packed path),
    stage 2 on the same rows. The loss and every trainable leaf within
    MODEL_TOL; the teacher bit-unchanged on the card."""
    import dataclasses

    from infinitevl_tpu_torch.models.convert import convert_attention, trainable_mask
    from infinitevl_tpu_torch.models.params import init_text_params
    from infinitevl_tpu_torch.ops.delta_kernels import delta_rule_chunk_fused
    from infinitevl_tpu_torch.ops.swa_kernels import swa_train_flash_attention as h
    from infinitevl_tpu_torch.train.distill import (
        apply_trainable_mask,
        make_stage1_step,
        make_stage2_step,
        stage2_mask,
    )
    from infinitevl_tpu_torch.train.step import make_optimizer, tree_leaves_with_path

    cfg = _small_config()
    n = cfg.text.num_hidden_layers
    tcfg = dataclasses.replace(cfg.text, layer_types=("full_attention",) * n)
    teacher_cpu = init_text_params(tcfg, torch.Generator().manual_seed(4), "cpu", torch.float32)
    student_cpu, scfg = convert_attention(teacher_cpu, tcfg, torch.Generator().manual_seed(5),
                                          softmax_attention=(0,))
    rng = np.random.RandomState(4)
    B, T = 2, 300
    seg = (np.arange(T)[None] < np.asarray([300, 211])[:, None]).astype(np.int32)
    ids = rng.randint(0, cfg.text.vocab_size - 8, (B, T)) * seg
    batch = dict(input_ids=ids, labels=np.where(seg > 0, ids, -100),
                 position_ids=np.broadcast_to(np.arange(T)[None, None], (3, B, T)).copy(),
                 segment_ids=seg)

    def run(stage, device):
        teacher = _clone_tree(teacher_cpu, device)
        student, _ = convert_attention(teacher, tcfg, None, softmax_attention=(0,))
        for i in range(1, n):  # the CPU's fresh mixers on both sides
            for k, v in student_cpu["layers"][i].items():
                if k not in ("mlp", "input_norm", "post_norm"):
                    student["layers"][i][k] = _clone_tree(v, device)
        tx = make_optimizer(1e-3, grad_clip=1e9)
        if stage == 1:
            mask = trainable_mask(student, scfg, softmax_attention=(0,))
            step = make_stage1_step(scfg, tcfg, tx, 10.0)
        else:
            mask = stage2_mask(student)
            step = make_stage2_step(scfg, tcfg, tx, 2.0)
        apply_trainable_mask(student, mask, teacher)
        zero = {k for k, v in tree_leaves_with_path(student) if not v.abs().sum()}
        _, _, loss = step(student, tx.init(student), teacher, dict(batch))
        trained = {k: v.detach() for k, v in tree_leaves_with_path(student) if v.requires_grad}
        return float(loss), trained, teacher, zero

    parts = []
    for stage in (1, 2):
        l_cpu, p_cpu, _, zero = run(stage, "cpu")
        h.launches = h.launches_bwd = delta_rule_chunk_fused.launches = 0
        l_dev, p_dev, teacher_dev, _ = run(stage, dev)
        torch.cuda.synchronize()
        launches = (h.launches, h.launches_bwd, delta_rule_chunk_fused.launches)
        e_loss = abs(l_cpu - l_dev) / abs(l_cpu)
        # a leaf that was zero before the step (a bias) holds the AdamW update
        # alone, g / (|g| + eps) x lr, which maps rounding noise in a vanishing
        # gradient to +-lr on either device: reported, not held (as in the
        # packed step above)
        e_par = max(err_ratio(v, p_cpu[k]) for k, v in p_dev.items() if k not in zero)
        e_new = max((err_ratio(v, p_cpu[k]) for k, v in p_dev.items() if k in zero),
                    default=0.0)
        require(e_loss <= MODEL_TOL and e_par <= MODEL_TOL,
                f"dt stage {stage}: loss err {e_loss:.3g}, trainable leaves err_ratio "
                f"{e_par:.3g} CPU vs card")
        want = dict(tree_leaves_with_path(teacher_cpu))
        require(all(torch.equal(v.cpu(), want[k]) for k, v in tree_leaves_with_path(teacher_dev)),
                f"dt stage {stage}: the teacher changed on the card")
        # the teacher's n layers and the student's kept layer run H; stage 2
        # differentiates the kept layer; C runs the n - 1 converted layers
        expect = (n + 1, 0 if stage == 1 else 1, n - 1)
        require(launches == expect, f"dt stage {stage}: H fwd / bwd / C launches {launches}, "
                                    f"expected {expect}")
        parts.append(f"stage {stage}: loss {l_dev:.6f}, loss err {e_loss:.2g}, {len(p_dev)} "
                     f"trainable leaves err_ratio {e_par:.2g} (those zero before the step, "
                     f"the update alone: {e_new:.2g}, not held), H fwd / bwd / C launches "
                     f"{launches}")
    print(f"[4 cross-device] one distillation step of each stage (a {n}-layer full-attention "
          f"teacher, layer 0 kept, tail-padded rows B 2, T 300, lr 1e-3), fp32 small model, "
          f"CPU against card, tol {MODEL_TOL}, the teacher bit-unchanged: " + "; ".join(parts),
          flush=True)


def phase_pref_cross_device(dev) -> None:
    """One step of rm, dpo (sigmoid) and kto with remat, and one PPO
    iteration at temperature 0, on the small fp32 model, CPU (plain
    versions) against the card (kernels), from the same weights and batches:
    right-padded chosen / rejected rows (B 2, T 300, a prompt of 40 masked),
    the policy a little away from its reference. The loss and every
    trainable leaf within MODEL_TOL, the reference bit-unchanged on the
    card, launches per step as the code implies; PPO's rollout tokens
    identical, its log-probs, values, advantages, loss and leaves within
    MODEL_TOL."""
    from infinitevl_tpu_torch.models.params import init_text_params
    from infinitevl_tpu_torch.ops.delta_kernels import delta_rule_chunk_fused as c
    from infinitevl_tpu_torch.ops.delta_kernels import delta_step_fused_stacked as b
    from infinitevl_tpu_torch.ops.swa_kernels import swa_ring_flash_attention as a1
    from infinitevl_tpu_torch.ops.swa_kernels import swa_ring_flash_decode_stacked as a2
    from infinitevl_tpu_torch.ops.swa_kernels import swa_train_flash_attention as h
    from infinitevl_tpu_torch.train import dpo, ppo
    from infinitevl_tpu_torch.train.step import (
        full_finetune_leaf,
        make_optimizer,
        set_trainable,
        trainable_leaves,
        tree_leaves_with_path,
    )

    cfg = _small_config()
    tc = cfg.text
    n_swa, n_lin = tc.num_swa_layers, tc.num_linear_layers
    base = init_text_params(tc, torch.Generator().manual_seed(6), "cpu", torch.float32)
    head = torch.randn((tc.hidden_size, 1), generator=torch.Generator().manual_seed(7)) * 0.02
    base_leaves = dict(tree_leaves_with_path(base))
    rng = np.random.RandomState(6)
    B, T = 2, 300

    def side(lengths):
        ids = np.zeros((B, T), np.int64)
        labels = np.full((B, T), -100, np.int64)
        for r, n in enumerate(lengths):
            ids[r, :n] = rng.randint(1, tc.vocab_size - 8, n)
            labels[r, 40 : n - 1] = ids[r, 41:n]
        return ids, labels

    pos = np.broadcast_to(np.arange(T)[None, None], (3, B, T)).copy()
    (ci, cl), (ri, rl) = side((300, 211)), side((257, 300))
    pair = dict(chosen_ids=ci, chosen_labels=cl, rejected_ids=ri, rejected_labels=rl,
                position_ids=pos)
    kto = dict(input_ids=ci, labels=cl, position_ids=pos, is_desirable=np.array([True, False]))

    def policy_on(device, with_head, moved=True):
        policy = _clone_tree(base, device)
        with torch.no_grad():  # away from the reference, so the log-ratios count
            for k, v in tree_leaves_with_path(policy):
                if moved and k != "inv_freq":
                    v.mul_(1.01)
        if with_head:
            policy["value_head"] = {"kernel": head.clone().to(device)}
        set_trainable(policy, full_finetune_leaf)
        return policy

    def run(kind, device):
        policy = policy_on(device, kind == "rm")
        ref = _clone_tree(base, device)
        tx = make_optimizer(1e-3, grad_clip=1e9)
        zero = {k for k, v in tree_leaves_with_path(policy) if not v.abs().sum()}
        if kind == "rm":
            step, args = dpo.make_rm_step(tc, tx, remat=True), (dict(pair),)
        elif kind == "dpo":
            step, args = dpo.make_dpo_step(tc, tx, 0.1, "sigmoid", remat=True), (ref, dict(pair))
        else:
            step, args = dpo.make_kto_step(tc, tx, 0.1, remat=True), (ref, dict(kto))
        _, _, loss = step(policy, tx.init(policy), *args)
        trained = {k: v.detach() for k, v in trainable_leaves(policy)}
        return float(loss), trained, ref, zero

    parts = []
    # (policy sides with remat: forward + recompute; reference forwards)
    sides = {"rm": (2, 0), "dpo": (2, 2), "kto": (1, 1)}
    for kind in ("rm", "dpo", "kto"):
        l_cpu, p_cpu, _, zero = run(kind, "cpu")
        h.launches = h.launches_bwd = c.launches = 0
        l_dev, p_dev, ref_dev, _ = run(kind, dev)
        torch.cuda.synchronize()
        launches = (h.launches, h.launches_bwd, c.launches)
        s_pol, s_ref = sides[kind]
        expect = ((2 * s_pol + s_ref) * n_swa, s_pol * n_swa, (2 * s_pol + s_ref) * n_lin)
        e_loss = abs(l_cpu - l_dev) / abs(l_cpu)
        e_par = max(err_ratio(v, p_cpu[k]) for k, v in p_dev.items() if k not in zero)
        e_new = max((err_ratio(v, p_cpu[k]) for k, v in p_dev.items() if k in zero),
                    default=0.0)
        require(e_loss <= MODEL_TOL and e_par <= MODEL_TOL,
                f"{kind} step: loss err {e_loss:.3g}, trainable leaves err_ratio {e_par:.3g} "
                f"CPU vs card")
        require("inv_freq" not in p_dev and len(p_dev) == len(p_cpu),
                f"{kind} step: the trainable leaves differ")
        require(all(torch.equal(v.cpu(), base_leaves[k]) for k, v in tree_leaves_with_path(ref_dev)),
                f"{kind} step: the reference changed on the card")
        require(launches == expect, f"{kind} step: H fwd / bwd / C launches {launches}, "
                                    f"expected {expect}")
        parts.append(f"{kind}: loss {l_dev:.6f}, loss err {e_loss:.2g}, {len(p_dev)} trainable "
                     f"leaves err_ratio {e_par:.2g} (those zero before the step, the update "
                     f"alone: {e_new:.2g}, not held), H fwd / bwd / C {launches}")
    print(f"[4 cross-device] one preference step of each stage with remat (right-padded rows "
          f"B 2, T 300, lr 1e-3), fp32 small model, CPU against card, tol {MODEL_TOL}, the "
          f"reference bit-unchanged: " + "; ".join(parts), flush=True)

    # one PPO iteration at temperature 0: prompts of 100 tokens (A1, C), 8 decode
    # steps (A2, B), the scoring and update forwards (H, C) and H's backward
    T_p, R = 100, 8
    prompts = [rng.randint(0, tc.vocab_size - 8, (B, T_p))]

    def ppo_run(device):
        seen = []

        def reward_fn(full_ids, resp_mask):
            seen.append(full_ids[:, T_p:].copy())
            resp = full_ids[:, T_p:]
            return ((resp % 2 == 0) * resp_mask).sum(1) / np.maximum(resp_mask.sum(1), 1)

        policy = policy_on(device, True, moved=False)  # PPO starts at its reference
        ref = _clone_tree(base, device)
        with _Spy(ppo, "token_logprobs_and_values") as scores, \
                _Spy(ppo, "gae_advantages") as gae:
            _, stats = ppo.ppo_train(cfg, policy, ref, prompts, reward_fn, rollout_len=R,
                                     temperature=0.0, learning_rate=1e-3, max_steps=1, seed=0)
        logp, values = (t.detach().cpu() for t in scores.results[0])
        adv = gae.results[0][0].cpu()
        trained = {k: v.detach() for k, v in trainable_leaves(policy)}
        return seen[0], logp, values, adv, stats[0], trained

    for k in (a1, a2, b, c, h):
        k.launches = 0
    h.launches_bwd = 0
    toks_cpu, lp_cpu, v_cpu, adv_cpu, s_cpu, p_cpu = ppo_run("cpu")
    toks_dev, lp_dev, v_dev, adv_dev, s_dev, p_dev = ppo_run(dev)
    torch.cuda.synchronize()
    launches = dict(a1=a1.launches, a2=a2.launches, b=b.launches, c=c.launches, h=h.launches,
                    h_bwd=h.launches_bwd)
    # prefill: A1 and C a layer; R decode steps: A2 and B a layer; the policy's and
    # the reference's scoring forwards and the update's: H and C a layer, H's backward
    expect = dict(a1=n_swa, a2=R * n_swa, b=R * n_lin, c=4 * n_lin, h=3 * n_swa, h_bwd=n_swa)
    errs = dict(logp=err_ratio(lp_dev, lp_cpu), values=err_ratio(v_dev, v_cpu),
                adv=err_ratio(adv_dev, adv_cpu), loss=abs(s_dev.loss - s_cpu.loss) / abs(s_cpu.loss),
                leaves=max(err_ratio(v, p_cpu[k]) for k, v in p_dev.items()
                           if p_cpu[k].abs().sum() > 0 and base_leaves.get(k, head).abs().sum() > 0))
    require(np.array_equal(toks_dev, toks_cpu),
            f"PPO rollout: greedy tokens differ CPU vs card: {toks_dev.tolist()} vs "
            f"{toks_cpu.tolist()}")
    # the policy and its reference hold the same numbers: bit-equal log-probs
    require(s_dev.kl == 0.0 and s_cpu.kl == 0.0,
            f"PPO: the first KL is {s_dev.kl} on the card, {s_cpu.kl} on the CPU, not 0")
    require(all(e <= MODEL_TOL for e in errs.values()),
            f"PPO iteration: errors CPU vs card {errs}")
    require(launches == expect, f"PPO iteration: launches {launches}, expected {expect}")
    print(f"[4 cross-device] one PPO iteration at temperature 0 (B 2, prompts of {T_p}, {R} "
          f"greedy tokens, a toy reward), fp32 small model, CPU against card, tol {MODEL_TOL}: "
          f"tokens identical, KL {s_dev.kl} on both, loss "
          f"{s_dev.loss:.6f}; err "
          + ", ".join(f"{k} {v:.2g}" for k, v in errs.items())
          + f"; launches {launches}", flush=True)


def phase_cross_device(dev) -> None:
    from infinitevl_tpu_torch.generation import Generator
    from infinitevl_tpu_torch.models.infinitevl import forward, get_rope_index
    from infinitevl_tpu_torch.models.params import init_params
    from infinitevl_tpu_torch.models.state import init_decoder_state
    from infinitevl_tpu_torch.streaming import StreamingEngine

    cfg = _small_config()
    text, vocab = cfg.text, cfg.text.vocab_size
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

    # int4 weights and fused projections: the same quantised integers on both
    # devices (quantised on the CPU, copied), every int4 matmul through the
    # plain version there and through kernel G here
    from infinitevl_tpu_torch.generation import serving_params
    from infinitevl_tpu_torch.ops.int4_kernels import int4_matmul_fused
    from infinitevl_tpu_torch.speculative import SpecStats

    q_cpu = serving_params(p_cpu, fuse=True, quant="int4")
    q_dev = _to(q_cpu, dev)
    short = ids[:1, :90]
    spos, _ = get_rope_index(cfg, short)
    outs = []
    for params, device in ((q_cpu, "cpu"), (q_dev, dev)):
        st = init_decoder_state(text, 1, torch.float32, device)
        logits, _ = forward(params, cfg, torch.as_tensor(short, device=device),
                            torch.as_tensor(spos, device=device), st)
        g = Generator(params, cfg, device=device)
        outs.append((logits, g.generate(short, max_new_tokens=16), g))
    n_g = int4_matmul_fused.launches
    worst = err_ratio(outs[1][0], outs[0][0])
    require(worst <= MODEL_TOL, f"cross-device int4 + fused logits err_ratio {worst:.3g}")
    require(np.array_equal(outs[0][1], outs[1][1]),
            f"int4 + fused greedy tokens differ CPU vs card:\n{outs[0][1]}\n{outs[1][1]}")
    require(n_g > 0, "the int4 model on the card launched kernel G no time")
    # speculative decoding against greedy, both on the card in fp32: a
    # repetitive prompt (prompt lookup finds drafts), then drafts from the
    # known continuation with every third one spoiled (partial acceptance)
    g_dev = outs[1][2]
    rep = np.tile(ids[:1, :12], (1, 6))
    want = g_dev.generate(rep, max_new_tokens=24)
    stats = SpecStats()
    got = g_dev.generate_speculative(rep, max_new_tokens=24, draft_k=5, stats=stats)
    require(np.array_equal(got, want), f"speculative != greedy on the card:\n{got}\n{want}")
    forced = SpecStats()
    got = _forced_speculative(g_dev, rep, want, 24, 5, forced)
    require(np.array_equal(got, want), f"forced-draft speculative != greedy:\n{got}\n{want}")
    require(forced.commit_steps > 0 and forced.accepted > 0, "forced drafts: no partial window")
    # a verify window's logits against the single steps': in fp32 the two
    # routes (A1 + recurrence + M = 5 against A2 + B + M = 1) agree closely
    e_window = _window_err(g_dev, rep, *_greedy_with_logits(g_dev, rep, 6), 5)
    require(e_window <= MODEL_TOL, f"fp32 verify window logits err_ratio {e_window:.3g}")
    print(f"[4 cross-device] int4 (group 128, int8 embedding) + fused projections: logits "
          f"err_ratio {worst:.3g} (tol {MODEL_TOL}), greedy tokens identical (16 tokens), "
          f"kernel G launched {n_g} times on the card; speculative == greedy on the card "
          f"(24 tokens; prompt lookup: {stats.summary()}; forced drafts: {forced.summary()}); "
          f"a verify window's logits against the single steps' err_ratio {e_window:.3g} "
          f"(tol {MODEL_TOL})",
          flush=True)

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
    from infinitevl_tpu_torch.ops.int4_kernels import int4_matmul_fused
    from infinitevl_tpu_torch.ops.swa_kernels import (
        swa_ring_flash_attention,
        swa_ring_flash_decode,
        swa_ring_flash_decode_stacked,
        swa_train_flash_attention,
    )
    from infinitevl_tpu_torch.ops.vit_kernels import (
        segment_flash_attention,
        window_flash_attention,
    )

    return (swa_ring_flash_attention, swa_ring_flash_decode_stacked,
            delta_step_fused_stacked, delta_rule_chunk_fused, segment_flash_attention,
            int4_matmul_fused, swa_ring_flash_decode, window_flash_attention,
            swa_train_flash_attention)


def _reset_launches() -> None:
    for kfn in _kernel_wrappers():
        kfn.launches = 0
        if hasattr(kfn, "launches_bwd"):
            kfn.launches_bwd = 0


def _read_launches(needed) -> dict:
    launches = {k.__name__: k.launches for k in _kernel_wrappers()}
    for name in needed:
        require(launches[name] > 0, f"kernel {name} was not launched on this path")
    return launches


def _expected_state_bytes(tc) -> int:
    """A bf16 state's bytes from the config: the rings, the DeltaNet states
    (fp32) and conv histories, and with mamba2 layers their fused conv
    histories and SSM states (fp32, head_dim x head_dim a head)."""
    HD = tc.num_attention_heads * tc.head_dim
    return (
        2 * tc.num_swa_layers * tc.num_key_value_heads * tc.swa_capacity * tc.head_dim * 2
        + tc.num_linear_layers * tc.num_linear_heads * tc.linear_head_dim * tc.head_v_dim * 4
        + tc.num_linear_layers * tc.conv_size
        * (tc.num_linear_heads * tc.linear_head_dim + tc.linear_key_dim + tc.linear_value_dim) * 2
        + tc.num_mamba2_layers * (tc.conv_size * 3 * HD * 2 + HD * tc.head_dim * 4)
    )


def phase_text_path(dev, card: str, params, cfg, profile: bool = False) -> dict:
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
    if profile:  # the last request's state: 9,000 prompt tokens, the ring full
        _profile_decode_step(params, cfg, state, out[:, -1:], card)
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
    n_full = len(vc.fullatt_block_indexes)
    for name, per_frame in (("segment_flash_attention", n_full),
                            ("window_flash_attention", vc.depth - n_full)):
        require(stream_launches[name] == n_frames * per_frame,
                f"{name} launches {stream_launches[name]}, expected {n_frames} frames x "
                f"{per_frame} blocks")
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
    _native_frames(frames[:NATIVE_FRAMES], card)
    if profile:
        _profile_frames(eng, frames[:5], float(np.median(times)), card)
        _profile_image_vit(params, cfg, pixels, grid, card)
        _profile_ask(eng, question, card)
    return stream_launches, image_launches


def _native_frames(frames, card: str) -> None:
    """Phase 6's host preprocessing: infinitevl_tpu_torch.native (built with
    g++ here) on 448x448 frames against data/processing.preprocess_image
    within NATIVE_TOL, FramePipeline's results by ticket equal to the
    single calls; host ms per frame of each."""
    from infinitevl_tpu_torch import native
    from infinitevl_tpu_torch.data.processing import preprocess_image

    t0 = time.perf_counter()
    require(native.available(), "phase 6 native: the preprocessing library did not build")
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = [native.preprocess_frame(f, (448, 448)) for f in frames]
    t_nat = (time.perf_counter() - t0) * 1e3 / len(frames)
    t0 = time.perf_counter()
    want = [preprocess_image(f)[0] for f in frames]
    t_np = (time.perf_counter() - t0) * 1e3 / len(frames)
    err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    require(all(g.shape == w.shape for g, w in zip(got, want)) and err <= NATIVE_TOL,
            f"phase 6 native: max abs err {err:.3g} against preprocess_image (tol {NATIVE_TOL})")
    pipe = native.FramePipeline(workers=4)
    try:
        t0 = time.perf_counter()
        tickets = [pipe.submit(f, (448, 448)) for f in frames]
        piped = [pipe.collect(t, (448, 448)) for t in tickets]
        t_pipe = (time.perf_counter() - t0) * 1e3 / len(frames)
    finally:
        pipe.close()
    require(tickets == sorted(tickets) and all(np.array_equal(a, b) for a, b in zip(piped, got)),
            "phase 6 native: FramePipeline's results differ from the single calls")
    print(f"[6 stream path] native host preprocessing of {len(frames)} raw 448x448 frames "
          f"(g++ build {t_build:.1f} s): {t_nat:.2f} ms a frame, FramePipeline with 4 workers "
          f"{t_pipe:.2f} ms a frame, the numpy path (data/processing.preprocess_image) "
          f"{t_np:.2f} ms a frame; max abs err {err:.2g} (tol {NATIVE_TOL}); the pipeline's "
          f"results by ticket bit-equal to the single calls; host clock on '{card}'", flush=True)


def _forced_speculative(g, ids, want, new_tokens, draft_k, stats, eos=None):
    """Speculative decoding whose drafts are the known greedy continuation
    `want` with every third draft token spoiled: full, partial and empty
    acceptance all occur, whatever the model emits."""
    from infinitevl_tpu_torch.speculative import generate_speculative

    T = ids.shape[1]
    vocab = g.cfg.text.vocab_size

    def draft_fn(ctx, k):
        done = len(ctx) - T  # tokens emitted so far
        d = np.array(want[0, done:done + k], dtype=np.int64)
        for i in range(len(d)):
            if (done + i) % 3 == 2:
                d[i] = (d[i] + 1) % vocab
        return d

    return generate_speculative(g, ids, max_new_tokens=new_tokens, draft_k=draft_k,
                                eos_token_id=eos, stats=stats, draft_fn=draft_fn)


def _greedy_with_logits(g, ids, new_tokens):
    """Plain greedy decoding step by step, keeping every step's logits."""
    from infinitevl_tpu_torch.generation import decode_step

    logits, state, delta = g.prefill_prompt(ids)
    toks, rows = [], []
    for _ in range(new_tokens):
        rows.append(logits[0].float().cpu())
        tok = torch.argmax(logits, dim=-1)
        toks.append(int(tok[0]))
        logits, state = decode_step(g.params, g.cfg, tok[:, None], delta, state)
    return np.asarray([toks]), rows


def _window_err(g, ids, want, rows, k: int) -> float:
    """err_ratio of one verify window over the first k greedy tokens `want`
    against the single steps' logits `rows` (rows[j] follows want[j - 1])."""
    from infinitevl_tpu_torch.generation import spec_verify

    _, state, delta = g.prefill_prompt(ids)
    window = torch.as_tensor(want[:, :k], device=g.device)
    vlogits, _ = spec_verify(g.params, g.cfg, window, delta, state)
    return max(err_ratio(vlogits[0, j], rows[j + 1]) for j in range(k))


def _same_or_tie(got, want, rows, what: str) -> str:
    """`got` against the greedy tokens `want`: identical, or at the first
    difference the two candidates' greedy logits lie within TIE_TOL (two
    bf16 decodings of one context round differently; after a legitimate
    flip the contexts differ, so the comparison ends there)."""
    n = min(got.shape[1], want.shape[1])
    diff = np.nonzero(got[0, :n] != want[0, :n])[0]
    if len(diff) == 0:
        require(got.shape == want.shape, f"{what}: {got.shape[1]} tokens, greedy {want.shape[1]}")
        return f"identical ({n} tokens)"
    i = int(diff[0])
    gap = float(rows[i][want[0, i]] - rows[i][got[0, i]])
    require(0 <= gap <= TIE_TOL, f"{what}: token {i} differs from greedy and its logit "
            f"is {gap:.3g} below the greedy token's (near-tie tolerance {TIE_TOL})")
    return f"identical for {i} tokens, then a bf16 near tie (logit gap {gap:.3g})"


def _timed_request(g, ids, new_tokens):
    """(time to first token s, decode s, tokens) of one streamed request."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunks = []
    for chunk in g.generate_stream(ids, max_new_tokens=new_tokens, eos_token_id=-1):
        chunks.append(chunk)
        if len(chunks) == 1:
            t_first = time.perf_counter()
    t_end = time.perf_counter()
    out = np.concatenate(chunks, axis=1)
    require(out.shape == (ids.shape[0], new_tokens), f"request returned {out.shape}")
    require(bool(((out >= 0) & (out < g.cfg.text.vocab_size)).all()), "tokens outside the vocab")
    return t_first - t0, t_end - t_first, out


def _http(port: int, body=None, path="/v1/chat/completions"):
    """One request to the loopback server: (status, parsed JSON)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    if body is None:
        conn.request("GET", path)
    else:
        conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read())
    conn.close()
    return resp.status, data


def _http_sse(port: int, body):
    """A streamed request: (status, text deltas, seconds to the first delta)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    conn.request("POST", "/v1/chat/completions", json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    pieces, t_first, done = [], None, False
    for raw in resp:
        line = raw.decode().strip()
        if not line.startswith("data: "):
            continue
        if line == "data: [DONE]":
            done = True
            break
        delta = json.loads(line[6:])["choices"][0]["delta"]
        if "content" in delta:
            if t_first is None:
                t_first = time.perf_counter() - t0
            pieces.append(delta["content"])
    conn.close()
    require(done, "the SSE stream did not end with [DONE]")
    return resp.status, pieces, t_first


def _count_nodes(tree, key: str) -> int:
    if isinstance(tree, dict):
        return int(key in tree) + sum(_count_nodes(v, key) for v in tree.values())
    if isinstance(tree, list):
        return sum(_count_nodes(v, key) for v in tree)
    return 0


def phase_serve_path(dev, card: str, params, cfg, profile: bool = False) -> dict:
    import base64
    import io
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    from infinitevl_tpu_torch.data.loader import SimpleTokenizer
    from infinitevl_tpu_torch.generation import (
        Generator,
        decode_step,
        decode_step_preserve,
        spec_verify,
    )
    from infinitevl_tpu_torch.models.quant import quantized_bytes
    from infinitevl_tpu_torch.models.state import init_decoder_state, state_bytes
    from infinitevl_tpu_torch.ops.int4_kernels import int4_matmul_fused
    from infinitevl_tpu_torch.serve.api import ChatBackend, create_server
    from infinitevl_tpu_torch.serve.batching import BatchingEngine
    from infinitevl_tpu_torch.speculative import SpecStats

    tc = cfg.text
    expect_bytes = _expected_state_bytes(tc)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g4 = Generator(params, cfg, quant="int4")  # quantised on the card, node by node
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    quant_peak = torch.cuda.max_memory_allocated() / 1e9
    bytes_bf16, bytes_int4 = quantized_bytes(params), quantized_bytes(g4.params)
    n_q4, n_plain = _count_nodes(g4.params, "kernel_q4"), _count_nodes(g4.params, "kernel")
    require(n_q4 == 7 * tc.num_swa_layers + 8 * tc.num_linear_layers
            + 5 * cfg.vision.depth + 2, f"{n_q4} int4 nodes")
    # one decode step: 7 int4 matmuls per SWA layer, 8 per DeltaNet layer
    # (a_proj / b_proj stay bf16 under min_size), none of them on another route
    st = init_decoder_state(tc, 1, torch.bfloat16)
    before = int4_matmul_fused.launches
    decode_step(g4.params, cfg, torch.zeros((1, 1), dtype=torch.long, device=dev),
                torch.zeros((1, 1), dtype=torch.long, device=dev), st)
    per_step = int4_matmul_fused.launches - before
    require(per_step == 7 * tc.num_swa_layers + 8 * tc.num_linear_layers,
            f"{per_step} int4 matmuls in one decode step")
    print(f"[7 serve path] int4 weights (group 128, int8 embedding + head copy): quantised on "
          f"the card in {t_quant:.2f} s, {bytes_int4 / 1e9:.3f} GB against {bytes_bf16 / 1e9:.3f} "
          f"GB bf16 (quantized_bytes), {n_q4} int4 nodes, {n_plain} small nodes left in bf16, "
          f"peak memory while quantising {quant_peak:.2f} GB; {per_step} kernel G launches "
          f"per decode step on '{card}'", flush=True)

    tok = SimpleTokenizer(config=cfg)
    backend = ChatBackend(g4, tok, model_name="infinitevl-3b-int4")
    server = create_server(backend, "127.0.0.1", 0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    rng = np.random.RandomState(0)
    words = "the quick brown fox jumps over the lazy dog while streams of video frames keep " \
            "arriving and the state stays the same size".split()
    question = " ".join(words[i % len(words)] for i in range(40))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    try:
        status, models = _http(port, path="/v1/models")
        require(status == 200 and models["data"][0]["id"] == "infinitevl-3b-int4", "/v1/models")
        # 1. a plain completion
        t0 = time.perf_counter()
        status, r1 = _http(port, {"messages": [{"role": "user", "content": question}],
                                  "max_tokens": SERVE_NEW_TOKENS})
        t_plain = time.perf_counter() - t0
        require(status == 200, f"plain request: {status} {r1}")
        c1 = r1["choices"][0]
        require(isinstance(c1["message"]["content"], str)
                and c1["finish_reason"] in ("stop", "length")
                and 1 <= r1["usage"]["completion_tokens"] <= SERVE_NEW_TOKENS
                and r1["usage"]["prompt_tokens"] >= 40, f"plain request: {r1}")
        # 2. the same request streamed: the deltas join to the same text
        status, pieces, t_first = _http_sse(port, {
            "messages": [{"role": "user", "content": question}],
            "max_tokens": SERVE_NEW_TOKENS, "stream": True})
        require(status == 200 and len(pieces) >= 2, f"streamed request: {len(pieces)} deltas")
        require("".join(pieces) == c1["message"]["content"],
                "the streamed text differs from the plain completion")
        # 3. two sampled completions with a stop sequence
        stop = "<unk> <unk> <unk>"
        status, r3 = _http(port, {"messages": [{"role": "user", "content": question}],
                                  "max_tokens": SERVE_NEW_TOKENS, "n": 2, "temperature": 0.8,
                                  "stop": [stop]})
        require(status == 200 and len(r3["choices"]) == 2, f"n = 2 request: {status} {r3}")
        for ch in r3["choices"]:
            require(stop not in ch["message"]["content"], "stop sequence left in the text")
        # 4. an image as a data URI
        img = Image.fromarray(rng.randint(0, 256, (SERVE_IMAGE_HW, SERVE_IMAGE_HW, 3))
                              .astype(np.uint8))
        buf = io.BytesIO()
        img.save(buf, format="PNG")
        uri = "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()
        t0 = time.perf_counter()
        status, r4 = _http(port, {"messages": [{"role": "user", "content": [
            {"type": "text", "text": "what is in this picture"},
            {"type": "image_url", "image_url": {"url": uri}}]}], "max_tokens": 8})
        t_image = time.perf_counter() - t0
        n_img = (SERVE_IMAGE_HW // 28) ** 2
        require(status == 200 and r4["usage"]["prompt_tokens"] > n_img
                and 1 <= r4["usage"]["completion_tokens"] <= 8, f"image request: {status} {r4}")
        # a malformed request is refused, not served
        status, bad = _http(port, {"messages": []})
        require(status == 400, f"empty messages: {status}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    print(f"[7 serve path] HTTP server on 127.0.0.1:{port}, 3B int4: plain completion "
          f"{r1['usage']['prompt_tokens']} + {r1['usage']['completion_tokens']} tokens in "
          f"{t_plain:.2f} s; SSE stream {len(pieces)} deltas, first after {t_first * 1e3:.0f} ms, "
          f"text equal to the plain one; n = 2 sampled with a stop sequence: finish "
          f"{[c['finish_reason'] for c in r3['choices']]}; image request "
          f"{r4['usage']['prompt_tokens']} prompt tokens in {t_image:.2f} s on '{card}'",
          flush=True)

    # speculative against greedy on the same generator
    prompt = np.tile(rng.randint(0, tc.vocab_size - 1000, (1, 16)), (1, 4))
    want, rows = _greedy_with_logits(g4, prompt, SPEC_NEW_TOKENS)
    again = g4.generate(prompt, max_new_tokens=SPEC_NEW_TOKENS, eos_token_id=-1)
    require(np.array_equal(again, want), "generate disagrees with step-by-step greedy")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g4.generate(prompt, max_new_tokens=SPEC_NEW_TOKENS, eos_token_id=-1)
    t_greedy = time.perf_counter() - t0
    # one verify window over the greedy continuation against the single
    # steps' logits, and what a window costs beside a step (both on a copy
    # of the state, as speculation runs them)
    e_window = _window_err(g4, prompt, want, rows, SPEC_DRAFT_K)
    g16 = Generator(params, cfg)  # the same weights unquantised, as a yardstick
    e_bf16 = _window_err(g16, prompt, *_greedy_with_logits(g16, prompt, SPEC_DRAFT_K + 1),
                         SPEC_DRAFT_K)
    del g16
    require(max(e_window, e_bf16) <= SPEC_LOGIT_TOL,
            f"verify window logits err_ratio int4 {e_window:.3g}, bf16 {e_bf16:.3g}")
    _, st0, delta = g4.prefill_prompt(prompt)
    window = torch.as_tensor(want[:, :SPEC_DRAFT_K], device=dev)
    t_window = _host_ms(lambda: spec_verify(g4.params, cfg, window, delta, st0))
    t_step = _host_ms(lambda: decode_step_preserve(g4.params, cfg, window[:, :1], delta, st0))
    del st0
    lookup, forced = SpecStats(), SpecStats()
    got = g4.generate_speculative(prompt, max_new_tokens=SPEC_NEW_TOKENS, draft_k=SPEC_DRAFT_K,
                                  eos_token_id=-1, stats=lookup)
    verdict_lookup = _same_or_tie(got, want, rows, "speculative (prompt lookup)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = _forced_speculative(g4, prompt, want, SPEC_NEW_TOKENS, SPEC_DRAFT_K, forced, eos=-1)
    t_spec = time.perf_counter() - t0
    verdict_forced = _same_or_tie(got, want, rows, "speculative (forced drafts)")
    require(forced.windows > 0 and forced.accepted > 0, "forced drafts: nothing accepted")
    print(f"[7 serve path] speculative decoding, draft_k {SPEC_DRAFT_K}: a verify window's "
          f"logits against the single steps' err_ratio {e_window:.3g} (bf16 weights "
          f"{e_bf16:.3g}, tol {SPEC_LOGIT_TOL}); "
          f"a window of {SPEC_DRAFT_K} takes {t_window:.1f} ms, a single step {t_step:.1f} ms "
          f"(each on a copy of the state); {SPEC_NEW_TOKENS} tokens against greedy: prompt lookup {verdict_lookup}, {lookup.summary()}; drafts "
          f"from the greedy continuation with every third spoiled {verdict_forced}, "
          f"{forced.summary()}: {t_spec:.2f} s against {t_greedy:.2f} s greedy on '{card}'",
          flush=True)

    # beam search
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    beams = g4.generate_beam(prompt[:, :32], num_beams=4, max_new_tokens=BEAM_NEW_TOKENS,
                             eos_token_id=-1)
    t_beam = time.perf_counter() - t0
    require(beams.shape == (1, BEAM_NEW_TOKENS)
            and bool(((beams >= 0) & (beams < tc.vocab_size)).all()), f"beam search: {beams}")

    # a burst of same-length requests through the batching engine (the
    # weights are quantised already)
    eng = BatchingEngine(g4.params, cfg, max_wait_ms=200.0)
    burst = [rng.randint(0, tc.vocab_size - 1000, (48,)) for _ in range(BURST)]
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(BURST) as pool:
            outs = list(pool.map(
                lambda ids: eng.generate(ids, max_new_tokens=BURST_NEW_TOKENS, eos_token_id=-1,
                                         timeout=600), burst))
        t_burst = time.perf_counter() - t0
    finally:
        eng.shutdown()
    require(all(len(o) == BURST_NEW_TOKENS for o in outs), f"burst lengths {list(map(len, outs))}")
    require(eng.stats["requests"] == BURST and eng.stats["rows"] >= BURST, f"burst {eng.stats}")
    torch.cuda.synchronize()
    launches = _read_launches(("int4_matmul_fused", "swa_ring_flash_attention",
                               "swa_ring_flash_decode_stacked", "delta_step_fused_stacked",
                               "delta_rule_chunk_fused"))
    print(f"[7 serve path] beam search (4 beams, {BEAM_NEW_TOKENS} tokens) {t_beam:.2f} s; "
          f"BatchingEngine burst of {BURST} x 48-token prompts, {BURST_NEW_TOKENS} tokens each: "
          f"{eng.stats['batches']} batches, {eng.stats['rows']} rows, {t_burst:.2f} s = "
          f"{BURST * BURST_NEW_TOKENS / t_burst:.1f} tok/s aggregate; launches of the serving "
          f"path {launches} on '{card}'", flush=True)

    # decode rate and memory per weight format, one request each
    ids = rng.randint(0, tc.vocab_size - 1000, (1, 50))
    frames = rng.randint(0, 256, (MODE_FRAMES, 448, 448, 3)).astype(np.uint8)
    modes = [("int4", g4)]
    del backend, eng
    for name, kw in (("bf16", {}), ("int8", dict(quant="int8")), ("bf16 fused", dict(fuse=True)),
                     ("int4 fused", dict(quant="int4", fuse=True))):
        modes.append((name, kw))
    for name, g in modes:
        if isinstance(g, dict):
            g = Generator(params, cfg, **g)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state = init_decoder_state(tc, 1, torch.bfloat16)
        require(state_bytes(state) == expect_bytes, "state size")
        del state
        _timed_request(g, ids, 4)  # warm-up
        ttft, dec, out = _timed_request(g, ids, MODE_NEW_TOKENS)
        # the same weights under the streaming engine (a quantised or fused
        # tree is taken as it is): a frame is M = 1024 in the ViT, 257 below
        before = int4_matmul_fused.launches
        eng = _stream_engine(g.params, cfg, ids[:, :8])
        for f in frames:
            eng.push_frame_raw(f)
        require(state_bytes(eng.state) == expect_bytes, "state size changed by a frame")
        for key, t in _state_tensors(eng.state).items():
            require(bool(torch.isfinite(t.float()).all()), f"{name}: state {key} not finite")
        frame_ms = float(np.median(eng.frame_times_ms[1:]))
        n_g = int4_matmul_fused.launches - before
        require((n_g > 0) == name.startswith("int4"), f"{name}: {n_g} kernel G launches")
        if profile and name == "int4":
            _profile_int4_frame(eng, frames, frame_ms, card)
        print(f"[7 serve path] {name}: weights {quantized_bytes(g.params) / 1e9:.3f} GB, time "
              f"to first token {ttft * 1e3:.1f} ms (50-token prompt), decode "
              f"{(MODE_NEW_TOKENS - 1) / dec:.2f} tok/s ({MODE_NEW_TOKENS - 1} steps, B=1), "
              f"448x448 frames {frame_ms:.2f} ms median = {1e3 / frame_ms:.2f} frames/s "
              f"({MODE_FRAMES} frames, the first excluded, {n_g} kernel G launches), "
              f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, state "
              f"{expect_bytes / 1e6:.1f} MB on '{card}'", flush=True)
        del g, eng
    return launches


# ---------------------------------------------------------------- training


def _free() -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _long_text_dataset(root: str, min_words: int) -> None:
    """A dataset directory with one alpaca example: the outputs of
    data/demo.json repeated until the answer is longer than `min_words`
    words (the word-level tokenizer gives about a token per word), so one
    row fills cutoff_len without pads and every step sees the same batch."""
    import os

    demo = json.load(open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                       "data", "demo.json")))
    words = " ".join(ex["output"] for ex in demo).split()
    answer = " ".join(words[i % len(words)] for i in range(min_words + 64))
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "demo_long.json"), "w") as f:
        json.dump([{"instruction": demo[0]["instruction"], "input": "", "output": answer}], f)
    with open(os.path.join(root, "dataset_info.json"), "w") as f:
        json.dump({"demo_long": {"file_name": "demo_long.json", "formatting": "alpaca"}}, f)


def _packed_text_dataset(root: str, n: int = 14, seed: int = 0) -> None:
    """A dataset directory of `n` alpaca examples whose answers are 80 to 700
    words of data/demo.json's outputs, for `packing: true`: the packer puts
    several of them into each cutoff_len row (segment ids 1, 2, ...)."""
    import os

    demo = json.load(open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                       "data", "demo.json")))
    words = " ".join(ex["output"] for ex in demo).split()
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n):
        m = int(rng.randint(80, 700))
        rows.append({"instruction": demo[i % len(demo)]["instruction"], "input": "",
                     "output": " ".join(words[(i * 37 + j) % len(words)] for j in range(m))})
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "demo_packed.json"), "w") as f:
        json.dump(rows, f)
    with open(os.path.join(root, "dataset_info.json"), "w") as f:
        json.dump({"demo_packed": {"file_name": "demo_packed.json", "formatting": "alpaca"}}, f)


def _train_args(out_dir: str, **over):
    from infinitevl_tpu_torch.hparams import parse_args

    conf = dict(stage="sft", config_preset="infinitevl_3b", template="qwen2_vl",
                per_device_train_batch_size=1, bf16=True, logging_steps=1, save_steps=10**6,
                lr_scheduler_type="constant", learning_rate=1e-3, num_train_epochs=1000.0,
                output_dir=out_dir, seed=0)
    conf.update(over)
    return parse_args(conf)


def _run_recipe(name: str, args, card: str, expect_launches=None, run=None,
                tag: str = "8 train", positions=None) -> dict:
    """One workflow call at 3B width (`run`, default run_sft): per-step
    losses and times from its trainer_log.jsonl, peak memory, launch counts
    (set to 0 just before, read just after, held to `expect_launches` per
    step). `positions`: those a step runs through the model (default
    cutoff_len x batch size)."""
    import os

    from infinitevl_tpu_torch.ops.swa_kernels import swa_train_flash_attention as h
    from infinitevl_tpu_torch.train.trainer import run_sft

    _free()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    final = (run or run_sft)(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches(())
    launches["swa_train_flash_attention_bwd"] = h.launches_bwd
    peak = torch.cuda.max_memory_allocated() / 1e9
    recs = [json.loads(line) for line in
            open(os.path.join(args.train.output_dir, "trainer_log.jsonl"))]
    recs = [r for r in recs if "loss" in r]
    losses = [r["loss"] for r in recs]
    steps = args.train.max_steps
    require(len(losses) == steps and all(np.isfinite(losses)),
            f"{name}: losses {losses} for {steps} steps")
    # the log's clock starts before the first step; steady steps are the later ones
    times = np.diff([r["elapsed_s"] for r in recs]) * 1e3
    step_ms = float(np.median(times)) if len(times) else float("nan")
    ntok = positions or args.data.cutoff_len * args.train.per_device_train_batch_size
    if expect_launches:
        for key, per_step in expect_launches.items():
            require(launches[key] == per_step * steps,
                    f"{name}: {key} launched {launches[key]} times, expected "
                    f"{per_step} x {steps} steps")
    timed = (f"{step_ms:.0f} ms per step (median of steps 2..), {ntok / step_ms * 1e3:.0f} "
             f"positions/s at {ntok} positions per step (pads included), " if len(times)
             else f"{ntok} positions, ")
    print(f"[{tag}] {name}: {steps} steps, losses {[round(x, 6) for x in losses]}, {timed}"
          f"{recs[-1]['tokens_per_sec']:.0f} real tok/s by the trainer's count over the whole "
          f"run (first step included), peak memory {peak:.2f} GB, whole call {wall:.1f} s "
          f"(weights, dataset and the final train-state save included); launches H fwd "
          f"{launches['swa_train_flash_attention']} bwd {h.launches_bwd}, C "
          f"{launches['delta_rule_chunk_fused']}, E {launches['segment_flash_attention']}, F "
          f"{launches['window_flash_attention']} on '{card}'", flush=True)
    del final
    _free()
    return dict(losses=losses, step_ms=step_ms, peak_gb=peak, launches=launches,
                positions_s=ntok / step_ms * 1e3 if len(times) else float("nan"))


TRAIN_LAYERS = 12  # phase 8: the decoder's depth, 3 hybrid periods (the script's time budget's)


def phase_train_path(dev, card: str, profile: bool) -> dict:
    """Phase 8: SFT at 3B width and TRAIN_LAYERS deep through run_sft / Trainer."""
    from infinitevl_tpu_torch.train import trainer as T

    real_3b, T.infinitevl_3b = T.infinitevl_3b, lambda: _cut_3b(TRAIN_LAYERS)
    try:
        return _train_path(dev, card, profile)
    finally:
        T.infinitevl_3b = real_3b


def _train_path(dev, card: str, profile: bool) -> dict:
    import os
    import shutil
    import tempfile

    from infinitevl_tpu_torch.data.loader import resolve_tokenizer
    from infinitevl_tpu_torch.train import trainer as T
    from infinitevl_tpu_torch.train.lora import init_lora, make_lora_sft_step
    from infinitevl_tpu_torch.train.step import (
        make_optimizer,
        read_segment_layout,
        set_trainable,
        sft_loss_fn,
        tree_leaves_with_path,
    )

    tc = T.infinitevl_3b().text
    n_swa, n_lin = tc.num_swa_layers, tc.num_linear_layers
    root = tempfile.mkdtemp(prefix="ivl_train_")
    repo_data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
    data_dir = os.path.join(root, "data")
    _long_text_dataset(data_dir, 8192)
    text = dict(dataset="demo_long", dataset_dir=data_dir)
    lora = dict(finetuning_type="lora", lora_rank=8, lora_alpha=16, remat=True)
    # remat runs every layer's forward twice: 2 H forwards and 1 H backward a SWA
    # layer, 2 C a DeltaNet layer
    remat_launches = {"swa_train_flash_attention": 2 * n_swa,
                      "swa_train_flash_attention_bwd": n_swa,
                      "delta_rule_chunk_fused": 2 * n_lin}
    total = {}
    res = {}

    def add(r):
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v

    res["lora_2048"] = _run_recipe(
        "(a) LoRA r 8 on q/k/v/o, remat, cutoff_len 2048, B 1",
        _train_args(os.path.join(root, "a"), cutoff_len=2048, max_steps=4, **text, **lora),
        card, remat_launches)
    la = res["lora_2048"]["losses"]
    require(la[-1] < la[0], f"(a): the loss did not fall on the repeated batch: {la}")
    add(res["lora_2048"])
    # the repo's dataset as it is: rows of 20-30 tokens, two to a batch, each
    # padded to cutoff_len (segment id 0), so H and the conv mask pads and C
    # runs unmasked over them
    res["lora_demo"] = _run_recipe(
        "(a2) the same on data/demo.json as it is, B 2, rows padded to cutoff_len 2048",
        _train_args(os.path.join(root, "a2"), cutoff_len=2048, max_steps=4, dataset="demo",
                    dataset_dir=repo_data, per_device_train_batch_size=2, **lora),
        card, remat_launches)
    add(res["lora_demo"])
    # (a3) packed rows: several sequences of unequal length in each row, so C
    # runs its packed path (segment ids) and H and the conv mask by segment
    packed_dir = os.path.join(root, "packed_data")
    _packed_text_dataset(packed_dir)
    args = _train_args(os.path.join(root, "a3"), cutoff_len=2048, max_steps=4,
                       dataset="demo_packed", dataset_dir=packed_dir, packing=True, **lora)
    rows = T.build_dataset(args)
    layouts = [read_segment_layout(np.asarray(r["segment_ids"])[None]) for r in rows]
    n_seq = [int(np.asarray(r["segment_ids"]).max()) for r in rows]
    require(layouts.count("packed") >= 1, f"(a3) packing made no packed row: {layouts}")
    res["lora_packed"] = _run_recipe(
        f"(a3) the same with packing: true, {len(rows)} rows of 2048 holding {n_seq} sequences",
        args, card, remat_launches)
    add(res["lora_packed"])
    res["lora_8192"] = _run_recipe(
        "(b) the same at cutoff_len 8192",
        _train_args(os.path.join(root, "b"), cutoff_len=8192, max_steps=2, **text, **lora),
        card, remat_launches)
    add(res["lora_8192"])
    res["qlora_2048"] = _run_recipe(
        "(c) QLoRA: int8 frozen base, cutoff_len 2048",
        _train_args(os.path.join(root, "c"), cutoff_len=2048, max_steps=3,
                    quantization_bit=8, **text, **lora),
        card, remat_launches)
    add(res["qlora_2048"])
    # Trainer.save replaced: the train state (the decoder's weights and two
    # moments, ~18 GB) took ~20 s to write and is read by nothing; (f) holds
    # save / resume
    with _Spy(T.Trainer, "save", replace=lambda trainer: None):
        res["full_2048"] = _run_recipe(
            f"(d) full finetuning of the decoder, depth {tc.num_hidden_layers}, remat, "
            "cutoff_len 2048, Trainer.save replaced",
            _train_args(os.path.join(root, "d"), cutoff_len=2048, max_steps=3, remat=True,
                        learning_rate=1e-5, **text),
            card, remat_launches)
    add(res["full_2048"])
    shutil.rmtree(os.path.join(root, "d"), ignore_errors=True)

    # (e) multimodal LoRA steps on data/mllm_demo.json's first image, resized by
    # the processor to 448x448 and to 1344x1344; the row is padded to cutoff_len
    for hw, cutoff in ((448, 512), (1344, 2560)):
        mm = dict(dataset="mllm_demo", dataset_dir=repo_data, max_samples=1,
                  image_min_pixels=hw * hw, image_max_pixels=hw * hw, **lora)
        args = _train_args(os.path.join(root, f"e{hw}"), cutoff_len=cutoff, max_steps=2, **mm)
        cfg = T.build_config(args)
        row = T.build_dataset(args, cfg=cfg)[0]
        require(tuple(row["image_grid_thw"][0]) == (1, hw // 14, hw // 14),
                f"(e) image grid {row['image_grid_thw']}")
        n_row = len(row["input_ids"])
        require(n_row < cutoff, f"(e) the row of {n_row} tokens is cut at {cutoff}")
        r = _run_recipe(
            f"(e) multimodal LoRA, one {hw}x{hw} image ({(hw // 14) ** 2} patches, "
            f"{n_row} tokens padded to {cutoff})", args, card, remat_launches)
        # the ViT is frozen under LoRA: its kernels launch forward only, once per step
        require(r["launches"]["segment_flash_attention"] == 2 * 4
                and r["launches"]["window_flash_attention"] == 2 * 28,
                f"(e) {hw}: E / F launches {r['launches']}")
        res[f"mm_lora_{hw}"] = r
        add(r)

    # (f) Trainer by hand: the base loss, base weights unchanged, save / resume
    _free()
    args = _train_args(os.path.join(root, "f"), cutoff_len=2048, max_steps=3, **text, **lora)
    cfg = T.build_config(args)
    # the tokenizer run_sft makes (its word ids grow while it encodes)
    data = T.build_dataset(args, resolve_tokenizer(args, cfg, None), cfg=cfg)
    params = T._load_or_init_params(args, cfg, False, torch.bfloat16, dev)
    set_trainable(params, lambda path, leaf: False)
    sums = {k: v.double().sum().item() for k, v in tree_leaves_with_path(params)}
    batch = next(iter(T._batches(args, data, cfg, False)))
    tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items() if k != "_n_tokens"}
    with torch.no_grad():
        base_loss = float(sft_loss_fn(
            params["text"], cfg.text, tb["input_ids"], tb["labels"], tb["position_ids"],
            tb["segment_ids"], remat=True,
            segment_layout=read_segment_layout(batch["segment_ids"])))
    require(abs(base_loss - la[0]) <= 1e-6 * abs(base_loss),
            f"(f) LoRA's first loss {la[0]} is not the base model's {base_loss} (b = 0)")

    def trainer(out):
        tx = make_optimizer(1e-3, schedule="constant")
        ad = init_lora(params, torch.Generator(device=dev).manual_seed(1), rank=8)
        step = make_lora_sft_step(cfg, tx, alpha=16, rank=8, remat=True)
        return T.Trainer(step, ad, tx.init(ad), out, logging_steps=1, save_steps=10**6,
                         extra_step_args=(params,)), step

    straight, step_fn = trainer(os.path.join(root, "f_straight"))
    straight.train(T._batches(args, data, cfg, False), max_steps=3)
    first, _ = trainer(os.path.join(root, "f_resumed"))
    first.train(T._batches(args, data, cfg, False), max_steps=2)  # saves at its end
    second, _ = trainer(os.path.join(root, "f_resumed"))
    second.resume()
    require(second.step == 2, f"(f) resumed at step {second.step}")
    second.train(T._batches(args, data, cfg, False), max_steps=3)
    loss_a = [r["loss"] for r in straight.log.records if "loss" in r]
    loss_b = [r["loss"] for r in second.log.records if "loss" in r]
    require(loss_a[:1] == la[:1] or abs(loss_a[0] - la[0]) < 1e-6, "(f) first loss")
    require(loss_b == loss_a[2:], f"(f) resumed step's loss {loss_b} != straight {loss_a[2:]}")
    a_leaves = dict(tree_leaves_with_path(straight.params))
    require(all(torch.equal(v, a_leaves[k]) for k, v in tree_leaves_with_path(second.params)),
            "(f) adapters after resume differ from the uninterrupted run's")
    require(all(v.double().sum().item() == sums[k] for k, v in tree_leaves_with_path(params)),
            "(f) a base weight changed under LoRA")
    print(f"[8 train] (f) LoRA's first loss equals the base model's ({base_loss:.6f}); "
          f"save after 2 steps, resume, 1 more step: loss {loss_b[0]:.6f} and adapters "
          f"bit-equal to 3 steps straight ({loss_a}); base weights unchanged "
          f"(per-leaf sums) on '{card}'", flush=True)
    if profile:
        it = iter(T._batches(args, data, cfg, False))

        def one_step():
            b = dict(next(it))
            b.pop("_n_tokens")
            step_fn(straight.params, straight.opt_state, params, b)

        wall = _host_ms(one_step, reps=3)
        total_ms, count, sums_k, rows = _device_profile(one_step, reps=1)
        print(f"[profile] one LoRA step, 3B, T 2048, remat: {wall:.0f} ms unprofiled, device "
              f"busy {total_ms:.0f} ms ({100 * total_ms / wall:.0f}%, idle "
              f"{100 - 100 * total_ms / wall:.0f}%), {count} device kernels; by kind (ms): "
              + ", ".join(f"{k} {v:.1f}" for k, v in sums_k.items()) + f" on '{card}'",
              flush=True)
        for ms, n, name in rows[:14]:
            print(f"[profile]   {ms:8.3f} ms  x{n:<5d} {name}", flush=True)
    del straight, first, second, params
    _free()
    shutil.rmtree(root, ignore_errors=True)
    res["total_launches"] = total
    return res


def phase_vit_window_path(dev, card: str) -> dict:
    """Second path of the training slice: the ViT at window_size 224 (3B
    vision width, 32 blocks): windows of 256 patches, so its 28 window
    blocks launch F and its 4 full blocks E. One 1344x1344 image through
    vision_forward, the same forward with both gates forced dense on a
    448x448 image (where dense fits), and one full-finetuning step of the
    ViT under a 4-layer decoder through the multimodal train step."""
    import dataclasses

    from infinitevl_tpu_torch.config import infinitevl_3b
    from infinitevl_tpu_torch.models import vision as V
    from infinitevl_tpu_torch.models.infinitevl import get_rope_index
    from infinitevl_tpu_torch.models.params import init_params
    from infinitevl_tpu_torch.train.step import (
        make_mm_sft_train_step,
        make_optimizer,
        set_trainable,
    )

    base = infinitevl_3b()
    cfg = dataclasses.replace(
        base, vision=dataclasses.replace(base.vision, window_size=224),
        text=dataclasses.replace(base.text, num_hidden_layers=4, layer_types=None))
    _free()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(5)
    in_feat = 3 * 2 * 14 * 14

    def pixels(hw):
        return torch.randn(((hw // 14) ** 2, in_feat), generator=gen, device=dev).to(torch.bfloat16)

    _reset_launches()
    plan = V.get_vision_plan(((1, 96, 96),), cfg.vision)
    require(plan.win_len == 256 and plan.pad_seq == 9216, f"plan {plan.win_len} {plan.pad_seq}")
    px = pixels(1344)
    with torch.no_grad():
        out = V.vision_forward(params["visual"], cfg.vision, px, plan)
        torch.cuda.synchronize()
        ms = _host_ms(lambda: V.vision_forward(params["visual"], cfg.vision, px, plan), reps=3)
    launches = _read_launches(("window_flash_attention", "segment_flash_attention"))
    require(out.shape == (2304, cfg.vision.out_hidden_size) and bool(torch.isfinite(out).all()),
            "ViT output at 1344x1344")
    require(launches["window_flash_attention"] == 28 * 4
            and launches["segment_flash_attention"] == 4 * 4,
            f"ViT launches {launches}")  # 1 + 3 timed forwards
    # against the dense paths on a 448x448 image (S 1,024, 4 windows of 256)
    plan_s = V.get_vision_plan(((1, 32, 32),), cfg.vision)
    px_s = pixels(448)
    with torch.no_grad():
        flash = V.vision_forward(params["visual"], cfg.vision, px_s, plan_s)
        gates = ("FLASH_FULL_ATTN_MIN_SEQ", "WINDOW_FLASH_MIN_SEQ")
        saved = {g: getattr(V, g) for g in gates}
        try:
            for g in gates:
                setattr(V, g, 1 << 30)
            dense = V.vision_forward(params["visual"], cfg.vision, px_s, plan_s)
        finally:
            for g, val in saved.items():
                setattr(V, g, val)
    e = err_ratio(flash, dense)
    require(e <= 5 * BF16_TOL, f"ViT through F and E against the dense paths: {e:.3g}")

    # one training step: every leaf trainable, so F and E carry gradients
    set_trainable(params, lambda path, leaf: True)
    tx = make_optimizer(1e-5)
    state = tx.init(params)
    step = make_mm_sft_train_step(cfg, tx, remat=True)
    rng = np.random.RandomState(0)
    n_img = 9216 // 4
    ids = np.concatenate([rng.randint(0, 1000, 8), [cfg.vision_start_token_id],
                          [cfg.image_token_id] * n_img, [cfg.vision_end_token_id],
                          rng.randint(0, 1000, 32)])[None]
    pos, _ = get_rope_index(cfg, ids, np.asarray(((1, 96, 96),)))
    batch = dict(input_ids=ids, labels=np.where(np.arange(ids.shape[1])[None] > n_img + 9,
                                                ids, -100),
                 position_ids=np.asarray(pos), segment_ids=np.ones_like(ids, dtype=np.int32),
                 pixel_values=px.float().cpu().numpy())
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, loss = step(params, state, batch, ((1, 96, 96),), None)
    loss = float(loss)
    step_s = time.perf_counter() - t0
    train_launches = _read_launches(("window_flash_attention", "segment_flash_attention",
                                     "swa_train_flash_attention", "delta_rule_chunk_fused"))
    require(np.isfinite(loss), f"ViT training step loss {loss}")
    require(train_launches["window_flash_attention"] == 28
            and train_launches["segment_flash_attention"] == 4, f"{train_launches}")
    print(f"[9 vit window 224] ViT 32 blocks x 1280, window_size 224 (win_len 256): one "
          f"1344x1344 image (S 9216) forward {ms:.1f} ms, 28 F + 4 E launches per forward; "
          f"448x448 through F and E against the dense paths err_ratio {e:.3g} (bf16, 32 "
          f"blocks); one full-finetuning step (ViT + 4-layer decoder, {ids.shape[1]} tokens, "
          f"gradients through F and E): loss {loss:.4f}, {step_s:.2f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB on '{card}'", flush=True)
    for k, v in train_launches.items():
        launches[k] = launches.get(k, 0) + v

    # the training step's peak memory at windows of 256 (window_size 224) and
    # 1,024 patches (448), with F's backward recomputing through the chunked
    # twin (window_attention_chunked: one group of windows' scores at a
    # time) and, for comparison, through the batched-dense plain version
    # that it replaced (all [nW, H, L, L] scores and their gradients at once)
    from infinitevl_tpu_torch.ops import vit_kernels
    from infinitevl_tpu_torch.ops.vit_flash import window_attention_reference

    chunked = vit_kernels.window_attention_chunked
    peaks = {}
    for ws in (224, 448):
        cfg_w = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, window_size=ws))
        L = V.get_vision_plan(((1, 96, 96),), cfg_w.vision).win_len
        step_w = make_mm_sft_train_step(cfg_w, tx, remat=True)
        for twin in ("chunked", "dense"):
            if twin == "dense":
                vit_kernels.window_attention_chunked = window_attention_reference
            try:
                _free()
                torch.cuda.reset_peak_memory_stats()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, _, loss_w = step_w(params, state, batch, ((1, 96, 96),), None)
                loss_w = float(loss_w)
                step_w_s = time.perf_counter() - t0
            finally:
                vit_kernels.window_attention_chunked = chunked
            require(np.isfinite(loss_w), f"ViT step at win_len {L} ({twin}): loss {loss_w}")
            peaks[f"L{L}_{twin}"] = dict(peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                                         step_s=step_w_s)
        print(f"[9 vit window] one full-finetuning step at window_size {ws} (win_len {L}, "
              f"{9216 // L} windows of the 1344x1344 image): peak "
              f"{peaks[f'L{L}_chunked']['peak_gb']:.2f} GB and "
              f"{peaks[f'L{L}_chunked']['step_s']:.2f} s with F's backward through the chunked "
              f"twin, {peaks[f'L{L}_dense']['peak_gb']:.2f} GB and "
              f"{peaks[f'L{L}_dense']['step_s']:.2f} s through the batched-dense plain version "
              f"on '{card}'", flush=True)
    del params, state
    _free()
    return launches, peaks


# ---------------------------------------------------------------- distillation


class _Spy:
    """Wraps a module attribute (a function) for the duration of a `with`:
    records every call's result, and runs `check(args, result)` on it.
    With `replace`, that function is called in place of the attribute's."""

    def __init__(self, module, name, check=None, replace=None):
        self.module, self.name, self.check, self.replace = module, name, check, replace
        self.results = []

    def __enter__(self):
        real = self.real = getattr(self.module, self.name)
        call = self.replace or real

        def wrapped(*args, **kw):
            out = call(*args, **kw)
            self.results.append(out)
            if self.check is not None:
                self.check(args, out)
            return out

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def _ptrs(tree) -> set:
    from infinitevl_tpu_torch.train.step import tree_leaves_with_path

    return {t.untyped_storage().data_ptr() for _, t in tree_leaves_with_path(tree)}


def _require_teacher_unchanged(teacher, path: str, cfg, what: str) -> int:
    """Every leaf of the teacher run_dt loaded (and kept) bit-equal to the
    checkpoint on disk; returns the number of leaves compared."""
    from infinitevl_tpu_torch.models.params import load_hf_checkpoint
    from infinitevl_tpu_torch.train.step import tree_leaves_with_path

    fresh = dict(tree_leaves_with_path(load_hf_checkpoint(path, cfg)))
    leaves = list(tree_leaves_with_path(teacher))
    require(len(leaves) == len(fresh) and all(torch.equal(v, fresh[k]) for k, v in leaves),
            f"{what}: the teacher changed")
    del fresh
    _free()
    return len(leaves)


DT_STEPS = 2  # phase 10: the steps of each stage (the script's time budget's)
DT_LAYERS = 4  # phase 10: the teacher's and student's depth, one hybrid period (the script's
#   time budget's)
DT_SHARD_BYTES = 2 * 1024**3  # phase 10: the teacher's shards (at 4 layers 2.58 GB: two)


def _dt_recipe(name: str, args, card: str, expect, teacher_cfg, teacher_dir: str,
               save: bool = True) -> dict:
    """One run_dt call at 3B (as _run_recipe measures it; `save` False:
    Trainer.save replaced), its student and the teacher it loaded, held
    bit-equal to the checkpoint afterwards."""
    from infinitevl_tpu_torch.train import trainer as T

    students = []
    run = (lambda a: students.append(T.run_dt(a))) if save else (
        lambda a: students.append(_trainer_records(T, lambda: T.run_dt(a))[0]))
    with _Spy(T, "load_hf_checkpoint") as loads:
        r = _run_recipe(name, args, card, expect, tag="10 dt", run=run)
    require(len(loads.results) == 1, f"{name}: the teacher was loaded {len(loads.results)} times")
    n_leaves = _require_teacher_unchanged(loads.results[0], teacher_dir, teacher_cfg, name)
    print(f"[10 dt] {name}: the teacher's {n_leaves} leaves bit-equal to its checkpoint after "
          f"the run", flush=True)
    return dict(r, student=students[0], teacher=loads.results[0])


def phase_dt_path(dev, card: str, profile: bool) -> dict:
    """Phase 10: checkpoints and distillation at 3B width, DT_LAYERS deep
    (bf16, random weights from seed 0): the teacher's HF checkpoint written and
    read back, stage 1 of examples/train_3b_stage1.yaml through run_dt,
    stage 2 with the handoff, one multimodal stage-2 step, then the
    distilled student exported and served through the CLI. Files are
    deleted as soon as nothing reads them: the card's machine limits what
    its disk ever held (~45 GB)."""
    import dataclasses
    import os
    import shutil
    import socket
    import tempfile
    import threading

    import infinitevl_tpu_torch.serve.api as api
    from infinitevl_tpu_torch import cli
    from infinitevl_tpu_torch.config import infinitevl_3b
    from infinitevl_tpu_torch.eval.mcq import MCQEvaluator
    from infinitevl_tpu_torch.generation import Generator
    from infinitevl_tpu_torch.hparams import load_yaml_args
    from infinitevl_tpu_torch.models.infinitevl import forward
    from infinitevl_tpu_torch.models.params import (
        init_params,
        load_hf_checkpoint,
        param_count,
    )
    from infinitevl_tpu_torch.ops.swa_kernels import swa_train_flash_attention as h
    from infinitevl_tpu_torch.train import trainer as T
    from infinitevl_tpu_torch.train.distill import make_stage2_step
    from infinitevl_tpu_torch.train.step import (
        make_optimizer,
        set_trainable,
        tree_leaves_with_path,
    )
    from infinitevl_tpu_torch.utils.checkpoint import export_hf_safetensors, latest_step

    here = os.path.dirname(os.path.abspath(__file__))
    full = infinitevl_3b()
    cfg = dataclasses.replace(full, text=dataclasses.replace(
        full.text, num_hidden_layers=DT_LAYERS, layer_types=None))
    tc = cfg.text
    n, n_swa, n_lin = tc.num_hidden_layers, tc.num_swa_layers, tc.num_linear_layers
    teacher_cfg = dataclasses.replace(cfg, text=dataclasses.replace(
        tc, layer_types=("full_attention",) * n))
    total = {}
    real_3b, T.infinitevl_3b = T.infinitevl_3b, lambda: cfg  # run_dt's preset, DT_LAYERS deep

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    root = tempfile.mkdtemp(prefix="ivl_dt_")
    try:
        # 1. the teacher's checkpoint: written in shards of DT_SHARD_BYTES, read back
        t0 = time.perf_counter()
        teacher = init_params(teacher_cfg, torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        n_teacher = param_count(teacher)
        shapes = init_params(cfg, None, "meta")  # the student's shapes, no memory
        n_student = param_count(shapes)
        n_text = param_count(shapes["text"])
        # on disk at once: the teacher and one train state (at most the
        # student's text weights and two moments; stage 1's goes once stage 2
        # has read it)
        need = 2 * (n_teacher + 3 * n_text)
        free = shutil.disk_usage(root).free
        require(free >= need, f"phase 10 needs {need / 1e9:.1f} GB of disk under {root} for "
                              f"the teacher's checkpoint and the train states, "
                              f"{free / 1e9:.1f} GB are free")
        teacher_dir = os.path.join(root, "teacher")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nbytes = export_hf_safetensors(teacher, teacher_cfg, teacher_dir,
                                       max_shard_bytes=DT_SHARD_BYTES)
        t_write = time.perf_counter() - t0
        shards = sorted(f for f in os.listdir(teacher_dir) if f.endswith(".safetensors"))
        require(len(shards) >= 2 and os.path.exists(
            os.path.join(teacher_dir, "model.safetensors.index.json")),
            f"the teacher's checkpoint is not sharded: {shards}")
        t0 = time.perf_counter()
        loaded = load_hf_checkpoint(teacher_dir, teacher_cfg)
        torch.cuda.synchronize()
        t_read = time.perf_counter() - t0
        a, b = dict(tree_leaves_with_path(teacher)), dict(tree_leaves_with_path(loaded))
        require(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a),
                "the teacher's leaves read back are not bit-equal")
        ids = torch.from_numpy(np.random.RandomState(10).randint(0, tc.vocab_size - 8,
                                                                 (1, 64))).to(dev)
        pos = torch.arange(64, device=dev)[None, None].expand(3, 1, 64).contiguous()
        _reset_launches()
        with torch.no_grad():
            la, _ = forward(teacher, teacher_cfg, ids, pos)
            lb, _ = forward(loaded, teacher_cfg, ids, pos)
        launches = _read_launches(("swa_train_flash_attention",))
        require(torch.equal(la, lb), "the teacher's logits differ after the round trip")
        require(launches["swa_train_flash_attention"] == 2 * n,
                f"the teacher's forward launched H {launches['swa_train_flash_attention']} "
                f"times, expected {2 * n} (its full_attention layers, window unbounded)")
        add(launches)
        print(f"[10 dt] teacher checkpoint (InfiniteVL-3B's all-full_attention twin with the "
              f"ViT, {n_teacher / 1e9:.3f} B parameters, bf16, random init in {t_init:.2f} s): "
              f"{nbytes / 1e9:.3f} GB in {len(shards)} shards written in {t_write:.2f} s "
              f"({nbytes / 1e9 / t_write:.2f} GB/s, the card's tensors copied to the host "
              f"included), read to the card in {t_read:.2f} s ({nbytes / 1e9 / t_read:.2f} "
              f"GB/s, from the file system's cache right after the write); every leaf and the "
              f"logits of a 64-token prompt bit-equal (H launched {2 * n} times for the two "
              f"forwards), {free / 1e9:.1f} GB free for {need / 1e9:.1f} GB needed, on "
              f"'{card}'", flush=True)
        del teacher, loaded, a, b, la, lb
        _free()

        # 2. stage 1: the repo's 3B recipe, teacher from step 1's checkpoint
        data_dir = os.path.join(root, "packed")
        _packed_text_dataset(data_dir, n=90)
        base = dict(teacher_model_path=teacher_dir, dataset="demo_packed", dataset_dir=data_dir,
                    logging_steps=1, save_steps=10**6)
        # the recipe's preserved softmax layers (every fourth) that the cut keeps
        keep = [i for i in load_yaml_args(os.path.join(here, "examples", "train_3b_stage1.yaml"))
                .finetune.softmax_attention if i < n]
        base["softmax_attention"] = keep

        def recipe(out, **over):
            args = load_yaml_args(os.path.join(here, "examples", "train_3b_stage1.yaml"))
            for key, val in {**base, "output_dir": os.path.join(root, out), **over}.items():
                group = next(g for g in (args.model, args.data, args.train, args.finetune)
                             if hasattr(g, key))
                setattr(group, key, val)
            return args

        args1 = recipe("stage1", data_parallel=1, max_steps=DT_STEPS)
        rows = T.build_dataset(args1)
        require(len(rows) >= DT_STEPS and all(int(np.asarray(r["segment_ids"]).max()) > 1
                                              for r in rows[:DT_STEPS]),
                f"packing made {len(rows)} rows, not {DT_STEPS} packed rows of 8192")
        full1 = {"swa_train_flash_attention": n + n_swa, "swa_train_flash_attention_bwd": 0,
                 "delta_rule_chunk_fused": n_lin}
        print(f"[10 dt] stage 1: examples/train_3b_stage1.yaml with data_parallel 8 -> 1, "
              f"max_steps {DT_STEPS}, {len(rows)} packed rows of 8192 "
              f"({[int(np.asarray(r['segment_ids']).max()) for r in rows[:DT_STEPS]]} sequences "
              f"in the first {DT_STEPS}), warm-up {args1.train.warmup_steps} steps as the recipe "
              f"has it", flush=True)
        r1 = _dt_recipe("stage 1 (layer MSE x 1000, T 8192)", args1, card, full1,
                        teacher_cfg, teacher_dir)
        add(r1["launches"])
        s1, t1 = r1["student"], r1["teacher"]
        shared = _ptrs(t1)
        frozen = [(k, v) for k, v in tree_leaves_with_path(s1) if not v.requires_grad]
        trained = [(k, v) for k, v in tree_leaves_with_path(s1) if v.requires_grad]
        require(frozen and all(v.untyped_storage().data_ptr() in shared for _, v in frozen),
                "stage 1: a frozen student leaf is not the teacher's own (unchecked)")
        require(all(v.untyped_storage().data_ptr() not in shared for _, v in trained),
                "stage 1: a trained student leaf aliases the teacher")
        require(all(k.split("/")[1] not in {str(i) for i in args1.finetune.softmax_attention}
                    for k, _ in trained), "stage 1: a preserved layer's leaf trained")
        print(f"[10 dt] stage 1: {len(trained)} trained leaves (the {n_lin} converted layers' "
              f"mixers, none aliasing the teacher); {len(frozen)} frozen leaves (preserved "
              f"layers, MLPs, norms, embeddings), every one the teacher's own tensor, so "
              f"bit-unchanged with it", flush=True)
        if profile:
            _profile_stage1(args1, s1, t1["text"], teacher_cfg.text, tc, card)
        del s1, t1, r1, shared, frozen, trained
        _free()
        ckpt1 = os.path.join(root, "stage1", "checkpoints")
        require(latest_step(ckpt1) == DT_STEPS,
                f"stage 1 saved no step-{DT_STEPS} train state: {ckpt1}")

        # 3. stage 2 with the handoff from stage 1, then one multimodal step
        soft = set(args1.finetune.softmax_attention)
        held = {}

        def check_handoff(margs, merged):
            """The merged student: the preserved layers' attention as the fresh
            conversion has it (the teacher's tensors), all else stage 1's. Stage
            1's train state is read by now: its files go before stage 2 writes
            its own (the card's machine limits what its disk ever held)."""
            base_tree, update = margs
            kept = ("mlp", "input_norm", "post_norm")
            for i, lp in enumerate(merged["layers"]):
                for key, leaf in lp.items():
                    pristine = i in soft and key not in kept
                    src = (base_tree if pristine else update)["layers"][i][key]
                    held["pristine"] = held.get("pristine", 0) + pristine
                    for (_, x), (_, y) in zip(tree_leaves_with_path(leaf),
                                              tree_leaves_with_path(src)):
                        require(torch.equal(x, y), f"handoff: layer {i} {key}")
            shutil.rmtree(os.path.join(root, "stage1"))

        args2 = recipe("stage2", data_parallel=1, max_steps=DT_STEPS, distill_stage=2,
                       cutoff_len=2048, checkpoint_path=ckpt1)
        full2 = {"swa_train_flash_attention": n + n_swa,
                 "swa_train_flash_attention_bwd": n_swa, "delta_rule_chunk_fused": n_lin}
        with _Spy(T, "merge_params", check_handoff) as merges:
            # nothing reads stage 2's train state: Trainer.save replaced
            r2 = _dt_recipe("stage 2 (logit KL at T 2 + CE, T 2048, from stage 1's state, no "
                            "train state written)", args2, card, full2, teacher_cfg, teacher_dir,
                            save=False)
        require(len(merges.results) == 1 and held.get("pristine") == 4 * len(soft),
                f"stage 2: the handoff merged {len(merges.results)} times, kept "
                f"{held.get('pristine')} preserved attention leaves as the teacher's")
        add(r2["launches"])
        s2 = r2["student"]
        shared = _ptrs(r2["teacher"])
        # (the handoff's leaves are the train state's own tensors, inv_freq too)
        require(all(v.requires_grad == (k != "inv_freq")
                    and (k == "inv_freq" or v.untyped_storage().data_ptr() not in shared)
                    for k, v in tree_leaves_with_path(s2)),
                "stage 2: a student leaf is frozen or aliases the teacher")
        print(f"[10 dt] stage 2: the handoff kept the {len(soft)} preserved layers' attention "
              f"({held['pristine']} weights) as the teacher's and took stage 1's mixers; every "
              f"student leaf but rope's inv_freq trained on its own copy", flush=True)
        teacher_full = r2["teacher"]
        del r2, shared
        shutil.rmtree(os.path.join(root, "stage2"))
        _free()

        # one stage-2 step of the student on a multimodal row at 448x448, by
        # hand (the step function run_dt builds; no train state written)
        mm = dict(dataset="mllm_demo", dataset_dir=os.path.join(here, "data"), max_samples=1,
                  image_min_pixels=448 * 448, image_max_pixels=448 * 448, packing=False)
        args3 = recipe("mm", data_parallel=1, max_steps=1, distill_stage=2, cutoff_len=512, **mm)
        rows3 = T.build_dataset(args3, cfg=cfg)
        require(T.is_multimodal(rows3) and tuple(rows3[0]["image_grid_thw"][0]) == (1, 32, 32),
                f"the multimodal row: {rows3[0].get('image_grid_thw')}")
        batch, grids, vgrids = next(iter(T._batches(args3, rows3, cfg, True)))
        batch.pop("_n_tokens")
        tx = make_optimizer(args3.train.learning_rate)
        step3 = make_stage2_step(tc, teacher_cfg.text, tx, args3.finetune.distill_temperature,
                                 full_cfg=cfg)
        state3 = tx.init(s2)
        _free()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, loss3 = step3(s2, state3, teacher_full, batch, grids, vgrids)
        torch.cuda.synchronize()
        t_mm = time.perf_counter() - t0
        launches = _read_launches(("segment_flash_attention", "window_flash_attention"))
        launches["swa_train_flash_attention_bwd"] = h.launches_bwd
        expect3 = dict(full2, segment_flash_attention=4, window_flash_attention=28)
        require(all(launches[k] == v for k, v in expect3.items()) and np.isfinite(float(loss3)),
                f"the multimodal stage-2 step: loss {float(loss3)}, launches {launches}, "
                f"expected {expect3}")
        add(launches)
        n_leaves = _require_teacher_unchanged(teacher_full, teacher_dir, teacher_cfg,
                                              "the multimodal step")
        print(f"[10 dt] one stage-2 step on a multimodal row (448x448: 1,024 patches, 256 "
              f"image tokens, {len(batch['input_ids'][0])} positions; the frozen ViT run once "
              f"for both models): loss {float(loss3):.6f}, {t_mm * 1e3:.0f} ms (the first "
              f"multimodal step), peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
              f"GB, launches H fwd {launches['swa_train_flash_attention']} bwd "
              f"{h.launches_bwd}, C {launches['delta_rule_chunk_fused']}, E "
              f"{launches['segment_flash_attention']}, F {launches['window_flash_attention']}; "
              f"the teacher's {n_leaves} leaves bit-equal to its checkpoint on '{card}'",
              flush=True)
        visual = teacher_full["visual"]
        student_full = {"text": s2, "visual": visual}
        set_trainable(student_full, lambda path, leaf: False)  # serving from here on
        del state3, step3, teacher_full, batch, loss3
        _free()

        # 4. serve what was distilled
        student_dir, export_dir = os.path.join(root, "student"), os.path.join(root, "export")
        export_hf_safetensors(student_full, cfg, student_dir)
        shutil.rmtree(teacher_dir)

        def yaml_file(name, **conf):
            path = os.path.join(root, f"{name}.yaml")
            with open(path, "w") as f:
                f.write("".join(f"{k}: {json.dumps(v)}\n" for k, v in conf.items()))
            return path

        _reset_launches()
        cli.cmd_export(yaml_file("export", model_name_or_path=student_dir,
                                 output_dir=export_dir))
        shutil.rmtree(student_dir)
        args_e = load_yaml_args(yaml_file("serve", model_name_or_path=export_dir))
        gen_e, cfg_e = cli._build_generator(args_e)
        require(cfg_e == cfg, "the exported config.json reads back to another config")
        mem = dict(tree_leaves_with_path(student_full))
        off = [k for k, v in tree_leaves_with_path(gen_e.params) if not torch.equal(v, mem[k])]
        require(not off and len(mem) == len(list(tree_leaves_with_path(gen_e.params))),
                f"the exported student's leaves differ from the in-memory student's: {off[:5]}")
        prompt = np.random.RandomState(11).randint(0, tc.vocab_size - 8, (1, 50))
        want = Generator(student_full, cfg).generate(prompt, max_new_tokens=32,
                                                     temperature=0.0, eos_token_id=-1)
        got = gen_e.generate(prompt, max_new_tokens=32, temperature=0.0, eos_token_id=-1)
        require(got.shape == (1, 32) and np.array_equal(got, want),
                f"the exported student's greedy tokens differ from the in-memory student's: "
                f"{got.tolist()} vs {want.tolist()}")
        del gen_e, student_full, s2, visual
        _free()
        print(f"[10 dt] cli export: the student ({n_student / 1e9:.3f} B parameters) through "
              f"cmd_export into HF safetensors + Modelfile ({sorted(os.listdir(export_dir))[:4]}"
              f"...); _build_generator from it: every leaf bit-equal and 32 greedy tokens of a "
              f"50-token prompt identical to the in-memory student's", flush=True)

        # the MCQ evaluator through cmd_eval: left-padded buckets against each
        # prompt alone, no pads. In fp32 (bf16: false), so the two differ by
        # the order of fp32 sums and not by bf16 rounding along two layouts
        scored = []

        def record(margs, out):
            scored.append((margs[0], list(margs[1]), out))

        conf = dict(config_preset="infinitevl_3b", model_name_or_path=export_dir,
                    dataset="mcq_demo", dataset_dir=os.path.join(here, "data"), n_shot=3,
                    eval_batch_size=4, eval_save_dir=os.path.join(root, "eval"), bf16=False)
        ref = load_yaml_args(os.path.join(here, "examples", "eval_mcq.yaml"))
        require((ref.data.dataset, ref.eval.n_shot, ref.eval.eval_batch_size)
                == ("mcq_demo", 3, 4), "examples/eval_mcq.yaml changed")
        t0 = time.perf_counter()
        with _Spy(MCQEvaluator, "choice_logits", record):
            metrics = cli.cmd_eval(yaml_file("eval", **conf))
        t_eval = time.perf_counter() - t0
        launches = _read_launches(("swa_train_flash_attention", "delta_rule_chunk_fused"))
        add(launches)
        ev = scored[0][0]
        gap, n_prompts, lens = 0.0, 0, []
        for _, prompts, padded in scored:
            for p, row in zip(prompts, padded):
                ids = np.asarray(ev.tokenizer.encode(p, add_special_tokens=False))[None]
                lens.append(ids.shape[1])
                t = torch.from_numpy(ids).to(dev)
                pos = torch.arange(ids.shape[1], device=dev)[None, None].expand(3, 1, -1)
                with torch.no_grad():
                    alone, _ = forward(ev.generator.params, ev.generator.cfg, t,
                                       pos.contiguous(), logits_to_keep=1)
                alone = alone[0, 0, ev.choice_ids].cpu().numpy()
                require(int(np.argmax(alone)) == int(np.argmax(row)),
                        f"MCQ: the padded prediction differs from the prompt alone "
                        f"({row} vs {alone})")
                gap = max(gap, float(np.abs(alone - row).max()))
                n_prompts += 1
        del ev, scored
        _free()
        print(f"[10 dt] cli eval on examples/eval_mcq.yaml (preset 3B, the exported student, "
              f"data/mcq_demo.json 3-shot, batches of 4, left-padded to buckets of 128, "
              f"fp32): "
              f"{metrics} in {t_eval:.1f} s; {n_prompts} prompts of {min(lens)}-{max(lens)} "
              f"tokens, every padded prediction equal to the prompt's alone without pads, "
              f"largest choice-logit gap {gap:.2e}; launches H "
              f"{launches['swa_train_flash_attention']}, C {launches['delta_rule_chunk_fused']} "
              f"on '{card}'", flush=True)

        # cmd_api: one request on a loopback port
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        servers = []
        _reset_launches()
        with _Spy(api, "create_server") as made:
            th = threading.Thread(target=cli.cmd_api,
                                  args=(yaml_file("api", model_name_or_path=export_dir,
                                                  max_new_tokens=16), port), daemon=True)
            th.start()
            t0 = time.perf_counter()
            while not made.results and time.perf_counter() - t0 < 300 and th.is_alive():
                time.sleep(0.2)
            servers = list(made.results)
        require(servers, "cmd_api started no server")
        try:
            status, body = _http(port, {"messages": [{"role": "user", "content":
                                                      "Say hello to the distilled student."}],
                                        "max_tokens": 16, "temperature": 0.0})
        finally:
            for srv in servers:
                srv.shutdown()
                srv.server_close()
            th.join(timeout=60)
        require(not th.is_alive(), "cmd_api's server thread did not stop")
        require(status == 200 and body["choices"][0]["message"]["content"] is not None,
                f"cmd_api request: {status} {body}")
        launches = _read_launches(("swa_ring_flash_attention", "swa_ring_flash_decode_stacked",
                                   "delta_step_fused_stacked"))
        add(launches)
        print(f"[10 dt] cli api on 127.0.0.1:{port}: one chat request answered "
              f"({body.get('usage')}), the server stopped; launches A1 "
              f"{launches['swa_ring_flash_attention']}, A2 "
              f"{launches['swa_ring_flash_decode_stacked']}, B "
              f"{launches['delta_step_fused_stacked']}", flush=True)
    finally:
        T.infinitevl_3b = real_3b
        shutil.rmtree(root, ignore_errors=True)
        _free()
    total.setdefault("swa_train_flash_attention_bwd", 0)
    return total


# ---------------------------------------------------------------- preference stages


def _pref_datasets(root: str) -> None:
    """A dataset directory built from data/demo.json's rows, each answer
    repeated to 600-980 words (the word-level tokenizer gives about a token
    a word): `pref_long` pairs (prompt = a row's instruction, chosen = its
    output, rejected = the next row's output), `kto_long` rows tagged
    desirable and not in turn, and `ppo_prompts`, 12 instructions followed
    by 300 words (cut at cutoff_len, so every prompt has its length)."""
    import os

    demo = json.load(open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                       "data", "demo.json")))
    words = [ex["output"].split() for ex in demo]
    rng = np.random.RandomState(11)
    n = len(demo)

    def rep(ws, m):
        return " ".join(ws[j % len(ws)] for j in range(m))

    sets = {"pref_long": [], "kto_long": [], "ppo_prompts": []}
    for i, ex in enumerate(demo):
        sets["pref_long"].append({
            "instruction": ex["instruction"], "input": "",
            "chosen": rep(words[i], int(rng.randint(600, 980))),
            "rejected": rep(words[(i + 1) % n], int(rng.randint(600, 980)))})
        sets["kto_long"].append({"instruction": ex["instruction"], "input": "",
                                 "output": rep(words[i], int(rng.randint(600, 980))),
                                 "kto_tag": i % 2 == 0})
    for i in range(12):
        sets["ppo_prompts"].append({
            "instruction": demo[i % n]["instruction"] + " "
            + rep(words[(3 * i) % n] + words[(3 * i + 1) % n], 300),
            "input": "", "output": demo[i % n]["output"]})
    os.makedirs(root, exist_ok=True)
    info = {}
    for name, rows in sets.items():
        with open(os.path.join(root, f"{name}.json"), "w") as f:
            json.dump(rows, f)
        info[name] = {"file_name": f"{name}.json", "formatting": "alpaca",
                      **({"ranking": True} if name == "pref_long" else {})}
    with open(os.path.join(root, "dataset_info.json"), "w") as f:
        json.dump(info, f)


def _checksum(tree) -> dict:
    """Per leaf, the sum and the sum of squares of its bit patterns as
    int64: a leaf changed in place changes them."""
    from infinitevl_tpu_torch.train.step import tree_leaves_with_path

    out = {}
    for k, v in tree_leaves_with_path(tree):
        bits = v.detach().contiguous().view(
            {1: torch.int8, 2: torch.int16, 4: torch.int32}[v.element_size()]).long()
        out[k] = (int(bits.sum()), int((bits * bits).sum()))
        del bits
    return out


def _pref_stage(name: str, args, card: str, expect: dict, positions: int) -> dict:
    """One preference stage through run_exp at 3B (measured as
    _run_recipe measures it), with Trainer.save replaced (no train state is
    written); the frozen reference's checksum after frozen_copy and after
    the run, and the log-probs of each sequence_logprobs call."""
    from infinitevl_tpu_torch.train import dpo as D
    from infinitevl_tpu_torch.train import trainer as T

    sums, saves = [], []

    with _Spy(T, "frozen_copy", lambda a, out: sums.append((out, _checksum(out)))), \
            _Spy(T.Trainer, "save", replace=lambda trainer: saves.append(trainer.step)), \
            _Spy(D, "sequence_logprobs") as lps:
        r = _run_recipe(name, args, card, expect, run=T.run_exp, tag="11 pref",
                        positions=positions)
    require(saves == [args.train.max_steps], f"{name}: Trainer.save called at steps {saves}")
    print(f"[11 pref] {name}: Trainer.save was replaced, so the time above holds no "
          f"train-state write", flush=True)
    r["logps"] = [t.detach().float().cpu() for t in lps.results]
    r["references"] = len(sums)
    r["ref_unchanged"] = None
    if sums:
        ref, before = sums[0]
        r["ref_unchanged"] = _checksum(ref) == before
        r["ref_leaves"] = len(before)
        require(r["ref_unchanged"], f"{name}: the frozen reference changed")
    del sums, lps
    _free()
    return r


PREF_STEPS = 2  # phase 11: the steps of each stage (the script's time budget's)


PREF_LAYERS = 4  # phase 11: the depth of every stage (the script's time budget's)


def phase_pref_path(dev, card: str) -> dict:
    """Phase 11: the preference stages at 3B width through run_exp (bf16,
    random weights from seed 0, remat): rm, dpo (sigmoid and orpo) and kto at
    PREF_LAYERS layers, cutoff 1,024, two pairs (rows) a step, PREF_STEPS
    each, no train state written; then rm from a PREF_LAYERS-layer checkpoint
    with its train state saved, and ppo (fp32) at that depth from that
    checkpoint, scored by that reward model: prompts of 256 tokens, B 4, 64
    sampled tokens, 3 iterations. Launches per step held to the code's
    count, the reference bit-unchanged. Files go as soon as nothing reads
    them (the card's machine limits what its disk ever held)."""
    import dataclasses
    import os
    import shutil
    import tempfile

    from infinitevl_tpu_torch.config import infinitevl_3b
    from infinitevl_tpu_torch.models.params import init_text_params, param_count
    from infinitevl_tpu_torch.ops.swa_kernels import swa_train_flash_attention as h
    from infinitevl_tpu_torch.train import ppo as P
    from infinitevl_tpu_torch.train import trainer as T
    from infinitevl_tpu_torch.utils.checkpoint import export_hf_safetensors, latest_step

    cfg = infinitevl_3b()
    tc = cfg.text
    cfg_p = dataclasses.replace(cfg, text=dataclasses.replace(
        tc, num_hidden_layers=PREF_LAYERS, layer_types=None))
    total, res = {}, {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def expect(text_cfg, sides, refs):
        """Launches a step of policy sides with remat (forward + recompute)
        and reference forwards: H and C a layer each, H's backward a side."""
        return {"swa_train_flash_attention": (2 * sides + refs) * text_cfg.num_swa_layers,
                "swa_train_flash_attention_bwd": sides * text_cfg.num_swa_layers,
                "delta_rule_chunk_fused": (2 * sides + refs) * text_cfg.num_linear_layers}

    root = tempfile.mkdtemp(prefix="ivl_pref_")
    try:
        n_p = param_count(init_text_params(cfg_p.text, None, "meta"))
        # on disk at once: the cut model's checkpoint (bf16 text) and its
        # reward model's train state (weights and two bf16 moments)
        need = 2 * n_p + 3 * 2 * (n_p + tc.hidden_size)
        free = shutil.disk_usage(root).free
        require(free >= need, f"phase 11 needs {need / 1e9:.1f} GB of disk under {root}, "
                              f"{free / 1e9:.1f} GB are free")
        data_dir = os.path.join(root, "data")
        _pref_datasets(data_dir)
        B, cutoff = 2, 1024
        common = dict(dataset_dir=data_dir, cutoff_len=cutoff, per_device_train_batch_size=B,
                      max_steps=PREF_STEPS, remat=True, learning_rate=1e-5, save_steps=10**6)
        rows = T.build_preference_dataset(_train_args(root, stage="rm", dataset="pref_long",
                                                      **common))
        lens = sorted(len(r[k]) for r in rows for k in ("chosen_ids", "rejected_ids"))
        require(len(rows) == 8 and 600 <= lens[0] and lens[-1] <= cutoff,
                f"the pairs are {lens} tokens long, not 600-{cutoff}")
        print(f"[11 pref] {len(rows)} preference pairs of {lens[0]}-{lens[-1]} tokens "
              f"(data/demo.json's answers repeated), padded to {cutoff}; {B} pairs a step, "
              f"{free / 1e9:.1f} GB of disk free for {need / 1e9:.1f} GB needed", flush=True)
        pair_pos, kto_pos = 2 * B * cutoff, B * cutoff
        real_3b, T.infinitevl_3b = T.infinitevl_3b, lambda: cfg_p  # (a)-(d) at PREF_LAYERS
        tc = cfg_p.text

        res["rm"] = r = _pref_stage(
            f"(a) rm, {tc.num_hidden_layers} layers, remat, cutoff {cutoff}, {B} pairs", _train_args(
                os.path.join(root, "rm"), stage="rm", dataset="pref_long", **common),
            card, expect(tc, 2, 0), pair_pos)
        add(r["launches"])
        res["dpo"] = r = _pref_stage(
            f"(b) dpo sigmoid, {tc.num_hidden_layers} layers", _train_args(
                os.path.join(root, "dpo"), stage="dpo", dataset="pref_long", pref_loss="sigmoid",
                **common), card, expect(tc, 2, 2), pair_pos)
        add(r["launches"])
        lp = r["logps"]  # step 1: reference chosen / rejected, then the policy's
        same = [torch.equal(lp[0], lp[2]), torch.equal(lp[1], lp[3])]
        require(r["references"] == 1 and abs(r["losses"][0] - float(np.log(2))) <= 1e-5,
                f"dpo: first loss {r['losses'][0]}, not ln 2; {r['references']} references")
        require(all(same), f"dpo: the policy's first log-probs {lp[2:4]} differ from its "
                           f"clone's {lp[:2]} (bit-equal: {same})")
        print(f"[11 pref] dpo: the first loss {r['losses'][0]:.7f} (ln 2 = {np.log(2):.7f}); "
              f"the policy's and its frozen clone's log-probs bit-equal at step 1 "
              f"({lp[2].tolist()}, {lp[3].tolist()}); the clone's {r['ref_leaves']} leaves "
              f"bit-unchanged after {PREF_STEPS} steps (checksums)", flush=True)
        res["orpo"] = r = _pref_stage(
            f"(c) dpo orpo (no reference), {tc.num_hidden_layers} layers", _train_args(
                os.path.join(root, "orpo"), stage="dpo", dataset="pref_long", pref_loss="orpo",
                **common), card, expect(tc, 2, 0), pair_pos)
        add(r["launches"])
        require(r["references"] == 0, f"orpo built {r['references']} references")
        res["kto"] = r = _pref_stage(
            f"(d) kto, {tc.num_hidden_layers} layers, {B} rows", _train_args(
                os.path.join(root, "kto"), stage="kto", dataset="kto_long", **common),
            card, expect(tc, 1, 1), kto_pos)
        add(r["launches"])
        lp = r["logps"]
        require(r["references"] == 1 and abs(r["losses"][0] - 0.5) <= 1e-5
                and torch.equal(lp[0], lp[1]),
                f"kto: first loss {r['losses'][0]}, not 0.5, or the log-probs differ")
        print(f"[11 pref] orpo built no reference; kto: the first loss {r['losses'][0]:.7f} "
              f"(0.5), log-probs bit-equal to the clone's at step 1, the clone's "
              f"{r['ref_leaves']} leaves bit-unchanged after {PREF_STEPS} steps", flush=True)

        T.infinitevl_3b = real_3b
        # (e) the cut model: its checkpoint, the reward model on it (train
        # state saved), then ppo from both
        ckpt = os.path.join(root, "ckpt")
        text_p = init_text_params(cfg_p.text, torch.Generator(device=dev).manual_seed(0), dev,
                                  torch.bfloat16)
        export_hf_safetensors({"text": text_p}, cfg_p, ckpt)
        del text_p
        _free()
        args = _train_args(os.path.join(root, "rm_e"), stage="rm", dataset="pref_long",
                           model_name_or_path=ckpt, **common)
        require(T.build_config(args) == cfg_p, "the cut model's checkpoint reads back to another "
                                               "config")
        res["rm_saved"] = r = _run_recipe(
            f"(e) rm, {PREF_LAYERS} layers ({n_p / 1e9:.3f} B parameters), train state saved", args, card,
            expect(cfg_p.text, 2, 0), run=T.run_exp, tag="11 pref", positions=pair_pos)
        add(r["launches"])
        rm_ckpt = os.path.join(root, "rm_e", "checkpoints")
        require(latest_step(rm_ckpt) == PREF_STEPS,
                f"rm at {PREF_LAYERS} layers saved no step-{PREF_STEPS} state: {rm_ckpt}")
        state_gb = sum(e.stat().st_size for e in os.scandir(rm_ckpt)) / 1e9

        R, B_ppo, T_p, iters = 64, 4, 256, 3
        args = _train_args(os.path.join(root, "ppo"), stage="ppo", dataset="ppo_prompts",
                           dataset_dir=data_dir, model_name_or_path=ckpt,
                           reward_model_path=rm_ckpt, cutoff_len=T_p,
                           per_device_train_batch_size=B_ppo, max_steps=iters,
                           ppo_rollout_len=R, temperature=1.0, learning_rate=1e-5)
        roll_ms, sums = [], []
        real_rollout = P.make_rollout

        def timed_rollout(*a, **kw):
            rollout = real_rollout(*a, **kw)

            def timed(*args_):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = rollout(*args_)
                torch.cuda.synchronize()
                roll_ms.append((time.perf_counter() - t0) * 1e3)
                require(out[0].shape == (B_ppo, R), f"rollout tokens {tuple(out[0].shape)}")
                return out

            return timed

        _free()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        with _Spy(P, "make_rollout", replace=timed_rollout), \
                _Spy(T, "frozen_copy", lambda a, out: sums.append((out, _checksum(out)))):
            policy, stats = T.run_exp(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        shutil.rmtree(os.path.join(root, "rm_e"))  # read: the reward model is on the card
        launches = _read_launches(("swa_ring_flash_attention", "swa_ring_flash_decode_stacked",
                                   "delta_step_fused_stacked", "delta_rule_chunk_fused",
                                   "swa_train_flash_attention"))
        launches["swa_train_flash_attention_bwd"] = h.launches_bwd
        add(launches)
        peak = torch.cuda.max_memory_allocated() / 1e9
        n_swa, n_lin = cfg_p.text.num_swa_layers, cfg_p.text.num_linear_layers
        # per iteration: the prefill (A1, C), R decode steps (A2, B), the reward
        # model's forward, the policy's and the reference's scoring forwards and
        # the update's (H, C), the update's backward (H)
        per = {"swa_ring_flash_attention": n_swa, "swa_ring_flash_decode_stacked": R * n_swa,
               "delta_step_fused_stacked": R * n_lin, "delta_rule_chunk_fused": 5 * n_lin,
               "swa_train_flash_attention": 4 * n_swa, "swa_train_flash_attention_bwd": n_swa}
        got = {k: launches[k] for k in per}
        require(got == {k: v * iters for k, v in per.items()},
                f"ppo: launches {got}, expected {per} x {iters} iterations")
        require(len(stats) == iters and all(np.isfinite([s.loss, s.kl, s.mean_reward]).all()
                                            for s in stats), f"ppo: stats {stats}")
        require(stats[0].kl == 0.0, f"ppo: the first iteration's KL is {stats[0].kl}, not 0")
        ref, before = sums[0]
        require(len(sums) == 1 and _checksum(ref) == before, "ppo: the reference changed")
        recs = [json.loads(line) for line in open(os.path.join(root, "ppo",
                                                               "trainer_log.jsonl"))]
        it_ms = np.diff([r_["elapsed_s"] for r_ in recs]) * 1e3
        step_ms = float(np.median(it_ms))
        roll = float(np.median(roll_ms[1:]))
        res["ppo"] = dict(step_ms=step_ms, rollout_ms=roll, peak_gb=peak, launches=launches,
                          positions_s=B_ppo * (T_p + R) / step_ms * 1e3,
                          tokens_s=B_ppo * R / roll * 1e3, stats=[dataclasses.asdict(s)
                                                                  for s in stats])
        print(f"[11 pref] (e) ppo, {PREF_LAYERS} layers, fp32, from the {PREF_LAYERS}-layer "
              f"checkpoint and the reward "
              f"model's train state ({state_gb:.2f} GB, deleted once read): {iters} iterations "
              f"of B {B_ppo} prompts of {T_p} tokens, {R} tokens sampled at temperature 1.0; "
              f"stats {[(round(s.loss, 6), round(s.mean_reward, 4), round(s.kl, 6)) for s in stats]} "
              f"(loss, reward, KL; the first KL 0); {step_ms:.0f} ms per iteration (median of "
              f"iterations 2..), of it the rollout {roll:.0f} ms ({B_ppo * R / roll * 1e3:.0f} "
              f"sampled tok/s); {B_ppo * (T_p + R) / step_ms * 1e3:.0f} scored positions/s; "
              f"peak memory {peak:.2f} GB; whole call {wall:.1f} s (weights, both checkpoints "
              f"read); the reference's {len(before)} leaves bit-unchanged; launches per "
              f"iteration A1 {got['swa_ring_flash_attention'] // iters}, A2 "
              f"{got['swa_ring_flash_decode_stacked'] // iters}, B "
              f"{got['delta_step_fused_stacked'] // iters}, C "
              f"{got['delta_rule_chunk_fused'] // iters}, H fwd "
              f"{got['swa_train_flash_attention'] // iters} bwd "
              f"{got['swa_train_flash_attention_bwd'] // iters} on '{card}'", flush=True)
        del policy, stats, sums, ref
    finally:
        shutil.rmtree(root, ignore_errors=True)
        _free()
    total.setdefault("swa_train_flash_attention_bwd", 0)
    res["total_launches"] = total
    return res


def _profile_stage1(args, student, teacher_text, teacher_cfg, tc, card: str) -> None:
    """Where one stage-1 step's time goes at 3B, T 8192 (one packed row):
    wall time without the profiler, device busy, kernels by kind."""
    from infinitevl_tpu_torch.train import trainer as T
    from infinitevl_tpu_torch.train.distill import make_stage1_step
    from infinitevl_tpu_torch.train.step import make_optimizer

    tx = make_optimizer(1e-4)
    # the converted 3B student's config is the deployed one (tc)
    step = make_stage1_step(tc, teacher_cfg, tx, args.finetune.mse_factor)
    state = tx.init(student)
    data = T.build_dataset(args)
    batch = next(iter(T._batches(args, data, T.build_config(args), False)))
    batch.pop("_n_tokens")

    def one_step():
        step(student, state, teacher_text, dict(batch))

    wall = _host_ms(one_step, reps=2)
    total_ms, count, sums_k, rows = _device_profile(one_step, reps=1)
    print(f"[profile] one stage-1 step, 3B, T 8192 packed: {wall:.0f} ms unprofiled, device "
          f"busy {total_ms:.0f} ms ({100 * total_ms / wall:.0f}%, idle "
          f"{100 - 100 * total_ms / wall:.0f}%), {count} device kernels; by kind (ms): "
          + ", ".join(f"{k} {v:.1f}" for k, v in sums_k.items()) + f" on '{card}'", flush=True)
    for ms, n, name in rows[:14]:
        print(f"[profile]   {ms:8.3f} ms  x{n:<5d} {name}", flush=True)



def _device_profile(fn, reps: int = 3, spans=None):
    """Device time of fn() from torch.profiler, per call: (total ms, kernel
    count, ms by kind, [(ms, count, name)] by kernel). `total` sums kernel
    times; a `spans` list is filled with every kernel's (start us, end us,
    name), for the time covered where kernels overlap (a combine launched
    early waits inside its own span).

    A session has been seen to record one kernel too few (5 of C's 6 over
    three calls) and too few of B's 3 (0 a call), so each session first
    runs torch's spin kernel, which no measured function launches, and
    leaves it out of the counts. A session that recorded fewer kernels
    than calls lost some, and is taken again (at most twice); what the
    last session saw is returned either way, for the caller's checks."""
    from torch.profiler import ProfilerActivity, profile

    kinds = {"C delta_chunk": ("delta_chunk",), "A1 swa_prefill": ("swa_prefill",),
             "H swa_train": ("swa_train",), "E/F vit_flash": ("vit_flash",),
             "G int4_matmul": ("int4_",), "A2 swa_decode": ("swa_decode",),
             "B delta_step": ("delta_step",),
             "GEMM": ("gemm", "cutlass", "cublas", "xmma", "nvjet"),
             "copies and casts": ("copy_kernel",), "other": ()}
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=acts) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        sums = dict.fromkeys(kinds, 0.0)
        count, rows = 0, []
        for ev in prof.key_averages():
            dev_us = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
            if "spin_kernel" in ev.key:
                continue
            if ev.device_type.name == "CUDA" or (dev_us and ev.cpu_time_total == 0):
                name = ev.key.lower()
                kind = next((k for k, pats in kinds.items() if any(p in name for p in pats)),
                            "other")
                sums[kind] += dev_us / 1e3 / reps
                count += ev.count
                rows.append((dev_us / 1e3 / reps, ev.count // reps, ev.key[:90]))
        if count >= reps:
            break
        print(f"[profile] session {attempt + 1} recorded {count} device kernels over "
              f"{reps} calls; tracing again", flush=True)
    if spans is not None:
        spans.extend(sorted((ev.time_range.start, ev.time_range.end, ev.name.lower())
                            for ev in prof.events()
                            if ev.device_type.name == "CUDA" and "spin_kernel" not in ev.name))
    return sum(sums.values()), count // reps, sums, sorted(rows, reverse=True)


def _covered_ms(spans, pat: str = "", reps: int = 3) -> float:
    """Time covered by the sorted kernel spans whose name holds `pat`, per call."""
    total, end = 0.0, float("-inf")
    for a, b, name in spans:
        if pat in name and b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3 / reps


def _profile_decode_step(params, cfg, state, token, card: str) -> None:
    """Where one bf16 decode step's time goes at 3B with the ring full: wall
    time without the profiler, device busy, device kernels, and the device
    time of A2 (9 SWA layers) and B (27 DeltaNet layers) by kernel. Each
    step advances `state` in place."""
    from infinitevl_tpu_torch.generation import decode_step

    dev = state["swa_k"].device
    tok = torch.as_tensor(token, device=dev)
    zero = torch.zeros((1, 1), dtype=torch.long, device=dev)
    step = lambda: decode_step(params, cfg, tok, zero, state)
    wall = _host_ms(step)
    spans = []
    total, count, sums, rows = _device_profile(step, spans=spans)
    busy = _covered_ms(spans)
    by = lambda pat: ", ".join(f"{name[:60]} {ms:.4f} ms x{n}" for ms, n, name in rows
                               if pat in name.lower())
    print(f"[profile] one bf16 decode step at 3B (B 1, cum_len {state['cum_len']}, the ring "
          f"full): {wall:.2f} ms unprofiled, device busy {busy:.3f} ms covered by kernels "
          f"({100 * busy / wall:.0f}%, idle {100 - 100 * busy / wall:.0f}%; kernel times "
          f"summed {total:.3f}), {count} device kernels; by kind (ms, summed): "
          + ", ".join(f"{k} {v:.3f}" for k, v in sums.items())
          + f"; A2 covers {_covered_ms(spans, 'swa_decode'):.4f} ms, by kernel: "
          f"{by('swa_decode')}; B covers {_covered_ms(spans, 'delta_step'):.4f} ms, by "
          f"kernel: {by('delta_step')} on '{card}'", flush=True)
    for ms, n, name in rows[:12]:
        print(f"[profile]   {ms:8.4f} ms  x{n:<5d} {name}", flush=True)


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


def _profile_ask(eng, question, card: str) -> None:
    """Device kernels of one `ask` (its prompt through the DeltaNet layers'
    recurrence, T <= 64, then 16 decode steps), and how many of them the
    recurrence launches: its calls counted in the ask, and one call at the
    ask's shape profiled alone."""
    from infinitevl_tpu_torch.ops import delta_rule as dr

    seen, plain = [], dr.delta_rule_recurrent

    def counted(*args, **kw):
        seen.append((args, kw))
        return plain(*args, **kw)

    dr.delta_rule_recurrent = counted
    try:
        run = lambda: eng.ask(question, max_new_tokens=ASK_NEW_TOKENS, eos_token_id=-1,
                              chunk_size=ASK_NEW_TOKENS - 1)
        total, count, sums, _ = _device_profile(run)
    finally:
        dr.delta_rule_recurrent = plain
    calls = len(seen) // 4  # the profile's warm-up and three runs
    args, kw = seen[0]
    _, per_call, _, _ = _device_profile(lambda: plain(*args, **kw))
    T = args[0].shape[1]
    print(f"[profile] one ask of {ASK_NEW_TOKENS} tokens: device {total:.2f} ms, {count} device "
          f"kernels; the T <= 64 recurrence (plain torch, T {T}): {calls} calls an ask x "
          f"{per_call} kernels = {calls * per_call} kernels on '{card}'", flush=True)


def _profile_image_vit(params, cfg, pixels, grid, card: str) -> None:
    """Where the ViT's device time goes for one 1344x1344 image (S 9,216:
    4 E launches, 28 window blocks): the high-resolution prefill's vision
    part."""
    from infinitevl_tpu_torch.models.vision import get_vision_plan, vision_forward

    plan = get_vision_plan((tuple(int(x) for x in grid),), cfg.vision)
    px = torch.as_tensor(pixels, device=params["visual"]["patch_embed"].device)

    def vit():
        return vision_forward(params["visual"], cfg.vision, px, plan)

    wall = _host_ms(vit)
    total, count, sums, rows = _device_profile(vit)
    e_rows = [(ms, n, name) for ms, n, name in rows if "vit_flash" in name]
    print(f"[profile] the ViT of one {HIRES_HW}x{HIRES_HW} image ({pixels.shape[0]} patches): "
          f"{wall:.2f} ms unprofiled wall, device busy {total:.2f} ms, {count} device kernels; "
          f"by kind (ms): " + ", ".join(f"{k} {v:.2f}" for k, v in sums.items())
          + "; E/F by name: " + ", ".join(f"{name[:60]} {ms:.3f} ms x{n}"
                                          for ms, n, name in e_rows)
          + f" on '{card}'", flush=True)


def _profile_int4_frame(eng, frames, frame_ms: float, card: str) -> None:
    """Where a steady 448x448 frame's device time goes with int4 weights
    (kernel G in the ViT at M 1024 and in the decoder at M 257)."""
    it = iter(np.tile(frames, (4, 1, 1, 1)))
    total, count, sums, rows = _device_profile(lambda: eng.push_frame_raw(next(it)))
    g_rows = [(ms, n, name) for ms, n, name in rows if "int4_" in name]
    print(f"[profile] one steady int4 448x448 frame: {frame_ms:.2f} ms unprofiled, device "
          f"busy {total:.2f} ms ({100 * total / frame_ms:.0f}%), {count} device kernels; by "
          f"kind (ms): " + ", ".join(f"{k} {v:.2f}" for k, v in sums.items())
          + "; kernel G by name: " + ", ".join(f"{name[:40]} {ms:.3f} ms x{n}"
                                               for ms, n, name in g_rows)
          + f" on '{card}'", flush=True)


# ---------------------------------------------------------------- long context, optimizers


# phase 4's chunked stack: the small model with a window of 128 and the chunk
# knobs scaled down, so that T 500 runs every layer sequence-chunked (SWA in
# chunks of 128 over 2 windows, DeltaNet in chunks of 128, the MLP in chunks of
# 100) on packed rows whose segments cross the chunk edges, with a pad tail
LONG_SMALL = dict(sliding_window=128, delta_seq_chunk_t=256, delta_seq_chunk_eval=128,
                  mlp_chunk_t=100, T=500)
# phase 12: the recipes' cuts (PERF.md section 4) and the runs' shapes
# one step each, timed whole (PERF.md section 4 lists the cuts)
LONG_32K_STEPS, LONG_64K_STEPS = 1, 1
LONG_32K_LAYERS = 4  # (a)'s depth (the script's time budget's: PERF.md section 4)
LONG_64K_LAYERS = 4  # (b)'s depth (at 36 layers it peaked at 18.73-19.29 GB: PERF.md §6)
LONG_EXACT_T = 16384  # (c): one LoRA step chunked and full-T
OPTIM_T, OPTIM_STEPS = 2048, 3  # (d)
# (c)'s and (d)'s depth (at 36, GaLore's refresh alone took 77 s; the script's time budget's)
LONG_CD_LAYERS = 4
# galore's gap 3 refreshes its projections once in the 3 steps (at step 1, ~330 SVDs at
# 3B); phase 4 holds the refresh CPU against card at small size
OPTIM_RUNS = (("galore", dict(optimizer_update_gap=3)), ("apollo", dict(optimizer_update_gap=2)),
              ("badam", dict()), ("adam_mini", dict()), ("loraplus", dict(finetuning_type="lora")))


def _custom_tx(name: str, lr: float):
    """One of train/optim.py's optimizers as run_sft's _make_tx builds it:
    grad clip 1.0; GaLore's gap 3 keeps phase 4's three steps in one
    projection period, where a column sign the SVD routine picks (LAPACK on
    the CPU, cuSOLVER on the card) cancels."""
    from infinitevl_tpu_torch.train.optim import make_custom_optimizer

    kw = dict(galore=dict(rank=8, update_proj_gap=3), apollo=dict(rank=8, update_proj_gap=2),
              loraplus=dict(lr_ratio=16.0), badam=dict(num_blocks=2, switch_interval=1),
              adam_mini=dict()).get(name, {})
    return make_custom_optimizer(name, lr, grad_clip=1.0, **kw)


def phase_long_cross_device(dev) -> None:
    """Phase 4, long context and optimizers: three full-finetuning steps with
    remat through the sequence-chunked SWA, DeltaNet and MLP layers (LONG_SMALL)
    on packed rows, and three steps of each custom optimizer (LoRA+ on LoRA)
    on the small model's tail-padded rows, CPU (plain versions) against card
    (kernels H and C, their gradients; C from the carried state), within
    MODEL_TOL."""
    import dataclasses

    from infinitevl_tpu_torch.models import text as TX
    from infinitevl_tpu_torch.models.params import init_params
    from infinitevl_tpu_torch.ops.delta_kernels import delta_rule_chunk_fused as c_fn
    from infinitevl_tpu_torch.ops.swa_kernels import swa_train_flash_attention as h_fn
    from infinitevl_tpu_torch.train.lora import init_lora, make_lora_sft_step
    from infinitevl_tpu_torch.train.step import (
        make_optimizer,
        make_sft_train_step,
        read_segment_layout,
        set_trainable,
        tree_leaves_with_path,
    )

    small = _small_config()
    L = LONG_SMALL
    tc = dataclasses.replace(small.text, **{k: v for k, v in L.items() if k != "T"})
    base = init_params(small, torch.Generator().manual_seed(5), "cpu", torch.float32)["text"]
    rng = np.random.RandomState(5)
    B, T = 2, L["T"]
    batches = []
    for starts in (((0, 100, 128, 300, 470), (0, 256)), ((0, 250), (0, 60, 384)),
                   ((0,), (0, 127, 129))):
        seg = np.zeros((B, T), np.int32)
        for r, st in enumerate(starts):
            for i, t0 in enumerate(st):
                seg[r, t0:] = i + 1
        seg[:, 480:] = 0
        pos = np.zeros((B, T), np.int64)
        for r in range(B):
            for t in range(1, T):
                pos[r, t] = pos[r, t - 1] + 1 if seg[r, t] == seg[r, t - 1] else 0
        ids = rng.randint(0, tc.vocab_size - 8, (B, T)) * (seg > 0)
        batches.append(dict(
            input_ids=ids, labels=np.where((rng.uniform(size=(B, T)) < 0.7) & (seg > 0), ids,
                                           -100),
            position_ids=np.broadcast_to(pos[None], (3, B, T)).copy(), segment_ids=seg))
    require(all(read_segment_layout(b["segment_ids"]) == "packed" for b in batches),
            "phase 4 long: rows not packed")

    def run(device):
        params = {"text": _clone_tree(base, device)}
        set_trainable(params, lambda path, leaf: path != "text/inv_freq")
        tx = make_optimizer(1e-3, warmup_steps=1, total_steps=3)
        step = make_sft_train_step(tc, tx, remat=True)
        state = tx.init(params)
        return [float(step(params, state, dict(b))[2]) for b in batches], params

    with _Spy(TX, "_delta_chunk") as dchunks, _Spy(TX, "_swa_chunk") as schunks:
        l_cpu, p_cpu = run("cpu")
    _reset_launches()
    l_dev, p_dev = run(dev)
    torch.cuda.synchronize()
    launches = (h_fn.launches, h_fn.launches_bwd, c_fn.launches)
    require(dchunks.results and schunks.results, "phase 4 long: the chunked layers did not run")
    require(all(n > 0 for n in launches), f"phase 4 long: H / H bwd / C launches {launches}")
    cpu_leaves = dict(tree_leaves_with_path(p_cpu))
    e_loss = max(abs(a - b) / abs(a) for a, b in zip(l_cpu, l_dev))
    e_par = max(err_ratio(v.detach(), cpu_leaves[k].detach())
                for k, v in tree_leaves_with_path(p_dev) if cpu_leaves[k].abs().sum() > 0)
    require(e_loss <= MODEL_TOL and e_par <= MODEL_TOL,
            f"phase 4 long: loss err {e_loss:.3g}, params err_ratio {e_par:.3g}")
    print(f"[4 cross-device] three full-finetuning steps with remat through the "
          f"sequence-chunked layers (T {T}, window {tc.sliding_window}, DeltaNet chunks of "
          f"{tc.delta_seq_chunk_eval}, MLP chunks of {tc.mlp_chunk_t}; packed rows crossing "
          f"the chunk edges, a pad tail), fp32, CPU against card: losses "
          f"{[round(x, 4) for x in l_dev]}, loss err {e_loss:.2g}, params err_ratio {e_par:.2g} "
          f"(tol {MODEL_TOL}); launches on the card H {launches[0]} / bwd {launches[1]}, "
          f"C {launches[2]}", flush=True)

    # the five optimizers: three steps each on the small model's rows of 300
    full = init_params(small, torch.Generator().manual_seed(6), "cpu", torch.float32)["text"]
    opt_batches = []
    for lengths in ((300, 211), (257, 300), (120, 70)):
        seg = (np.arange(300)[None] < np.asarray(lengths)[:, None]).astype(np.int32)
        ids = rng.randint(0, small.text.vocab_size - 8, (2, 300)) * seg
        opt_batches.append(dict(
            input_ids=ids, labels=np.where(seg > 0, ids, -100),
            position_ids=np.broadcast_to(np.arange(300)[None, None], (3, 2, 300)).copy(),
            segment_ids=seg))

    def opt_run(name, device):
        params = {"text": _clone_tree(full, device)}
        tx = _custom_tx(name, 1e-3)
        if name == "loraplus":
            set_trainable(params, lambda path, leaf: False)
            tree = _clone_tree(init_lora(params, torch.Generator().manual_seed(7), rank=4),
                               device)
            step = make_lora_sft_step(small.text, tx, base_params=params, alpha=8.0, rank=4)
        else:
            set_trainable(params, lambda path, leaf: path != "text/inv_freq")
            tree = params
            step = make_sft_train_step(small.text, tx)
        state = tx.init(tree)
        return [float(step(tree, state, dict(b))[2]) for b in opt_batches], tree

    parts = []
    for name, _ in OPTIM_RUNS:
        l_cpu, t_cpu = opt_run(name, "cpu")
        l_dev, t_dev = opt_run(name, dev)
        torch.cuda.synchronize()
        cpu_leaves = dict(tree_leaves_with_path(t_cpu))
        e_loss = max(abs(a - b) / abs(a) for a, b in zip(l_cpu, l_dev))
        e_par = max(err_ratio(v.detach(), cpu_leaves[k].detach())
                    for k, v in tree_leaves_with_path(t_dev) if cpu_leaves[k].abs().sum() > 0)
        require(e_loss <= MODEL_TOL and e_par <= MODEL_TOL,
                f"phase 4 {name}: loss err {e_loss:.3g}, params err_ratio {e_par:.3g}")
        parts.append(f"{name} loss err {e_loss:.2g} params {e_par:.2g}")
    print(f"[4 cross-device] three steps of each custom optimizer (train/optim.py; loraplus on "
          f"LoRA r 4, the rest full finetuning), fp32 small model, CPU against card, tol "
          f"{MODEL_TOL}: " + "; ".join(parts), flush=True)


def _long_expect(tc, T: int) -> dict:
    """Launches per step of a sequence-chunked LoRA step with remat: every
    chunk's forward runs in the forward, in the layer's recompute (the
    per-layer checkpoint wraps chunked layers) and in the chunk's own
    recompute; H's backward once per SWA chunk; C's backward is plain torch."""
    runs = 3
    n_w = -(-T // tc.sliding_window)
    n_d = -(-T // min(tc.delta_seq_chunk_t, tc.delta_seq_chunk_eval))
    return {"swa_train_flash_attention": runs * n_w * tc.num_swa_layers,
            "swa_train_flash_attention_bwd": n_w * tc.num_swa_layers,
            "delta_rule_chunk_fused": runs * n_d * tc.num_linear_layers}


def _long_recipe(name: str, args, card: str, expect=None, tag: str = "12 long") -> dict:
    """One run_sft call as _run_recipe measures it, with Trainer.save replaced
    (no train state is written) and the frozen base's checksum (the step's
    extra argument: the bf16 or int8 base under LoRA) taken before and after
    the steps, which must be bit-equal."""
    from infinitevl_tpu_torch.train import trainer as T

    saves, sums = [], []
    real_train = T.Trainer.train

    def train(trainer, *a, **kw):
        base = trainer.extra[0] if trainer.extra else None
        before = _checksum(base) if base is not None else None
        out = real_train(trainer, *a, **kw)
        if base is not None:
            sums.append((len(before), _checksum(base) == before))
        return out

    with _Spy(T.Trainer, "save", replace=lambda trainer: saves.append(trainer.step)), \
            _Spy(T.Trainer, "train", replace=train):
        r = _run_recipe(name, args, card, expect, tag=tag)
    require(saves == [args.train.max_steps], f"{name}: Trainer.save called at steps {saves}")
    if args.finetune.finetuning_type == "lora":
        require(sums and sums[0][1], f"{name}: the frozen base changed ({sums})")
        print(f"[{tag}] {name}: the frozen base's {sums[0][0]} leaves bit-unchanged "
              f"(checksums); Trainer.save replaced, so no train state was written", flush=True)
    return r


def phase_long_path(dev, card: str, full_adamw_peak=None) -> dict:
    """Phase 12: long-context training and the custom optimizers at 3B
    (full width, bf16, random weights from seed 0, B 1):
    (a) examples/sft_32k_lora_yarn.yaml at cutoff 32,768 (LONG_32K_LAYERS deep) and (b)
    examples/sft_64k_qlora_yarn.yaml at 65,536 (LONG_64K_LAYERS deep), with gradient_accumulation_steps
    8 -> 1, max_steps 1000 -> 1 and logging_steps 10 -> 1, on one row of
    data/demo.json's outputs repeated to the context; (c) one LoRA step at 16,384 through the chunked layers and through the full-T
    path (delta_seq_chunk_t 0); (c) and (d) at LONG_CD_LAYERS layers; (d) galore, apollo, badam and adam_mini as full
    finetuning and loraplus on LoRA at cutoff 2,048 with remat, 3 steps;
    then one SVD of the tied embedding's shape, GaLore's largest leaf."""
    import dataclasses
    import os
    import shutil
    import tempfile

    from infinitevl_tpu_torch.hparams import load_yaml_args
    from infinitevl_tpu_torch.config import LINEAR, SLIDING
    from infinitevl_tpu_torch.models.text import (
        delta_forward,
        embed_tokens,
        mrope_cos_sin,
        rms_norm,
        swa_attention_forward,
    )
    from infinitevl_tpu_torch.ops.swa_kernels import swa_train_flash_attention as h
    from infinitevl_tpu_torch.train import trainer as T
    from infinitevl_tpu_torch.train.lora import _lora_loss, init_lora
    from infinitevl_tpu_torch.train.optim import GaLore
    from infinitevl_tpu_torch.train.step import (
        _layer_segments,
        batch_to_device,
        set_trainable,
        tree_leaves_with_path,
    )

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="ivl_long_")
    data_dir = os.path.join(root, "data")
    _long_text_dataset(data_dir, 65536)
    res, total = {}, {}

    def add(r):
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v

    def recipe(yaml_name, out, **over):
        args = load_yaml_args(os.path.join(here, "examples", yaml_name))
        args.data.dataset, args.data.dataset_dir = "demo_long", data_dir
        args.train.output_dir = os.path.join(root, out)
        args.train.gradient_accumulation_steps, args.train.logging_steps = 1, 1
        args.train.num_train_epochs = 1000.0  # the one row, repeated for every step
        for key, val in over.items():
            group = next(g for g in (args.data, args.train, args.finetune) if hasattr(g, key))
            setattr(group, key, val)
        return args

    # (a) at LONG_32K_LAYERS, (b) at LONG_64K_LAYERS, (c) and (d) at LONG_CD_LAYERS layers
    # of the 3B width
    real_3b = T.infinitevl_3b
    T.infinitevl_3b = lambda: _cut_3b(LONG_32K_LAYERS)
    a = recipe("sft_32k_lora_yarn.yaml", "a", max_steps=LONG_32K_STEPS)
    tc = T.build_config(a).text
    require(tc.rope_type == "yarn" and tc.max_position_embeddings == 131072,
            f"(a) rope {tc.rope_type} {tc.max_position_embeddings}")
    res["lora_32k"] = _long_recipe(
        f"(a) sft_32k_lora_yarn.yaml at cutoff 32768 (yarn, LoRA r 8, remat), "
        f"{LONG_32K_LAYERS} layers", a, card, _long_expect(tc, 32768))
    add(res["lora_32k"])
    T.infinitevl_3b = lambda: _cut_3b(LONG_64K_LAYERS)
    b = recipe("sft_64k_qlora_yarn.yaml", "b", max_steps=LONG_64K_STEPS)
    res["qlora_64k"] = _long_recipe(
        f"(b) sft_64k_qlora_yarn.yaml at cutoff 65536 (yarn, int8 base, LoRA r 8, remat), "
        f"{LONG_64K_LAYERS} layers", b, card, _long_expect(T.build_config(b).text, 65536))
    add(res["qlora_64k"])
    T.infinitevl_3b = lambda: _cut_3b(LONG_CD_LAYERS)

    # (c) the same LoRA step at 16,384: chunked layers against the full-T path
    _free()
    c_args = recipe("sft_32k_lora_yarn.yaml", "c", cutoff_len=LONG_EXACT_T, max_steps=1)
    cfg = T.build_config(c_args)
    data = T.build_dataset(c_args, T.resolve_tokenizer(c_args, cfg, None), cfg=cfg)
    params = T._load_or_init_params(c_args, cfg, False, torch.bfloat16, dev)
    set_trainable(params, lambda path, leaf: False)
    lora = init_lora(params, torch.Generator(device=dev).manual_seed(1), rank=8)
    gen = torch.Generator(device=dev).manual_seed(2)
    with torch.no_grad():  # b != 0, so that a's gradients are not zero
        for path, t in tree_leaves_with_path(lora):
            if path.endswith("/b"):
                t.copy_(torch.randn(t.shape, generator=gen, device=dev) * 1e-3)
    batch = dict(next(iter(T._batches(c_args, data, cfg, False))))
    batch.pop("_n_tokens")
    batch = batch_to_device(batch, dev)
    leaves = [t for _, t in tree_leaves_with_path(lora)]
    # at random init the loss is near ln(vocab) on both paths and the mixers'
    # outputs are small beside the MLPs' in the bf16 residual, so neither the
    # loss nor the final hidden state tells the paths apart; the first SWA and
    # DeltaNet layers' mixer outputs (a forward without grad, before the
    # counted step) and the LoRA gradients do
    tp = params["text"]
    roles = [cfg.text.layer_role(i) for i in range(len(tp["layers"]))]
    p_swa, p_lin = tp["layers"][roles.index(SLIDING)], tp["layers"][roles.index(LINEAR)]
    seg, tail_pads_only, _ = _layer_segments(batch.get("segment_ids"),
                                             batch.get("segment_layout"), batch["labels"])
    with torch.no_grad():
        x0 = embed_tokens(tp, batch["input_ids"])
        cos, sin = mrope_cos_sin(batch["position_ids"], tp["inv_freq"], cfg.text.mrope_section,
                                 cfg.text.attention_scaling, dtype=x0.dtype)
    exact = {}
    for label, tcfg in (("chunked", cfg.text),
                        ("full-T", dataclasses.replace(cfg.text, delta_seq_chunk_t=0))):
        _free()
        with torch.no_grad():
            mixers = [  # off the card, out of the step's peak
                swa_attention_forward(
                    p_swa, tcfg, rms_norm(x0, p_swa["input_norm"], tcfg.rms_norm_eps), cos, sin,
                    None, None, None, segment_ids=seg).float().cpu(),
                delta_forward(p_lin, tcfg, rms_norm(x0, p_lin["input_norm"], tcfg.rms_norm_eps),
                              None, None, None, None, segment_ids=seg,
                              tail_pads_only=tail_pads_only).float().cpu()]
        _free()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = _lora_loss(tcfg, params, lora, batch, None, None, 16.0, 8, False, True, 1)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = _read_launches(("swa_train_flash_attention", "delta_rule_chunk_fused"))
        exact[label] = dict(loss=float(loss.detach()), mixers=mixers,
                            grads=torch.cat([g.float().flatten() for g in grads]),
                            peak_gb=torch.cuda.max_memory_allocated() / 1e9, ms=ms,
                            launches=dict(launches, swa_train_flash_attention_bwd=h.launches_bwd))
        del loss, grads, mixers
    ch, fu = exact["chunked"], exact["full-T"]
    e_loss = abs(ch["loss"] - fu["loss"]) / abs(fu["loss"])
    e_swa, e_lin = (err_ratio(a, b) for a, b in zip(ch["mixers"], fu["mixers"]))
    e_grad = err_ratio(ch["grads"], fu["grads"])
    require(max(e_loss, e_swa, e_lin, e_grad) <= BF16_TOL,
            f"(c) chunked against full-T at {LONG_EXACT_T}: loss err {e_loss:.3g}, mixer "
            f"outputs err_ratio SWA {e_swa:.3g} DeltaNet {e_lin:.3g}, LoRA gradients "
            f"err_ratio {e_grad:.3g}")
    want = _long_expect(cfg.text, LONG_EXACT_T)
    require(all(ch["launches"][k] == v for k, v in want.items()),
            f"(c) chunked launches {ch['launches']}, expected {want}")
    print(f"[12 long] (c) one LoRA step (loss and gradients) at {LONG_EXACT_T}, "
          f"{cfg.text.num_hidden_layers} layers, remat: chunked "
          f"loss {ch['loss']:.6f}, full-T {fu['loss']:.6f} (err {e_loss:.2g}; near ln(vocab) "
          f"on both at random init, so it cannot fail), the first SWA / DeltaNet layer's "
          f"mixer output (no grad) err_ratio {e_swa:.2g} / {e_lin:.2g}, LoRA gradients err_ratio {e_grad:.2g} (tol {BF16_TOL}); peak memory chunked {ch['peak_gb']:.2f} GB, "
          f"full-T {fu['peak_gb']:.2f} GB; ms (one forward+backward) chunked {ch['ms']:.0f}, "
          f"full-T {fu['ms']:.0f}; launches H fwd / bwd, C: chunked "
          f"{ch['launches']['swa_train_flash_attention']} / "
          f"{ch['launches']['swa_train_flash_attention_bwd']}, "
          f"{ch['launches']['delta_rule_chunk_fused']}, full-T "
          f"{fu['launches']['swa_train_flash_attention']} / "
          f"{fu['launches']['swa_train_flash_attention_bwd']}, "
          f"{fu['launches']['delta_rule_chunk_fused']} on '{card}'", flush=True)
    res["exact_16k"] = dict(loss_err=e_loss, swa_err=e_swa, delta_err=e_lin, grad_err=e_grad,
                            **{f"{k}_{m}": exact[k][m] for k in exact for m in ("peak_gb", "ms")})
    add(ch)
    add(fu)
    del params, tp, p_swa, p_lin, x0, cos, sin, lora, leaves, batch, seg, exact, ch, fu
    _free()

    # (d) the custom optimizers at 3B width and LONG_CD_LAYERS layers, cutoff
    # 2,048, remat, three steps
    d_base = dict(cutoff_len=OPTIM_T, max_steps=OPTIM_STEPS, remat=True)
    tc_d = cfg.text
    # remat at 2,048 (one window: the full-T layers): each layer's forward twice
    remat_launches = {"swa_train_flash_attention": 2 * tc_d.num_swa_layers,
                      "swa_train_flash_attention_bwd": tc_d.num_swa_layers,
                      "delta_rule_chunk_fused": 2 * tc_d.num_linear_layers}
    for name, over in OPTIM_RUNS:
        over = {"finetuning_type": "full", **over}
        args = recipe("sft_32k_lora_yarn.yaml", f"d_{name}", use_optimizer=name, **d_base,
                      **over)
        svd_s = []

        def timed_svd(tx, g, left, real=GaLore.svd_proj):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(tx, g, left)
            torch.cuda.synchronize()
            svd_s.append(time.perf_counter() - t0)
            return out

        with _Spy(GaLore, "svd_proj", replace=timed_svd):
            r = _long_recipe(f"(d) use_optimizer: {name} ({args.finetune.finetuning_type}), "
                             f"{LONG_CD_LAYERS} layers, cutoff {OPTIM_T}", args, card,
                             remat_launches)
        extra = ""
        if name == "galore":
            r["svd_s"] = sum(svd_s)
            extra = f", {len(svd_s)} SVDs in its refreshes took {sum(svd_s):.2f} s over the run"
        print(f"[12 long] (d) {name}: peak {r['peak_gb']:.2f} GB at {LONG_CD_LAYERS} layers "
              f"(AdamW's full finetune at {TRAIN_LAYERS} layers, phase 8 (d): "
              f"{full_adamw_peak if full_adamw_peak is not None else 'not run'}){extra}",
              flush=True)
        res[f"optim_{name}"] = r
        add(r)
        shutil.rmtree(args.train.output_dir, ignore_errors=True)
    T.infinitevl_3b = real_3b

    # GaLore's SVD on the card of its largest leaf, the tied 151,936 x 2,048
    # embedding (fp32, torch's default routine, as GaLore.svd_proj): time and
    # workspace above the input
    _free()
    shape = (tc.vocab_size, tc.hidden_size)
    g = torch.randn(shape, generator=gen, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    u, _, vh = torch.linalg.svd(g, full_matrices=False)
    torch.cuda.synchronize()
    res["svd_embed"] = dict(seconds=time.perf_counter() - t0, workspace_gb=(
        torch.cuda.max_memory_allocated() - base_mem) / 1e9)
    require(bool(torch.isfinite(u[:, :8]).all()), "GaLore's SVD of the embedding: not finite")
    del g, u, vh
    print(f"[12 long] GaLore's SVD (fp32, torch.linalg.svd) of the {shape[0]} x {shape[1]} "
          f"tied embedding: {res['svd_embed']['seconds']:.3f} s, "
          f"{res['svd_embed']['workspace_gb']:.2f} GB above the input on '{card}'", flush=True)
    _free()
    shutil.rmtree(root, ignore_errors=True)
    res["total_launches"] = total
    print(f"[12 long] phase 12 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return res


# ---------------------------------------------------------------- the Mamba2 mixer, LoRA variants

M2_LAYERS = ("sliding_attention", "mamba2", "linear_attention", "mamba2")  # phase 4's hybrid
M2_STAGE1_STEPS = 3  # (a): stage 1 on packed rows of 8,192
M2_FRAMES, M2_TEXT_PROMPT = 16, 1000  # (b)
LORA_VARIANT_T, DORA_STEPS = 2048, 3  # (c)
LOFTQ_LAYERS, LOFTQ_ITERS = 2, 4  # (c): loftq_init's default rounds on 2 layers (SWA, DeltaNet)
PISSA_LAYERS = 4  # (c): pissa_decompose's depth (the script's time budget's: 4 SVDs a layer)


class _CallCount:
    """Counts the calls of module attributes (functions) for the duration
    of a `with`, keeping nothing of their results."""

    def __init__(self, module, *names):
        self.module, self.names = module, names
        self.counts = dict.fromkeys(names, 0)

    def __enter__(self):
        self.real = {n: getattr(self.module, n) for n in self.names}
        for n in self.names:
            def counted(*args, _n=n, **kw):
                self.counts[_n] += 1
                return self.real[_n](*args, **kw)
            setattr(self.module, n, counted)
        return self

    def __exit__(self, *exc):
        for n, fn in self.real.items():
            setattr(self.module, n, fn)


def phase_mamba2_cross_device(dev) -> None:
    """Phase 4, the Mamba2 mixer and DoRA on the small fp32 model, CPU
    (plain versions) against the card (kernels): a hybrid with every role
    (SWA, Mamba2, DeltaNet, Mamba2): cached prefill of 600 tokens and one
    decode step (logits), Generator's greedy tokens on a 700-token prompt in
    256-token chunks; one distillation stage-1 step of a full-attention
    teacher converted with mixer mamba2 (layer 0 kept); one DoRA LoRA step
    with remat on tail-padded rows. MODEL_TOL throughout, tokens identical."""
    import dataclasses

    from infinitevl_tpu_torch.generation import Generator
    from infinitevl_tpu_torch.models.convert import convert_attention, trainable_mask
    from infinitevl_tpu_torch.models.infinitevl import forward, get_rope_index
    from infinitevl_tpu_torch.models.params import init_params, init_text_params
    from infinitevl_tpu_torch.models.state import init_decoder_state
    from infinitevl_tpu_torch.ops.delta_kernels import delta_rule_chunk_fused
    from infinitevl_tpu_torch.ops.swa_kernels import swa_train_flash_attention as h
    from infinitevl_tpu_torch.train.distill import apply_trainable_mask, make_stage1_step
    from infinitevl_tpu_torch.train.lora import init_lora, make_lora_sft_step
    from infinitevl_tpu_torch.train.step import make_optimizer, tree_leaves_with_path

    small = _small_config()
    cfg = dataclasses.replace(small, text=dataclasses.replace(small.text, layer_types=M2_LAYERS))
    text, vocab = cfg.text, cfg.text.vocab_size
    p_cpu = {"text": init_text_params(text, torch.Generator().manual_seed(6), "cpu",
                                      torch.float32)}
    p_dev = _to(p_cpu, dev)
    rng = np.random.RandomState(6)
    ids = rng.randint(0, vocab - 8, (2, 700))
    pos, _ = get_rope_index(cfg, ids)
    _reset_launches()
    outs = []
    for params, device in ((p_cpu, "cpu"), (p_dev, dev)):
        st = init_decoder_state(text, 2, torch.float32, device)
        t_ids, t_pos = torch.as_tensor(ids, device=device), torch.as_tensor(pos, device=device)
        l1, st = forward(params, cfg, t_ids[:, :600], t_pos[:, :, :600], st)
        l2, st = forward(params, cfg, t_ids[:, 600:601], t_pos[:, :, 600:601], st)
        g = Generator(params, cfg, device=device)
        g.prefill_chunk_size = 256
        outs.append((l1, l2, st, g.generate(ids, max_new_tokens=16, eos_token_id=-1)))
    torch.cuda.synchronize()
    launches = _read_launches(("swa_ring_flash_attention", "swa_ring_flash_decode_stacked",
                               "delta_rule_chunk_fused", "delta_step_fused_stacked"))
    (c1, c2, cst, ctok), (d1, d2, dst, dtok) = outs
    e_logits = max(err_ratio(d1, c1), err_ratio(d2, c2))
    e_state = max(err_ratio(dst[k], cst[k]) for k in ("mamba_h", "mamba_conv", "delta_h",
                                                       "swa_k"))
    require(e_logits <= MODEL_TOL and e_state <= MODEL_TOL,
            f"mamba2 hybrid: logits err_ratio {e_logits:.3g}, state {e_state:.3g} CPU vs card")
    require(np.array_equal(ctok, dtok), f"mamba2 hybrid: greedy tokens differ CPU vs card:\n"
                                        f"{ctok}\n{dtok}")
    print(f"[4 cross-device] mamba2 hybrid ({', '.join(M2_LAYERS)}; fp32, hidden 256, 8 heads "
          f"x 128): cached prefill of 600 tokens + one decode step, logits err_ratio "
          f"{e_logits:.2g}, state (mamba_h, mamba_conv, delta_h, rings) {e_state:.2g} (tol "
          f"{MODEL_TOL}); greedy tokens identical (16 x 2 rows, 700-token prompt in 256-token "
          f"chunks); launches A1 {launches['swa_ring_flash_attention']}, A2 "
          f"{launches['swa_ring_flash_decode_stacked']}, C {launches['delta_rule_chunk_fused']}, "
          f"B {launches['delta_step_fused_stacked']}", flush=True)

    # one stage-1 step of the mamba2 conversion
    n = small.text.num_hidden_layers
    tcfg = dataclasses.replace(small.text, layer_types=("full_attention",) * n)
    teacher_cpu = init_text_params(tcfg, torch.Generator().manual_seed(7), "cpu", torch.float32)
    student_cpu, scfg = convert_attention(teacher_cpu, tcfg, torch.Generator().manual_seed(8),
                                          softmax_attention=(0,), mixer="mamba2")
    B, T = 2, 300
    seg = (np.arange(T)[None] < np.asarray([300, 211])[:, None]).astype(np.int32)
    tids = rng.randint(0, vocab - 8, (B, T)) * seg
    batch = dict(input_ids=tids, labels=np.where(seg > 0, tids, -100),
                 position_ids=np.broadcast_to(np.arange(T)[None, None], (3, B, T)).copy(),
                 segment_ids=seg)

    def stage1(device):
        teacher = _clone_tree(teacher_cpu, device)
        student, _ = convert_attention(teacher, tcfg, None, softmax_attention=(0,),
                                       mixer="mamba2")
        for i in range(1, n):  # the CPU's fresh draws (g_proj, dt_bias) on both sides
            for k, v in student_cpu["layers"][i].items():
                if k not in ("mlp", "input_norm", "post_norm"):
                    student["layers"][i][k] = _clone_tree(v, device)
        tx = make_optimizer(1e-3, grad_clip=1e9)
        apply_trainable_mask(student, trainable_mask(student, scfg, softmax_attention=(0,)),
                             teacher)
        _, _, loss = make_stage1_step(scfg, tcfg, tx, 10.0)(student, tx.init(student), teacher,
                                                            dict(batch))
        trained = {k: v.detach() for k, v in tree_leaves_with_path(student) if v.requires_grad}
        return float(loss), trained

    l_cpu, t_cpu = stage1("cpu")
    h.launches = h.launches_bwd = delta_rule_chunk_fused.launches = 0
    l_dev, t_dev = stage1(dev)
    torch.cuda.synchronize()
    e_loss = abs(l_dev - l_cpu) / abs(l_cpu)
    e_par = max(err_ratio(v, t_cpu[k]) for k, v in t_dev.items())
    got = (h.launches, h.launches_bwd, delta_rule_chunk_fused.launches)
    require(e_loss <= MODEL_TOL and e_par <= MODEL_TOL,
            f"mamba2 stage 1: loss err {e_loss:.3g}, trainable leaves {e_par:.3g} CPU vs card")
    require(got == (n + 1, 0, 0), f"mamba2 stage 1: H fwd / bwd / C launches {got}, expected "
                                  f"{(n + 1, 0, 0)}")
    print(f"[4 cross-device] one distillation stage-1 step with mixer mamba2 (a {n}-layer "
          f"full-attention teacher, layer 0 kept, tail-padded rows B 2, T 300, lr 1e-3): loss "
          f"{l_dev:.6f}, loss err {e_loss:.2g}, {len(t_dev)} trainable leaves err_ratio "
          f"{e_par:.2g} (tol {MODEL_TOL}); H fwd / bwd / C launches {got}", flush=True)

    # one DoRA LoRA step (every factor moved off its init, so no leaf is zero)
    base = init_params(small, torch.Generator().manual_seed(9), "cpu", torch.float32)
    ad_cpu = init_lora(base, torch.Generator().manual_seed(10), rank=4, use_dora=True)
    noise = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for _, t in tree_leaves_with_path(ad_cpu):
            t.add_(0.02 * torch.randn(t.shape, generator=noise))

    def dora(device):
        params, ad = _clone_tree(base, device), _clone_tree(ad_cpu, device)
        tx = make_optimizer(1e-3, grad_clip=1e9)
        step = make_lora_sft_step(small.text, tx, base_params=params, alpha=8.0, rank=4,
                                  remat=True)
        _, _, loss = step(ad, tx.init(ad), dict(batch))
        return float(loss), {k: v.detach() for k, v in tree_leaves_with_path(ad)}

    l_cpu, a_cpu = dora("cpu")
    h.launches = h.launches_bwd = delta_rule_chunk_fused.launches = 0
    l_dev, a_dev = dora(dev)
    torch.cuda.synchronize()
    e_loss = abs(l_dev - l_cpu) / abs(l_cpu)
    e_par = max(err_ratio(v, a_cpu[k]) for k, v in a_dev.items())
    n_m = sum(k.endswith("/m") for k in a_dev)
    got = (h.launches, h.launches_bwd, delta_rule_chunk_fused.launches)
    require(e_loss <= MODEL_TOL and e_par <= MODEL_TOL,
            f"DoRA step: loss err {e_loss:.3g}, adapter err_ratio {e_par:.3g} CPU vs card")
    require(n_m > 0 and min(got) > 0, f"DoRA step: {n_m} magnitudes, launches {got}")
    print(f"[4 cross-device] one DoRA LoRA step (r 4 on q/k/v/o, {n_m} magnitudes, remat, "
          f"tail-padded rows B 2, T 300): loss {l_dev:.6f}, loss err {e_loss:.2g}, "
          f"{len(a_dev)} adapter leaves (a, b, m) err_ratio {e_par:.2g} (tol {MODEL_TOL}); "
          f"H fwd / bwd / C launches {got}", flush=True)


M2_DEPTH = 12  # phase 13: the teacher's and student's depth (the script's time budget's)


def phase_mamba2_path(dev, card: str) -> dict:
    """Phase 13 at 3B width, M2_DEPTH deep (bf16, random weights from seed 0,
    B 1): (a) stage 1 of examples/train_3b_stage1.yaml with mixer mamba2
    (data_parallel 8 -> 1, 3 steps on packed rows of 8,192, Trainer.save
    replaced), the teacher the all-full_attention twin with the ViT;
    (b) the student from (a) served: 16 raw 448x448 frames through
    StreamingEngine and an `ask` of 17 tokens, then a 1,000-token text
    request of 32 new tokens through Generator; (c) the LoRA variants: DoRA
    through run_sft at 2,048 (r 8, 3 steps), pissa_decompose on
    PISSA_LAYERS layers, loftq_init on LOFTQ_LAYERS, one make_lora_sft_step each for PiSSA
    and LoftQ. Returns the launches of every path, summed."""
    from infinitevl_tpu_torch.train import trainer as T

    real_3b, T.infinitevl_3b = T.infinitevl_3b, lambda: _cut_3b(M2_DEPTH)
    try:
        return _mamba2_path(dev, card)
    finally:
        T.infinitevl_3b = real_3b


def _mamba2_path(dev, card: str) -> dict:
    import dataclasses
    import os
    import shutil
    import tempfile

    import infinitevl_tpu_torch.models.text as text_mod
    from infinitevl_tpu_torch.config import MAMBA2
    from infinitevl_tpu_torch.data.loader import resolve_tokenizer
    from infinitevl_tpu_torch.generation import Generator
    from infinitevl_tpu_torch.hparams import load_yaml_args
    from infinitevl_tpu_torch.models.convert import _gqa_expand
    from infinitevl_tpu_torch.models.infinitevl import forward
    from infinitevl_tpu_torch.models.params import init_params
    from infinitevl_tpu_torch.models.quant import dequantize_kernel, quantize_kernel
    from infinitevl_tpu_torch.models.state import clone_state, state_bytes
    from infinitevl_tpu_torch.ops.swa_kernels import swa_train_flash_attention as h
    from infinitevl_tpu_torch.train import lora as L
    from infinitevl_tpu_torch.train import trainer as T
    from infinitevl_tpu_torch.train.step import (
        make_optimizer,
        read_segment_layout,
        set_trainable,
        sft_loss_fn,
        tree_leaves_with_path,
    )

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    cfg = T.infinitevl_3b()
    tc = cfg.text
    n, n_swa, n_lin = tc.num_hidden_layers, tc.num_swa_layers, tc.num_linear_layers
    teacher_cfg = dataclasses.replace(cfg, text=dataclasses.replace(
        tc, layer_types=("full_attention",) * n))
    root = tempfile.mkdtemp(prefix="ivl_m2_")
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    try:
        # (a) stage 1 with the mamba2 mixer
        teacher = init_params(teacher_cfg, torch.Generator(device=dev).manual_seed(0))
        set_trainable(teacher, lambda path, leaf: False)
        before = _checksum(teacher)
        data_dir = os.path.join(root, "packed")
        _packed_text_dataset(data_dir, n=90)
        args = load_yaml_args(os.path.join(here, "examples", "train_3b_stage1.yaml"))
        for group, key, val in ((args.finetune, "mixer", "mamba2"),
                                (args.train, "data_parallel", 1),
                                (args.train, "max_steps", M2_STAGE1_STEPS),
                                (args.train, "logging_steps", 1),
                                (args.train, "save_steps", 10**6),
                                (args.train, "output_dir", os.path.join(root, "stage1")),
                                (args.data, "dataset", "demo_packed"),
                                (args.data, "dataset_dir", data_dir)):
            setattr(group, key, val)
        rows = T.build_dataset(args)
        require(len(rows) >= M2_STAGE1_STEPS and all(
            int(np.asarray(r["segment_ids"]).max()) > 1 for r in rows[:M2_STAGE1_STEPS]),
            f"(a) packing made {len(rows)} rows, not {M2_STAGE1_STEPS} packed rows of 8192")
        copied = {}

        def check_copy(margs, _out):
            """Before step 1: the student's q / o are the teacher's numbers,
            its k / v the teacher's expanded to every query head."""
            student, _, t_text = margs[0], margs[1], margs[2]["text"]
            Hkv, Dh = tc.num_key_value_heads, tc.head_dim
            groups = tc.num_attention_heads // Hkv
            for i, lp in enumerate(student["layers"]):
                if "conv_w" not in lp:
                    continue
                tp = t_text["layers"][i]
                for k in ("q_proj", "o_proj"):
                    require(all(torch.equal(lp[k][x], tp[k][x]) for x in tp[k]),
                            f"(a) layer {i} {k} is not the teacher's")
                for k in ("k_proj", "v_proj"):
                    w, b = _gqa_expand(tp[k]["kernel"], tp[k]["bias"], Hkv, Dh, groups)
                    require(torch.equal(lp[k]["kernel"], w) and torch.equal(lp[k]["bias"], b),
                            f"(a) layer {i} {k} is not the teacher's expansion")
                copied[i] = True

        students, saves = [], []
        expect1 = {"swa_train_flash_attention": n + n_swa, "swa_train_flash_attention_bwd": 0,
                   "delta_rule_chunk_fused": 0}
        with _Spy(T, "apply_trainable_mask", check_copy), \
                _Spy(T, "convert_attention") as conv, \
                _Spy(T.Trainer, "save", replace=lambda trainer: saves.append(trainer.step)), \
                _CallCount(text_mod, "mamba2_chunk_scan", "mamba2_step") as calls:
            r1 = _run_recipe(
                "(a) stage 1 with mixer mamba2 (layer MSE x 1000, T 8192 packed)", args, card,
                expect1, tag="13 mamba2",
                run=lambda a: students.append(T.run_dt(a, teacher_params=teacher,
                                                       teacher_cfg=teacher_cfg.text)))
        add(r1["launches"])
        student, scfg = students[0], conv.results[0][1]
        n_m2 = sum(role == MAMBA2 for role in scfg.layer_types)
        require(len(copied) == n_m2 == n - n_swa and saves == [M2_STAGE1_STEPS],
                f"(a) {len(copied)} copies checked, {n_m2} mamba2 layers, saves {saves}")
        require(calls.counts["mamba2_chunk_scan"] == M2_STAGE1_STEPS * n_m2
                and calls.counts["mamba2_step"] == 0, f"(a) mamba2 calls {calls.counts}")
        require(_checksum(teacher) == before, "(a) the teacher changed")
        shared = _ptrs(teacher)
        frozen = [(k, v) for k, v in tree_leaves_with_path(student) if not v.requires_grad]
        trained = [(k, v) for k, v in tree_leaves_with_path(student) if v.requires_grad]
        require(frozen and all(v.untyped_storage().data_ptr() in shared for _, v in frozen),
                "(a) a frozen student leaf is not the teacher's own")
        require(all(v.untyped_storage().data_ptr() not in shared for _, v in trained),
                "(a) a trained student leaf aliases the teacher")
        print(f"[13 mamba2] (a) before step 1 the {n_m2} mamba2 layers' q_proj / o_proj were "
              f"the teacher's and k_proj / v_proj its GQA expansion, bit for bit; after 3 steps "
              f"the teacher's {len(before)} leaves (ViT included) bit-unchanged (checksums), "
              f"{len(frozen)} frozen student leaves the teacher's own tensors, {len(trained)} "
              f"trained leaves of their own; the SSD scan ran {calls.counts} times (plain "
              f"torch, once per mamba2 layer a step); H {r1['launches']['swa_train_flash_attention'] // M2_STAGE1_STEPS} "
              f"forward launches a step; Trainer.save replaced on '{card}'", flush=True)

        # (b) serve the student of (a), with the teacher's (shared, frozen) ViT
        set_trainable(student, lambda path, leaf: False)
        s_cfg = dataclasses.replace(cfg, text=scfg)
        served = {"text": student, "visual": teacher["visual"]}
        expect_bytes = _expected_state_bytes(scfg)
        rng = np.random.RandomState(13)
        prompt = rng.randint(0, tc.vocab_size - 1000, (1, 8))
        question = rng.randint(0, tc.vocab_size - 1000, (1, 6))
        frames = rng.randint(0, 256, (M2_FRAMES, 448, 448, 3)).astype(np.uint8)
        eng = _stream_engine(served, s_cfg, prompt)
        require(state_bytes(eng.state) == expect_bytes, "(b) state size after prime")
        torch.cuda.synchronize()
        _reset_launches()
        with _CallCount(text_mod, "mamba2_chunk_scan", "mamba2_step") as c_frames:
            for f in frames:
                eng.push_frame_raw(f)
                require(state_bytes(eng.state) == expect_bytes, "(b) state size changed by a frame")
        torch.cuda.synchronize()
        l_frames = _read_launches(("swa_ring_flash_attention", "segment_flash_attention",
                                   "window_flash_attention"))
        n_full = len(cfg.vision.fullatt_block_indexes)
        require(l_frames["swa_ring_flash_attention"] == M2_FRAMES * n_swa
                and l_frames["segment_flash_attention"] == M2_FRAMES * n_full
                and l_frames["window_flash_attention"] == M2_FRAMES * (cfg.vision.depth - n_full)
                and c_frames.counts["mamba2_chunk_scan"] == M2_FRAMES * n_m2,
                f"(b) frames: launches {l_frames}, scans {c_frames.counts}")
        snap = clone_state(eng.state)
        _reset_launches()
        with _DecodeClock() as clock, _CallCount(text_mod, "mamba2_chunk_scan",
                                                 "mamba2_step") as c_ask:
            t0 = time.perf_counter()
            answer = eng.ask(question, max_new_tokens=ASK_NEW_TOKENS, eos_token_id=-1,
                             chunk_size=ASK_NEW_TOKENS - 1)
            t_ask = time.perf_counter() - t0
        l_ask = _read_launches(("swa_ring_flash_attention", "swa_ring_flash_decode_stacked"))
        require(len(answer) == ASK_NEW_TOKENS and all(0 <= t < tc.vocab_size for t in answer),
                f"(b) ask returned {answer}")
        require(state_bytes(eng.state) == expect_bytes, "(b) state size changed by the ask")
        require(snap["cum_len"] == eng.state["cum_len"] and all(
            torch.equal(v, eng.state[k]) for k, v in _state_tensors(snap).items()),
            "(b) the ask changed the stream's state")
        require(l_ask["swa_ring_flash_decode_stacked"] == (ASK_NEW_TOKENS - 1) * n_swa,
                f"(b) ask: A2 launches {l_ask['swa_ring_flash_decode_stacked']}")
        for key, t in _state_tensors(eng.state).items():
            require(bool(torch.isfinite(t.float()).all()), f"(b) state {key} not finite")
        times = np.asarray(eng.frame_times_ms[1:])
        print(f"[13 mamba2] (b) StreamingEngine on the student ({n_swa} SWA + {n_m2} mamba2 layers, "
              f"ViT 32 blocks, bf16), 448x448 push_frame_raw x {M2_FRAMES}: per-frame median "
              f"{np.median(times):.2f} ms, mean {times.mean():.2f} ms (first "
              f"{eng.frame_times_ms[0]:.1f} ms excluded); state {expect_bytes / 1e6:.1f} MB "
              f"({expect_bytes} B) constant over every frame and the ask; ask of "
              f"{ASK_NEW_TOKENS} tokens after {M2_FRAMES} frames: {t_ask * 1e3:.1f} ms, first "
              f"token {(clock.first - t0) * 1e3:.1f} ms (state clone included), decode "
              f"{(ASK_NEW_TOKENS - 1) / clock.decode_s:.2f} tok/s; the stream bit-unchanged by "
              f"the ask; launches frames {l_frames}, ask {l_ask}; SSD scans / steps frames "
              f"{c_frames.counts}, ask {c_ask.counts} on '{card}'", flush=True)
        add(l_frames)
        add(l_ask)
        del eng, snap
        _free()
        g = Generator(served, s_cfg)
        ids = rng.randint(0, tc.vocab_size - 1000, (1, M2_TEXT_PROMPT))
        torch.cuda.synchronize()
        _reset_launches()
        with _CallCount(text_mod, "mamba2_chunk_scan", "mamba2_step") as c_text:
            t0 = time.perf_counter()
            chunks = []
            for chunk in g.generate_stream(ids, max_new_tokens=MAIN_NEW_TOKENS, eos_token_id=-1):
                chunks.append(chunk)
                if len(chunks) == 1:
                    t_first = time.perf_counter()
            t_end = time.perf_counter()
        l_text = _read_launches(("swa_ring_flash_attention", "swa_ring_flash_decode_stacked"))
        out = np.concatenate(chunks, axis=1)
        require(out.shape == (1, MAIN_NEW_TOKENS) and bool(
            ((out >= 0) & (out < tc.vocab_size)).all()), f"(b) text request: {out.shape}")
        require(c_text.counts["mamba2_step"] == (MAIN_NEW_TOKENS - 1) * n_m2,
                f"(b) text: mamba2 steps {c_text.counts}")
        add(l_text)
        print(f"[13 mamba2] (b) Generator on the student, prompt {M2_TEXT_PROMPT}: prefill "
              f"{M2_TEXT_PROMPT / (t_first - t0):.1f} tok/s ({(t_first - t0) * 1e3:.1f} ms incl. "
              f"first token), decode {(MAIN_NEW_TOKENS - 1) / (t_end - t_first):.2f} tok/s "
              f"({MAIN_NEW_TOKENS - 1} steps, B 1); launches {l_text}; SSD scans / steps "
              f"{c_text.counts} on '{card}'", flush=True)
        # the spy and the run's list hold the student, whose frozen leaves are
        # the teacher's: both go before (c) measures its peaks
        del g, served, student, teacher, shared, frozen, trained, r1, students, conv
        _free()

        # (c) the LoRA variants at 3B (the deployed SWA + DeltaNet model)
        data_dir = os.path.join(root, "long")
        _long_text_dataset(data_dir, LORA_VARIANT_T)
        d_args = _train_args(os.path.join(root, "dora"), cutoff_len=LORA_VARIANT_T,
                             max_steps=DORA_STEPS, dataset="demo_long", dataset_dir=data_dir,
                             finetuning_type="lora", lora_rank=8, lora_alpha=16, remat=True,
                             use_dora=True)
        remat_launches = {"swa_train_flash_attention": 2 * n_swa,
                          "swa_train_flash_attention_bwd": n_swa,
                          "delta_rule_chunk_fused": 2 * n_lin}
        bases, adapters = [], []
        real_train = T.Trainer.train

        def keep(trainer, *a, **kw):
            bases.append(trainer.extra[0])
            adapters.append(trainer.params)
            return real_train(trainer, *a, **kw)

        with _Spy(T.Trainer, "train", replace=keep):
            rd = _long_recipe(f"(c) DoRA, r 8 on q/k/v/o, remat, cutoff {LORA_VARIANT_T}",
                              d_args, card, remat_launches, tag="13 mamba2")
        add(rd["launches"])
        params = bases[0]
        n_m = sum(k.endswith("/m") for k, _ in tree_leaves_with_path(adapters[0]))
        d_cfg = T.build_config(d_args)
        data = T.build_dataset(d_args, resolve_tokenizer(d_args, d_cfg, None), cfg=d_cfg)
        batch = next(iter(T._batches(d_args, data, d_cfg, False)))
        batch.pop("_n_tokens")
        tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        with torch.no_grad():
            base_loss = float(sft_loss_fn(
                params["text"], tc, tb["input_ids"], tb["labels"], tb["position_ids"],
                tb["segment_ids"], segment_layout=read_segment_layout(batch["segment_ids"])))
        gap = abs(rd["losses"][0] - base_loss) / abs(base_loss)
        require(n_m == 4 * n and gap <= BF16_TOL,
                f"(c) DoRA: {n_m} magnitudes; first loss {rd['losses'][0]} against the base's "
                f"{base_loss} (relative gap {gap:.3g}, tol {BF16_TOL})")
        print(f"[13 mamba2] (c) DoRA: {n_m} magnitudes trained beside a and b; the first loss "
              f"{rd['losses'][0]:.6f} against the base model's {base_loss:.6f} (relative gap "
              f"{gap:.3g}, tol {BF16_TOL}: m = ||W||_col and b = 0 make the base's forward) on "
              f"'{card}'", flush=True)
        del bases, adapters, data
        _free()

        # PiSSA on the first PISSA_LAYERS layers: the SVDs timed on their own
        svd_s = []

        def timed_svd(w, rank, real=L._principal):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(w, rank)
            torch.cuda.synchronize()
            svd_s.append(time.perf_counter() - t0)
            return out

        c_p = dataclasses.replace(tc, num_hidden_layers=PISSA_LAYERS,
                                  layer_types=tc.layer_types[:PISSA_LAYERS])
        cfg_p = dataclasses.replace(cfg, text=c_p)
        text = {**params["text"], "layers": params["text"]["layers"][:PISSA_LAYERS]}
        t0 = time.perf_counter()
        with _Spy(L, "_principal", replace=timed_svd):
            residual, ad = L.pissa_decompose(text, None, rank=8, alpha=16.0)
        torch.cuda.synchronize()
        t_pissa = time.perf_counter() - t0
        n_svd = len(svd_s)
        pids = torch.as_tensor(np.random.RandomState(14).randint(0, tc.vocab_size - 8, (1, 64)),
                               device=dev)
        ppos = torch.arange(64, device=dev)[None, None].expand(3, 1, 64).contiguous()
        with torch.no_grad():
            merged = L.apply_lora(residual, ad, 16.0, 8)
            # the kernels back: W - P rounded to bf16, plus P, rounded again:
            # W within two bf16 roundings (2^-8 relative each)
            e_w = max(err_ratio(merged["layers"][i][k]["kernel"], lp[k]["kernel"])
                      for i, lp in enumerate(text["layers"]) for k in L.TARGETS)
            # the logits' yardstick: the base with every q/k/v/o kernel moved by
            # one bf16 rounding's worth (uniform in +-2^-8 relative)
            noise = torch.Generator(device=dev).manual_seed(15)
            nudged = {**text, "layers": [
                {**lp, **{k: {**lp[k], "kernel": (lp[k]["kernel"].float() * (1 + 2.0**-8 * (
                    2 * torch.rand(lp[k]["kernel"].shape, generator=noise, device=dev) - 1))
                    ).to(lp[k]["kernel"].dtype)} for k in L.TARGETS}}
                for lp in text["layers"]]}
            want, _ = forward({"text": text}, cfg_p, pids, ppos)
            e_ref = err_ratio(forward({"text": nudged}, cfg_p, pids, ppos)[0], want)
            del nudged
            back, _ = forward({"text": merged}, cfg_p, pids, ppos)
            side, _ = forward({"text": L.attach_lora(residual, ad, 16.0, 8)}, cfg_p, pids, ppos)
        e_back, e_side = err_ratio(back, want), err_ratio(side, want)
        require(n_svd == 4 * PISSA_LAYERS and e_w <= 2.0**-8 and max(e_back, e_side) <= 2 * e_ref,
                f"(c) PiSSA: {n_svd} SVDs; kernels back err_ratio {e_w:.3g} (tol 2^-8); logits "
                f"err_ratio merged {e_back:.3g}, attached {e_side:.3g} against the base's, "
                f"beyond twice one bf16 rounding's {e_ref:.3g}")
        del merged, want, back, side
        tx = make_optimizer(1e-4)
        step = L.make_lora_sft_step(c_p, tx, alpha=16.0, rank=8, remat=True)
        p_sums = _checksum(residual)

        def one_step(base, adapter, what):
            _free()
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, loss = step(adapter, tx.init(adapter), base, dict(batch))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = _read_launches(("swa_train_flash_attention", "delta_rule_chunk_fused"))
            launches["swa_train_flash_attention_bwd"] = h.launches_bwd
            require(np.isfinite(float(loss)), f"(c) {what}: loss {float(loss)}")
            add(launches)
            return float(loss), ms, torch.cuda.max_memory_allocated() / 1e9, launches

        l_p, ms_p, pk_p, la_p = one_step(residual, ad, "PiSSA")
        require(_checksum(residual) == p_sums, "(c) PiSSA: the residual base changed")
        print(f"[13 mamba2] (c) PiSSA: pissa_decompose on layers 0-{PISSA_LAYERS - 1} (q/k/v/o, "
              f"r 8, alpha 16): {n_svd} SVDs (fp32, torch.linalg.svd) in {sum(svd_s):.2f} s of "
              f"the call's {t_pissa:.2f} s; apply_lora(residual, adapter)'s kernels against "
              f"the base's: worst err_ratio {e_w:.3g} (two bf16 roundings: tol 2^-8); logits of "
              f"a 64-token prompt against the base's, merged err_ratio {e_back:.3g}, attached "
              f"{e_side:.3g}, where one bf16 rounding of the same kernels moves them "
              f"{e_ref:.3g} (tol twice that); one make_lora_sft_step at {LORA_VARIANT_T}: loss {l_p:.6f}, "
              f"{ms_p:.0f} ms (the first step), peak {pk_p:.2f} GB, launches H fwd "
              f"{la_p['swa_train_flash_attention']} bwd {la_p['swa_train_flash_attention_bwd']}, "
              f"C {la_p['delta_rule_chunk_fused']}; the residual base bit-unchanged on '{card}'",
              flush=True)
        del residual, ad
        _free()

        # LoftQ on the first LOFTQ_LAYERS layers at 3B width
        roles = tuple(tc.layer_role(i) for i in range(LOFTQ_LAYERS))
        c4 = dataclasses.replace(tc, num_hidden_layers=LOFTQ_LAYERS, layer_types=roles)
        sub = {**text, "layers": text["layers"][:LOFTQ_LAYERS]}
        svd_s.clear()
        t0 = time.perf_counter()
        with _Spy(L, "_principal", replace=timed_svd):
            qbase, ad = L.loftq_init(sub, rank=8, alpha=16.0, iters=LOFTQ_ITERS)
        torch.cuda.synchronize()
        t_loftq = time.perf_counter() - t0
        worst, n_k = 0.0, 0
        for i in range(LOFTQ_LAYERS):
            for k in L.TARGETS:
                w = sub["layers"][i][k]["kernel"].float()
                deq = dequantize_kernel(qbase["layers"][i][k], torch.float32)
                ab = (ad["layers"][i][k]["a"] @ ad["layers"][i][k]["b"]).detach()
                err = float(torch.linalg.norm(w - deq - L.lora_scale(16.0, 8) * ab))
                plain = float(torch.linalg.norm(w - dequantize_kernel(quantize_kernel(w),
                                                                      torch.float32)))
                require(err < plain, f"(c) LoftQ layer {i} {k}: ||W - (deq(Q) + s a b)||_F "
                                     f"{err:.5g} not below plain int8's {plain:.5g}")
                worst, n_k = max(worst, err / plain), n_k + 1
        step = L.make_lora_sft_step(c4, tx, alpha=16.0, rank=8, remat=True)
        l_q, ms_q, pk_q, la_q = one_step(qbase, ad, "LoftQ")
        print(f"[13 mamba2] (c) LoftQ: loftq_init on layers 0-{LOFTQ_LAYERS - 1} ({roles}) at "
              f"3B width, r 8, alpha 16, {LOFTQ_ITERS} rounds: {len(svd_s)} SVDs in "
              f"{sum(svd_s):.2f} s of the call's {t_loftq:.2f} s; on all {n_k} target kernels "
              f"||W - (deq(Q) + s a b)||_F below plain int8's ||W - deq(quant(W))||_F (largest "
              f"ratio {worst:.4f}); one make_lora_sft_step of the {LOFTQ_LAYERS}-layer int8 "
              f"model at {LORA_VARIANT_T}: loss {l_q:.6f}, {ms_q:.0f} ms, peak {pk_q:.2f} GB, "
              f"launches H fwd {la_q['swa_train_flash_attention']} bwd "
              f"{la_q['swa_train_flash_attention_bwd']}, C {la_q['delta_rule_chunk_fused']} on "
              f"'{card}'", flush=True)
        del qbase, ad, sub, params, text, batch, tb
    finally:
        shutil.rmtree(root, ignore_errors=True)
        _free()
    total.setdefault("swa_train_flash_attention_bwd", 0)
    print(f"[13 mamba2] phase 13 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return total


# ---------------------------------------------------------------- phase 14 (parallel)

PAR_SMALL_STEPS = 2  # phase 4's parallel part: two run_sft steps, fsdp, packed rows
PAR_TOL = 1e-4  # its losses and weights, two ranks against one process (fp32)
PAR_STEPS = 2  # phase 14's runs
PAR_DT_ROWS = 2048  # (a): packed rows (the recipe's 8,192, cut to fit the script's time)
PAR_DT_TOL = (2e-3, 1e-2)  # (a): step 1's and step 2's loss, relative (bf16)
PAR_DT_LEAF_TOL = 1e-2  # (a): the trainable leaves after step 1, err_ratio
PAR_SHORT_LAYERS = 4  # (a) and (b): their depth (the script's time budget's)
PAR_REPL_TOL = 1e-3  # (b): replicated against fsdp losses at that depth
PAR_DEADLINE = 900.0  # seconds a world of ranks may take before it is killed


class _StepHook:
    """Wraps a module's step factory for the duration of a `with`: the step
    it makes calls `after(step_no, params, opt_state)` after each step, on
    every rank (the hook may run collectives: every rank reaches it at the
    same step)."""

    def __init__(self, module, name, after):
        self.module, self.name, self.after = module, name, after

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def factory(*a, **kw):
            step = self.real(*a, **kw)
            count = [0]

            def wrapped(params, opt_state, *rest):
                out = step(params, opt_state, *rest)
                count[0] += 1
                self.after(count[0], params, opt_state)
                return out

            return wrapped

        setattr(self.module, self.name, factory)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def _trainer_records(T, run):
    """run() with T.Trainer.save (and a pipelined run's) replaced (no train
    state written) and the Trainer kept: (run's result, the trainer's step
    records)."""
    trainers = []
    real_train, real_save = T.Trainer.train, T.Trainer.save

    def train(self, *a, **kw):
        trainers.append(self)
        return real_train(self, *a, **kw)

    real_pp_save = T._PipeTrainer.save  # a pipelined run's save gathers the stages first
    T.Trainer.train, T.Trainer.save = train, lambda self: None
    T._PipeTrainer.save = lambda self: None
    try:
        out = run()
    finally:
        T.Trainer.train, T.Trainer.save = real_train, real_save
        T._PipeTrainer.save = real_pp_save
    return out, [r for r in trainers[0].log.records if "loss" in r]


def _step_ms(recs) -> list:
    """Per-step wall ms from the trainer's clock (step 1 from its start)."""
    t = [0.0] + [r["elapsed_s"] for r in recs]
    return [round((b - a) * 1e3, 1) for a, b in zip(t, t[1:])]


def _cut_3b(layers: int):
    import dataclasses

    from infinitevl_tpu_torch.config import infinitevl_3b

    cfg = infinitevl_3b()
    return dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, num_hidden_layers=layers, layer_types=cfg.text.layer_types[:layers]))


def _par_small(job, T):
    """Phase 4's parallel part on one rank (or in one process): run_sft on
    the small fp32 model, fsdp, packed rows."""
    from infinitevl_tpu_torch.train.step import tree_leaves_with_path

    real = T.tiny_config
    T.tiny_config = _small_config
    try:
        final, recs = _trainer_records(T, lambda: T.run_sft(_train_args(**job["args"])))
    finally:
        T.tiny_config = real
    return dict(losses=[r["loss"] for r in recs],
                final={k: v.detach().cpu() for k, v in tree_leaves_with_path(final)})


def _par_stage1(job, T, dev):
    """Phase 14 (a) and phase 15 (b) on one rank, or in one process: stage 1
    of train_3b_stage1.yaml at 3B width (job["layers"] deep, default 36);
    the teacher from seed 0 in memory, Trainer.save replaced."""
    import dataclasses

    from infinitevl_tpu_torch.models.params import init_params
    from infinitevl_tpu_torch.parallel.sharding import (
        gather_leaf,
        gather_opt_state,
        local_bytes,
        world_rank,
    )
    from infinitevl_tpu_torch.train.step import trainable_leaves

    layers = job.get("layers", 36)
    cfg = _cut_3b(layers)
    teacher_cfg = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, layer_types=("full_attention",) * cfg.text.num_hidden_layers))
    held = {}

    def check(margs, _out):  # after the shards exist, before step 1
        held["student"], held["teacher"] = margs[0], margs[2]
        held["before"] = _checksum(margs[2])

    def after(step_no, student, opt_state):
        """After step 1: the trainable leaves and their first moments (the
        step's clipped global gradients x (1 - b1)), gathered, to rank 0's file."""
        if step_no != 1 or job["step1_file"] is None:
            return
        named = trainable_leaves(student)
        with torch.no_grad():
            leaves = {k: gather_leaf(v).detach() for k, v in named}
            mu = gather_opt_state(opt_state, [v for _, v in named], keys=("mu",))["mu"]
        if world_rank() == 0:
            torch.save({"leaves": {k: v.cpu() for k, v in leaves.items()},
                        "mu": {k: m.cpu() for (k, _), m in zip(named, mu)}}, job["step1_file"])
        del leaves, mu

    args = _dt_args(job)
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    real_cfg = T.infinitevl_3b
    T.infinitevl_3b = lambda: cfg
    try:
        with _Spy(T, "apply_trainable_mask", check), _StepHook(T, "make_stage1_step", after):
            # the teacher is made in the call: no reference here keeps it whole
            final, recs = _trainer_records(T, lambda: T.run_dt(
                args, teacher_params=init_params(teacher_cfg,
                                                 torch.Generator(device=dev).manual_seed(0)),
                teacher_cfg=teacher_cfg.text))
    finally:
        T.infinitevl_3b = real_cfg
    del final
    torch.cuda.synchronize()
    out = dict(losses=[r["loss"] for r in recs], step_ms=_step_ms(recs),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9, launches=_launch_counts(),
               unchanged=_checksum(held["teacher"]) == held["before"],
               n_teacher=len(held["before"]))
    out["held_bytes"], out["whole_bytes"] = local_bytes([held["teacher"], held["student"]])
    return out


def _dt_args(job):
    import os

    from infinitevl_tpu_torch.hparams import load_yaml_args

    here = os.path.dirname(os.path.abspath(__file__))
    args = load_yaml_args(os.path.join(here, "examples", "train_3b_stage1.yaml"))
    for group, key, val in ((args.finetune, "mixer", job.get("mixer", args.finetune.mixer)),
                            (args.train, "data_parallel", job["data_parallel"]),
                            (args.train, "model_parallel", job.get("model_parallel", 1)),
                            (args.train, "param_mode", job.get("param_mode", "fsdp")),
                            (args.train, "per_device_train_batch_size", job["per_device"]),
                            (args.train, "max_steps", PAR_STEPS),
                            # the recipe's 100 warm-up steps leave step 1's rate at 0
                            (args.train, "warmup_steps", 0),
                            (args.train, "logging_steps", 1),
                            (args.train, "save_steps", 10**6),
                            (args.train, "output_dir", job["out"]),
                            (args.data, "cutoff_len", job.get("rows", PAR_DT_ROWS)),
                            (args.data, "dataset", "demo_packed"),
                            (args.data, "dataset_dir", job["data_dir"])):
        setattr(group, key, val)
    return args


def _launch_counts() -> dict:
    from infinitevl_tpu_torch.ops.swa_kernels import swa_train_flash_attention as h

    out = {k.__name__: k.launches for k in _kernel_wrappers()}
    out["swa_train_flash_attention_bwd"] = h.launches_bwd
    return out


def _par_full(job, T):
    """(b) on one rank: run_sft full finetuning at T 2,048 on data/demo.json
    streamed, fsdp and replicated at PAR_SHORT_LAYERS (PAR_STEPS);
    Trainer.save replaced."""
    from infinitevl_tpu_torch.parallel.sharding import local_bytes

    runs = {}
    real_cfg = T.infinitevl_3b
    for name, layers, mode, steps in (
            (f"fsdp_{PAR_SHORT_LAYERS}", PAR_SHORT_LAYERS, "fsdp", PAR_STEPS),
            (f"replicated_{PAR_SHORT_LAYERS}", PAR_SHORT_LAYERS, "replicated", PAR_STEPS)):
        T.infinitevl_3b = lambda layers=layers: _cut_3b(layers)
        held = {}
        real_init = T.Trainer.__init__

        def init(self, step_fn, params, *a, **kw):
            held["params"] = params
            real_init(self, step_fn, params, *a, **kw)

        T.Trainer.__init__ = init
        _free()
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        try:
            final, recs = _trainer_records(T, lambda: T.run_sft(_train_args(
                f"{job['out']}/{name}", cutoff_len=2048, max_steps=steps, remat=True,
                learning_rate=1e-5, dataset="demo", dataset_dir=job["repo_data"],
                streaming=True, packing=False, data_parallel=2, param_mode=mode)))
        finally:
            T.infinitevl_3b, T.Trainer.__init__ = real_cfg, real_init
        torch.cuda.synchronize()
        held_b, whole_b = local_bytes(held.pop("params"))
        del final
        runs[name] = dict(losses=[r["loss"] for r in recs], step_ms=_step_ms(recs),
                          peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                          launches=_launch_counts(), held_bytes=held_b, whole_bytes=whole_b,
                          layers=layers, steps=steps)
    return runs


def _par_rank(rank, world, job):
    """One rank of a spawned world of phases 14-16 (phase 14's also runs phase
    4's two-rank steps; module level, so that the spawned process can import
    it): its job on cuda:0, its results."""
    from infinitevl_tpu_torch.train import trainer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if job["kind"] == "phase14":  # phase 4's two-rank steps, (a), (b), then (d), in one world
        return dict(small=_par_small({"args": job["small"]}, T),
                    stage1=_par_stage1(job, T, dev), full=_par_full(job, T),
                    sliced={name: _sliced_run(job, T, name, 2, 1, "fsdp", 2)
                            for name in PAR_SLICED})
    if job["kind"] == "nccl":
        return _par_nccl(dev)
    if job["kind"] == "tp2":  # phase 15 (a), (b), (d), (e), in one world
        return _tp_world2(job, T, dev)
    if job["kind"] == "tp4":  # phase 15 (c)
        return dict(full=_tp_full(job, T, TP_SHORT_LAYERS, "fsdp", 2, 2))
    if job["kind"] == "pp3":  # phase 16
        return _pp_world(job, T, dev)
    raise ValueError(job["kind"])


def _par_nccl(dev):
    """(c) in a world of one NCCL rank: the port's collectives on one 3B
    layer's leaves, each result bit-equal to its input."""
    import torch.distributed as dist

    from infinitevl_tpu_torch.models.params import init_text_params
    from infinitevl_tpu_torch.parallel.sharding import (
        Mesh,
        ShardInfo,
        all_reduce_sum,
        gather_leaf,
        global_sum,
        param_spec,
        use_mesh,
    )
    from infinitevl_tpu_torch.train.step import tree_leaves_with_path

    cfg = _cut_3b(2)
    layers = init_text_params(cfg.text, torch.Generator(device=dev).manual_seed(0),
                              dev)["layers"]
    checks, n_bytes = {"gather": 0, "reduce_scatter": 0, "all_reduce": 0}, 0
    for i, lp in enumerate(layers):  # one SWA layer and one DeltaNet layer
        for path, leaf in tree_leaves_with_path(lp, f"text/layers/{i}"):
            spec = param_spec(path, leaf.shape, 2, 1, "fsdp")
            dim = spec.index("data") if "data" in spec else 0
            x = leaf.detach().clone().requires_grad_(True)
            x._ivl_shard = ShardInfo(dim, int(leaf.shape[dim]), 1, 0)
            full = gather_leaf(x)  # all_gather forward
            g = torch.randn_like(full)
            (gx,) = torch.autograd.grad(full, x, g)  # reduce_scatter backward
            summed = all_reduce_sum(g)
            checks["gather"] += torch.equal(full.detach(), leaf)
            checks["reduce_scatter"] += torch.equal(gx, g)
            checks["all_reduce"] += torch.equal(summed, g)
            n_bytes += leaf.numel() * leaf.element_size()
    n = sum(1 for _ in tree_leaves_with_path(layers))
    count = torch.tensor(12345, device=dev)
    with use_mesh(Mesh(1, 1, 0)):
        same_count = torch.equal(global_sum(count), count)  # one rank: no reduce
    checks["count"] = torch.equal(all_reduce_sum(count), count)
    torch.cuda.synchronize()
    return dict(checks=checks, leaves=n, bytes=n_bytes, same_count=same_count,
                backend=dist.get_backend(), nccl=".".join(map(str, torch.cuda.nccl.version())))


def _par_small_job(root: str) -> dict:
    """Phase 4's parallel part, made ready under `root`: the packed rows and
    the run_sft arguments of the small fp32 model (fsdp), for the two ranks
    (`two`, data_parallel 2) and for one process (`common` + the global batch)."""
    data_dir = os.path.join(root, "small_data")
    _packed_text_dataset(data_dir, n=14)
    common = dict(config_preset="tiny", bf16=False, cutoff_len=1024, packing=True,
                  dataset="demo_packed", dataset_dir=data_dir, max_steps=PAR_SMALL_STEPS,
                  learning_rate=1e-3, param_mode="fsdp")
    return {"root": root, "common": common,
            "two": dict(out_dir=os.path.join(root, "small_two"), data_parallel=2, **common)}


def phase_parallel_cross_device(dev, small: dict, two: list, t_world: float) -> None:
    """Phase 4's parallel part: two gloo ranks on the card ran two run_sft
    steps (fsdp, packed rows, the small fp32 model; `two`, their results),
    held here against the same steps in one process at the global batch:
    losses, then the weights, within PAR_TOL (leaves zero before the steps
    are reported, not held). The ranks' half runs first in phase 14's world
    of two, so the run starts one world fewer (each rank of a world is a
    fresh interpreter)."""
    from infinitevl_tpu_torch.models.params import init_text_params
    from infinitevl_tpu_torch.train import trainer as T
    from infinitevl_tpu_torch.train.step import tree_leaves_with_path

    root, common = small["root"], small["common"]
    one = _par_small({"args": dict(out_dir=os.path.join(root, "one"),
                                   per_device_train_batch_size=2, **common)}, T)
    l1, l2 = one["losses"], two[0]["losses"]
    e_loss = max(abs(a - b) / abs(a) for a, b in zip(l1, l2))
    require(len(l1) == len(l2) == PAR_SMALL_STEPS and e_loss <= PAR_TOL,
            f"phase 4 parallel: losses {l2} against one process's {l1}")
    require(all(torch.equal(two[0]["final"][k], two[1]["final"][k]) for k in one["final"]),
            "phase 4 parallel: the ranks returned different weights")
    # run_sft's weights: the seed's on the card (zero leaves: the biases)
    start = init_text_params(_small_config().text, torch.Generator(device=dev).manual_seed(0),
                             dev, torch.float32)
    zero = {k for k, v in tree_leaves_with_path({"text": start}) if not v.abs().sum()}
    errs = {k: err_ratio(two[0]["final"][k], v) for k, v in one["final"].items()}
    e_par = max(e for k, e in errs.items() if k not in zero)
    e_zero = max((e for k, e in errs.items() if k in zero), default=0.0)
    require(e_par <= PAR_TOL, f"phase 4 parallel: weights err_ratio {e_par:.3g}")
    print(f"[4 cross-device] two gloo ranks on the card, {PAR_SMALL_STEPS} run_sft steps, "
          f"fsdp, packed rows (cutoff 1,024, one row a rank), fp32 small model, against one "
          f"process at the same global batch of 2 rows, tol {PAR_TOL}: losses {l2} (one "
          f"process {l1}, err {e_loss:.2g}), weights err_ratio {e_par:.2g} over "
          f"{len(errs) - len(zero)} leaves (zero before the steps, the update alone: "
          f"{e_zero:.2g}, not held); the ranks' weights bit-equal; run first in phase "
          f"14's world of two, which took {t_world:.1f} s", flush=True)


def phase_parallel_path(dev, card: str) -> tuple:
    """Phase 14 at 3B, one world of two gloo ranks sharing the card for (a)
    and (b): (a) stage 1 of examples/train_3b_stage1.yaml (data_parallel 8
    -> 2, fsdp, PAR_STEPS steps on packed rows of PAR_DT_ROWS), against the
    same steps in one process at per_device_train_batch_size 2; (b) full
    finetuning through run_sft at T 2,048 on data/demo.json streamed, fsdp
    and replicated at PAR_SHORT_LAYERS (PAR_STEPS; a 36-layer fsdp run's
    18.91 GB peak a rank is in PERF.md §6); (c) the port's collectives in a
    world of one NCCL rank. Returns
    the launches of (a) and (b), summed over the ranks, and (b)'s
    replicated losses (phase 15 (c) is held against them)."""
    import os
    import shutil
    import tempfile

    from infinitevl_tpu_torch.parallel.launch import spawn_ranks
    from infinitevl_tpu_torch.train import trainer as T
    from infinitevl_tpu_torch.train.step import trainable_leaves

    t_phase = time.perf_counter()
    tc = _cut_3b(PAR_SHORT_LAYERS).text  # (a)'s depth
    n, n_swa, n_lin = tc.num_hidden_layers, tc.num_swa_layers, tc.num_linear_layers
    root = tempfile.mkdtemp(prefix="ivl_par_")
    here = os.path.dirname(os.path.abspath(__file__))
    data_dir = os.path.join(root, "packed")
    _packed_text_dataset(data_dir, n=90)
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    try:
        step1 = os.path.join(root, "step1_two.pt")
        small = _par_small_job(root)
        t0 = time.perf_counter()
        world = spawn_ranks(_par_rank, 2, ({
            "kind": "phase14", "data_parallel": 2, "per_device": 1, "data_dir": data_dir,
            "layers": n, "out": os.path.join(root, "ranks"), "step1_file": step1,
            "repo_data": os.path.join(here, "data"), "small": small["two"]},),
            device="cuda:0", timeout=PAR_DEADLINE)
        t_world = time.perf_counter() - t0
        phase_parallel_cross_device(dev, small, [w["small"] for w in world], t_world)
        two, full = [w["stage1"] for w in world], [w["full"] for w in world]

        # (a) the same two steps in one process at the global batch
        _free()
        ref = {}

        def after_one(step_no, student, opt_state):
            if step_no == 1:
                named = trainable_leaves(student)
                ref["leaves"] = {k: v.detach().clone() for k, v in named}
                ref["mu"] = {k: m.clone() for (k, _), m in zip(named, opt_state["mu"])}

        with _StepHook(T, "make_stage1_step", after_one):
            one = _par_stage1({"data_parallel": 1, "per_device": 2, "layers": n,
                               "out": os.path.join(root, "a1"),
                               "data_dir": data_dir, "step1_file": None}, T, dev)
        got = torch.load(step1, map_location=dev, weights_only=True)
        os.remove(step1)
        e_leaf = max(err_ratio(got["leaves"][k], v) for k, v in ref["leaves"].items())
        e_mu = max(err_ratio(got["mu"][k], v) for k, v in ref["mu"].items() if v.abs().sum())
        n_leaves = len(ref["leaves"])
        del got, ref
        _free()
        l2, l1 = two[0]["losses"], one["losses"]
        e_l = [abs(a - b) / abs(b) for a, b in zip(l2, l1)]
        require(len(l2) == len(l1) == PAR_STEPS and all(e <= t for e, t in zip(e_l, PAR_DT_TOL)),
                f"(a) losses over two ranks {l2} against one process {l1} (tol {PAR_DT_TOL})")
        require(e_leaf <= PAR_DT_LEAF_TOL and e_mu <= PAR_DT_LEAF_TOL,
                f"(a) after step 1: trainable leaves err_ratio {e_leaf:.3g}, first moments "
                f"{e_mu:.3g}")
        require(all(r["unchanged"] for r in two) and one["unchanged"],
                "(a) the teacher changed on a rank")
        expect = {"swa_train_flash_attention": (n + n_swa) * PAR_STEPS,
                  "swa_train_flash_attention_bwd": 0, "delta_rule_chunk_fused": n_lin * PAR_STEPS}
        for r, res in enumerate(two):
            require(2 * res["held_bytes"] == res["whole_bytes"],
                    f"(a) rank {r} holds {res['held_bytes']} of {res['whole_bytes']} bytes")
            got_l = {k: res["launches"][k] for k in expect}
            require(got_l == expect, f"(a) rank {r} launches {got_l}, expected {expect}")
            add(res["launches"])
        print(f"[14 parallel] (a) stage 1 of train_3b_stage1.yaml at 3B ({n} layers, the "
              f"teacher the all-full_attention twin with the ViT, data_parallel 8 -> 2, fsdp, "
              f"warm-up 100 -> 0, {PAR_STEPS} steps on packed rows of {PAR_DT_ROWS}, one row a "
              f"rank), two gloo ranks sharing the card: losses {[round(x, 6) for x in l2]}, one "
              f"process at per_device_train_batch_size 2: {[round(x, 6) for x in l1]} "
              f"(relative err {[float(f'{e:.2g}') for e in e_l]}, tol {PAR_DT_TOL}); after "
              f"step 1 the {n_leaves} trainable leaves err_ratio {e_leaf:.2g} and their first "
              f"moments (the clipped global "
              f"gradients x 0.1) err_ratio {e_mu:.2g} (tol {PAR_DT_LEAF_TOL}); the teacher's "
              f"{two[0]['n_teacher']} leaves bit-unchanged on each rank (checksums of its "
              f"shards)", flush=True)
        for r, res in enumerate(two):
            print(f"[14 parallel] (a) rank {r}: ms per step {res['step_ms']} (step 1 from "
                  f"the trainer's start), peak {res['peak_gb']:.2f} GB (max_memory_allocated "
                  f"in its process), holds {res['held_bytes'] / 1e9:.3f} GB of the sharded "
                  f"leaves' {res['whole_bytes'] / 1e9:.3f} GB (exactly half), H fwd / bwd / C "
                  f"launches {[res['launches'][k] for k in expect]}; two ranks share the "
                  f"card's SMs and memory and move the gathers through gloo on the host: these "
                  f"step times are not data parallelism's speed; on '{card}'", flush=True)
        print(f"[14 parallel] (a) one process: ms per step {one['step_ms']}, peak "
              f"{one['peak_gb']:.2f} GB on '{card}'", flush=True)

        # (b) full finetuning over the same two ranks
        short = f"fsdp_{PAR_SHORT_LAYERS}", f"replicated_{PAR_SHORT_LAYERS}"
        lf, lr = full[0][short[0]]["losses"], full[0][short[1]]["losses"]
        e_r = max(abs(a - b) / abs(a) for a, b in zip(lf, lr))
        require(len(lf) == len(lr) == PAR_STEPS and e_r <= PAR_REPL_TOL,
                f"(b) replicated losses {lr} against fsdp {lf} at {PAR_SHORT_LAYERS} layers")
        for name, res0 in full[0].items():
            layers, steps = res0["layers"], res0["steps"]
            n_swa_l = sum(1 for t in _cut_3b(layers).text.layer_types if t != "linear_attention")
            expect_b = {"swa_train_flash_attention": 2 * n_swa_l * steps,
                        "swa_train_flash_attention_bwd": n_swa_l * steps,
                        "delta_rule_chunk_fused": 2 * (layers - n_swa_l) * steps}
            for r in range(2):
                res = full[r][name]
                got_l = {k: res["launches"][k] for k in expect_b}
                require(got_l == expect_b, f"(b) {name} rank {r} launches {got_l}, "
                                           f"expected {expect_b}")
                require(len(res["losses"]) == steps and np.isfinite(res["losses"]).all(),
                        f"(b) {name}: losses {res['losses']}")
                if name.startswith("fsdp"):
                    require(2 * res["held_bytes"] == res["whole_bytes"],
                            f"(b) {name} rank {r} holds {res['held_bytes']} of "
                            f"{res['whole_bytes']} bytes")
                add(res["launches"])
                print(f"[14 parallel] (b) {name} ({layers} layers, {steps} step(s), full "
                      f"finetuning, T 2,048, "
                      f"data/demo.json streamed, padded rows, remat) rank {r}: losses "
                      f"{[round(x, 6) for x in res['losses']]}, ms per step {res['step_ms']}, "
                      f"peak {res['peak_gb']:.2f} GB, holds "
                      f"{res['held_bytes'] / 1e9:.3f} GB of the params' sharded "
                      f"{res['whole_bytes'] / 1e9:.3f} GB; on '{card}'", flush=True)
        print(f"[14 parallel] (b) replicated against fsdp at {PAR_SHORT_LAYERS} layers: losses "
              f"{lr} / {lf}, relative err {e_r:.2g} (tol {PAR_REPL_TOL}); the world of (a), "
              f"(b) and (d) took {t_world:.1f} s (spawn, weights, datasets, steps)", flush=True)

        # (d) DoRA, GaLore, APOLLO and Adam-mini on FSDP slices against one process
        missed = []

        def hold(ok: bool, what: str) -> None:
            if not ok:
                missed.append(what)
                print(f"[14 parallel] CHECK FAILED: {what}", flush=True)

        job = {"out": os.path.join(root, "one"), "repo_data": os.path.join(here, "data")}
        one_d = {name: _sliced_run(job, T, name, 1, 1, "fsdp", 2) for name in PAR_SLICED}
        _sliced_hold(hold, "[14 parallel] (d)", {n: [w["sliced"][n] for w in world]
                                                 for n in one_d}, one_d, card, add)
        require(not missed, "phase 14 (d): " + "; ".join(missed))

        # (c) the port's collectives on NCCL, a world of one
        nc = spawn_ranks(_par_rank, 1, ({"kind": "nccl"},), backend="nccl", device="cuda:0",
                         timeout=PAR_DEADLINE)[0]
        require(nc["backend"] == "nccl" and all(v == nc["leaves"] for k, v in nc["checks"].items()
                                                if k != "count")
                and nc["checks"]["count"] and nc["same_count"],
                f"(c) NCCL collectives not bit-equal at world 1: {nc}")
        print(f"[14 parallel] (c) a world of one NCCL rank (NCCL {nc['nccl']}): the layer "
              f"gather Function forward (all_gather) and backward (reduce_scatter), the "
              f"gradient all_reduce and the global-count all_reduce on the {nc['leaves']} "
              f"leaves of one SWA and one DeltaNet 3B layer ({nc['bytes'] / 1e6:.1f} MB), each "
              f"bit-equal to its input; a world above one on NCCL needs a machine with more "
              f"than one card", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[14 parallel] phase 14 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return total, lr


# phase 15: tensor parallelism at 3B, two gloo ranks sharing the card (model 2),
# then four (data 2 x model 2)
TP_STEPS = 2  # (a) and (c): full finetuning steps; (b) stage-1 steps
TP_FULL_LAYERS = 8  # (a): its depth (the script's time budget's)
TP_DT_LAYERS = 4  # (b): stage 1's depth at T 8,192 (the time budget's)
TP_DT_ROWS = 8192
TP_SHORT_LAYERS = PAR_SHORT_LAYERS  # (c), held against phase 14 (b) at its depth, and (d)
TP_PROMPT, TP_NEW = 1000, 16  # (e): prompt tokens, then greedy (fp32) or forced (bf16) steps
TP_F32_LAYERS = 4  # (e) in fp32
TP_BF16_LAYERS = 8  # (e) in bf16 (the script's time budget's)
TP_LOSS_TOL = PAR_DT_TOL  # (a), (c), (d): step 1's and step 2's loss, relative (bf16)
# (a): the fp32 model's gradients of every trainable leaf on two ranks against one
# process, err_ratio (in bf16 at random init both sides move far from the fp32 model's
# numbers, 0.26 to 0.37 err_ratio on the card (PERF.md §6), so the gradients are held in fp32)
TP_GRAD_TOL = 1e-2
# (e): fp32, two ranks against one process; bf16, two ranks' logits against the fp32
# model's within this of one bf16 process's own
TP_LOGIT_TOL = {torch.float32: 1e-3, torch.bfloat16: 1e-2}


class _CollectiveClock:
    """Times every torch.distributed.all_reduce of this process for the
    duration of a `with` (the host clock around the call, a device sync
    before it, so the time is the collective's own): calls, seconds and
    bytes, the head's partial logits (last dim `vocab`) apart from the
    rest (the layers' sums, the gradients' and counts')."""

    def __init__(self, vocab: int):
        self.vocab, self.calls = vocab, {"head": [0, 0.0, 0], "other": [0, 0.0, 0]}

    def __enter__(self):
        import torch.distributed as dist

        real = self.real = dist.all_reduce

        def timed(t, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(t, *a, **kw)
            c = self.calls["head" if t.ndim and t.shape[-1] == self.vocab else "other"]
            c[0] += 1
            c[1] += time.perf_counter() - t0
            c[2] += t.numel() * t.element_size()
            return out

        dist.all_reduce = timed
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.all_reduce = self.real


def _tp_full_args(job, layers: int, data: int, model: int, mode: str = "tp",
                  bf16: bool = True, steps: int = TP_STEPS):
    return _train_args(
        f"{job['out']}/full_{layers}_{data}x{model}_{bf16}", cutoff_len=2048, max_steps=steps,
        remat=True, learning_rate=1e-5, dataset="demo", dataset_dir=job["repo_data"],
        streaming=True, packing=False, bf16=bf16, data_parallel=data, model_parallel=model,
        param_mode=mode)


def _tp_full(job, T, layers: int, mode: str, data: int, model: int):
    """Full finetuning through run_sft at T 2,048 on data/demo.json streamed
    (remat, lr 1e-5, TP_STEPS steps, bf16), `layers` deep, on a (data,
    model) mesh under `mode` (data x model 1: one process); Trainer.save
    replaced; every all_reduce timed."""
    from infinitevl_tpu_torch.parallel.sharding import local_bytes

    held = {}
    real_init, real_cfg = T.Trainer.__init__, T.infinitevl_3b

    def init(self, step_fn, params, *a, **kw):
        held["params"] = params
        real_init(self, step_fn, params, *a, **kw)

    T.Trainer.__init__, T.infinitevl_3b = init, lambda: _cut_3b(layers)
    _free()
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    clock = _CollectiveClock(_cut_3b(layers).text.vocab_size)
    try:
        with clock:
            final, recs = _trainer_records(T, lambda: T.run_sft(
                _tp_full_args(job, layers, data, model, mode)))
    finally:
        T.Trainer.__init__, T.infinitevl_3b = real_init, real_cfg
    torch.cuda.synchronize()
    held_b, whole_b = local_bytes(held.pop("params"))
    del final
    _free()
    return dict(losses=[r["loss"] for r in recs], step_ms=_step_ms(recs),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9, launches=_launch_counts(),
                held_bytes=held_b, whole_bytes=whole_b, layers=layers, collectives=clock.calls)


def _tp_grads(job, T, dev, model: int, save=None, ref=None):
    """(a)'s gradients in fp32 at TP_FULL_LAYERS: the SFT loss of run_sft's first
    batch (remat) differentiated with respect to every leaf full finetuning
    trains, the weights from the seed as run_sft makes them; in one process
    written whole to `save`, or on `model` ranks under tp held slice by
    slice against `ref`: per leaf (sum |g - ref|, sum |ref|, model-sharded)."""
    from infinitevl_tpu_torch.data.loader import resolve_tokenizer
    from infinitevl_tpu_torch.models.params import init_text_params
    from infinitevl_tpu_torch.parallel.sharding import create_mesh, shard_params, tp_info
    from infinitevl_tpu_torch.train.step import (
        batch_to_device,
        full_finetune_leaf,
        set_trainable,
        sft_loss_fn,
        trainable_leaves,
    )

    _free()
    args = _tp_full_args(job, TP_FULL_LAYERS, 1, model, bf16=False, steps=1)
    real_cfg, T.infinitevl_3b = T.infinitevl_3b, lambda: _cut_3b(TP_FULL_LAYERS)
    try:
        cfg = T.build_config(args)
    finally:
        T.infinitevl_3b = real_cfg
    data = T.build_dataset(args, resolve_tokenizer(args, cfg, None), cfg=cfg)
    b = batch_to_device(next(iter(T._batches(args, data, cfg, False))), dev)
    params = {"text": init_text_params(cfg.text, torch.Generator(device=dev).manual_seed(
        args.train.seed), dev, torch.float32)}
    set_trainable(params, full_finetune_leaf)
    if model > 1:
        params = shard_params(params, create_mesh(1, model), "tp")
    named = trainable_leaves(params)
    loss = sft_loss_fn(params["text"], cfg.text, b["input_ids"], b["labels"], b["position_ids"],
                       b.get("segment_ids"), remat=True, segment_layout=b.get("segment_layout"))
    grads = torch.autograd.grad(loss, [t for _, t in named])
    if save is not None:
        torch.save({k: g.cpu() for (k, _), g in zip(named, grads)}, save)
        return {}
    want, sums = torch.load(ref, map_location="cpu", mmap=True, weights_only=True), {}
    for (k, t), g in zip(named, grads):
        r, info = want[k], tp_info(t)
        if info is not None:
            r = r.narrow(info.dim, info.rank * t.shape[info.dim], t.shape[info.dim])
        r = r.to(dev)
        sums[k] = (float((g - r).abs().sum()), float(r.abs().sum()), info is not None)
    del want, params, grads
    _free()
    return sums


def _tp_mm(job, T, model: int):
    """(d) one multimodal LoRA step through run_sft (TP_SHORT_LAYERS deep, the
    ViT's 32 blocks, data/mllm_demo.json's first image at 448x448, the row
    padded to 512), on `model` ranks (1: one process); Trainer.save replaced."""
    real_cfg = T.infinitevl_3b
    T.infinitevl_3b = lambda: _cut_3b(TP_SHORT_LAYERS)
    _free()
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    try:
        final, recs = _trainer_records(T, lambda: T.run_sft(_train_args(
            f"{job['out']}/mm_{model}", cutoff_len=512, max_steps=1, dataset="mllm_demo",
            dataset_dir=job["repo_data"], max_samples=1, image_min_pixels=448 * 448,
            image_max_pixels=448 * 448, finetuning_type="lora", lora_rank=8, lora_alpha=16,
            remat=True, model_parallel=model, param_mode="tp")))
    finally:
        T.infinitevl_3b = real_cfg
    torch.cuda.synchronize()
    del final
    _free()
    return dict(losses=[r["loss"] for r in recs], step_ms=_step_ms(recs),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9, launches=_launch_counts())


def _tp_forced_tokens():
    return torch.randint(0, 150000, (1, TP_NEW), generator=torch.Generator().manual_seed(7))


def _tp_cached(dev, layers: int, dtype, mesh=None, forced=None) -> dict:
    """(e) the library path on the 3B width, `layers` deep, weights from seed
    0: generation.prefill of a TP_PROMPT-token prompt into a fresh state
    (with `mesh`: the params sharded and the rank's part of the state), then
    TP_NEW decode_step calls, greedy or fed `forced` tokens. The logits of
    the prompt's last token and of each step, the tokens fed, ms of the
    prefill and per step, the state's bytes."""
    from infinitevl_tpu_torch.generation import decode_step, prefill
    from infinitevl_tpu_torch.models.params import init_text_params
    from infinitevl_tpu_torch.models.state import init_decoder_state, state_bytes
    from infinitevl_tpu_torch.parallel.sharding import shard_params

    cfg = _cut_3b(layers)
    params = {"text": init_text_params(cfg.text, torch.Generator(device=dev).manual_seed(0), dev,
                                       dtype)}
    if mesh is not None:
        params = shard_params(params, mesh, "tp")
    state = init_decoder_state(cfg.text, 1, dtype, dev, mesh=mesh)
    ids = torch.randint(0, 150000, (1, TP_PROMPT), generator=torch.Generator().manual_seed(5))
    ids = ids.to(dev)
    pos = torch.arange(TP_PROMPT, device=dev)[None, None].expand(3, 1, TP_PROMPT)
    zero = torch.zeros((1, 1), dtype=torch.long, device=dev)
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = prefill(params, cfg, ids, pos, state)
    torch.cuda.synchronize()
    t_pre = (time.perf_counter() - t0) * 1e3
    out, fed = [logits.float().cpu()], []
    t0 = time.perf_counter()
    for i in range(TP_NEW):
        tok = logits.argmax(-1, keepdim=True) if forced is None else forced[:, i : i + 1].to(dev)
        fed.append(tok.cpu())
        logits, state = decode_step(params, cfg, tok, zero, state)
        out.append(logits.float().cpu())
    torch.cuda.synchronize()
    t_dec = (time.perf_counter() - t0) * 1e3 / TP_NEW
    res = dict(logits=torch.stack(out), tokens=torch.cat(fed, 1), prefill_ms=t_pre,
               decode_ms=t_dec, state_mb=state_bytes(state) / 1e6, launches=_launch_counts())
    del params, state
    _free()
    return res


def _tp_world2(job, T, dev):
    """Phase 15 on one of two ranks (model_parallel 2): (a), (b), (d), (e)."""
    from infinitevl_tpu_torch.parallel.sharding import create_mesh

    out = {"full": _tp_full(job, T, TP_FULL_LAYERS, "tp", 1, 2),
           "grads": _tp_grads(job, T, dev, 2, ref=job["grad_file"])}
    out["stage1"] = _par_stage1({
        "data_parallel": 1, "model_parallel": 2, "param_mode": "tp", "per_device": 1,
        "layers": TP_DT_LAYERS, "rows": TP_DT_ROWS, "data_dir": job["data_dir"],
        "out": f"{job['out']}/stage1", "step1_file": None}, T, dev)
    _free()
    out["mm"] = _tp_mm(job, T, 2)
    mesh = create_mesh(1, 2)
    out["cached"] = {"f32": _tp_cached(dev, TP_F32_LAYERS, torch.float32, mesh),
                     "bf16": _tp_cached(dev, TP_BF16_LAYERS, torch.bfloat16, mesh,
                                        _tp_forced_tokens())}
    out["m2_stage1"] = _par_stage1(_m2_stage1_job(job, 1, 2), T, dev)
    _free()
    out["m2_cached"] = _tp_m2_cached(dev, mesh)
    out["sliced"] = {name: _sliced_run(job, T, name, 1, 2, "tp", 1) for name in TP_SLICED}
    return out


def _m2_stage1_job(job, per_device: int, model: int) -> dict:
    """(f): stage 1 of train_3b_stage1.yaml with mixer mamba2, TP_M2_LAYERS
    deep on packed rows of TP_M2_ROWS, on `model` ranks (1: one process)."""
    return {"data_parallel": 1, "model_parallel": model, "param_mode": "tp",
            "per_device": per_device, "layers": TP_M2_LAYERS, "rows": TP_M2_ROWS,
            "mixer": "mamba2", "data_dir": job["data_dir"],
            "out": f"{job['out']}/m2_stage1_{model}", "step1_file": None}


# phase 15 (f)-(h) and phase 14 (d): configurations whose refusal the port lifted
TP_M2_LAYERS = 4  # (f): stage 1 with mixer mamba2 (1 SWA, 3 Mamba2 layers)
TP_M2_ROWS = 2048  # (f): packed rows
TP_M2_F32_LAYERS = 4  # (g): the student's cached path in fp32 (1 SWA, 3 Mamba2 layers)
SLICED_LAYERS = 2  # (h) and phase 14 (d): one SWA and one DeltaNet layer at 3B width
SLICED_STEPS = 2
SLICED_RUNS = {  # name: run_sft's options
    "dora": dict(finetuning_type="lora", lora_rank=8, lora_alpha=16, use_dora=True),
    "adam_mini": dict(use_optimizer="adam_mini"),
    # gap 2: step 1 refreshes every projection (an SVD of each 2-D leaf's gradient)
    "galore": dict(use_optimizer="galore", optimizer_rank=8, optimizer_update_gap=2),
    "apollo": dict(use_optimizer="apollo", optimizer_rank=8, optimizer_update_gap=2),
    "qlora": dict(finetuning_type="lora", lora_rank=8, lora_alpha=16, quantization_bit=8),
}
TP_SLICED = ("dora", "adam_mini", "galore", "qlora")  # (h), model 2 under tp
PAR_SLICED = ("dora", "galore", "apollo", "adam_mini")  # phase 14 (d), data 2 under fsdp


def _sliced_run(job, T, name: str, data: int, model: int, mode: str, rows: int):
    """(h) / phase 14 (d): run_sft at 3B width, SLICED_LAYERS deep, T 2,048 on
    data/demo.json streamed (remat, lr 1e-5, SLICED_STEPS steps, bf16, a
    global batch of `rows` rows) with SLICED_RUNS[name], on a (data, model)
    mesh under `mode` (1 x 1: one process); Trainer.save replaced."""
    real_cfg = T.infinitevl_3b
    T.infinitevl_3b = lambda: _cut_3b(SLICED_LAYERS)
    _free()
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    try:
        final, recs = _trainer_records(T, lambda: T.run_sft(_train_args(
            f"{job['out']}/{name}_{data}x{model}", cutoff_len=2048, max_steps=SLICED_STEPS,
            remat=True, learning_rate=1e-5, dataset="demo", dataset_dir=job["repo_data"],
            streaming=True, packing=False, data_parallel=data, model_parallel=model,
            param_mode=mode, per_device_train_batch_size=rows // data, **SLICED_RUNS[name])))
    finally:
        T.infinitevl_3b = real_cfg
    torch.cuda.synchronize()
    del final
    _free()
    return dict(losses=[r["loss"] for r in recs], step_ms=_step_ms(recs),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9, launches=_launch_counts())


def _sliced_expect(name: str) -> dict:
    """H forward / backward and C launches a rank of a SLICED_LAYERS-deep run
    (remat: each layer's forward twice a step)."""
    n_swa = sum(1 for t in _cut_3b(SLICED_LAYERS).text.layer_types if t != "linear_attention")
    return {"swa_train_flash_attention": 2 * n_swa * SLICED_STEPS,
            "swa_train_flash_attention_bwd": n_swa * SLICED_STEPS,
            "delta_rule_chunk_fused": 2 * (SLICED_LAYERS - n_swa) * SLICED_STEPS}


def _sliced_hold(hold, tag: str, got: dict, one: dict, card: str, add) -> None:
    """Each rank's run against one process's: both step losses within
    TP_LOSS_TOL, the launches of _sliced_expect; printed."""
    for name, ref in one.items():
        expect = _sliced_expect(name)
        for r, res in enumerate(got[name]):
            e = [abs(a - b) / abs(b) for a, b in zip(res["losses"], ref["losses"])]
            hold(len(res["losses"]) == len(ref["losses"]) == SLICED_STEPS
                 and all(x <= t for x, t in zip(e, TP_LOSS_TOL)),
                 f"{tag} {name} rank {r}: losses {res['losses']} against {ref['losses']}")
            got_l = {k: res["launches"][k] for k in expect}
            hold(got_l == expect, f"{tag} {name} rank {r}: launches {got_l}, expected {expect}")
            add(res["launches"])
        res = got[name][0]
        print(f"{tag} {name} ({SLICED_RUNS[name]}) through run_sft at 3B width, {SLICED_LAYERS} "
              f"layers, T 2,048, {SLICED_STEPS} steps, bf16: losses "
              f"{[round(x, 6) for x in res['losses']]}, one process "
              f"{[round(x, 6) for x in ref['losses']]} (relative err "
              f"{[float(f'{abs(a - b) / abs(b):.2g}') for a, b in zip(res['losses'], ref['losses'])]}"
              f", tol {TP_LOSS_TOL}); ms per step {[g['step_ms'] for g in got[name]]} (one "
              f"process {ref['step_ms']}), peak {[round(g['peak_gb'], 2) for g in got[name]]} GB "
              f"a rank (one process {ref['peak_gb']:.2f}); H fwd / bwd / C launches a rank "
              f"{[res['launches'][k] for k in expect]}; on '{card}'", flush=True)


def _m2_student(dev, layers: int, dtype, gen_seed: int = 0):
    """(g): a Mamba2 student of the 3B width, `layers` deep (layer 0 kept
    SWA, the rest converted), from the all-full_attention teacher of seed 0,
    its conv taps and dt_proj drawn from a seed beside the mimic init (so
    that every channel and head differs); (params, full config)."""
    import dataclasses

    from infinitevl_tpu_torch.models.convert import convert_attention
    from infinitevl_tpu_torch.models.params import init_text_params

    cfg = _cut_3b(layers)
    tcfg = dataclasses.replace(cfg.text, layer_types=("full_attention",) * layers)
    gen = torch.Generator(device=dev).manual_seed(gen_seed)
    teacher = init_text_params(tcfg, gen, dev, dtype)
    student, scfg = convert_attention(teacher, tcfg, gen, softmax_attention=(0,), mixer="mamba2")
    with torch.no_grad():
        for lp in student["layers"]:
            if "conv_w" in lp:
                lp["conv_w"] = lp["conv_w"] + 0.1 * torch.randn(
                    lp["conv_w"].shape, generator=gen, device=dev, dtype=dtype)
                lp["dt_proj"] = {"kernel": 0.02 * torch.randn(
                    lp["dt_proj"]["kernel"].shape, generator=gen, device=dev, dtype=dtype)}
    return {"text": student}, dataclasses.replace(cfg, text=scfg)


def _tp_m2_cached(dev, mesh=None) -> dict:
    """(g) the Mamba2 student's library path in fp32, TP_M2_F32_LAYERS deep:
    generation.prefill of a TP_PROMPT-token prompt into a fresh state (with
    `mesh`: the params sharded and the rank's part of the state), then
    TP_NEW greedy decode_step calls. The logits, tokens, ms, the state's
    bytes after the prefill and after every step, and the Mamba2 keys'
    elements held against their whole count."""
    from infinitevl_tpu_torch.generation import decode_step, prefill
    from infinitevl_tpu_torch.models.state import init_decoder_state, state_bytes
    from infinitevl_tpu_torch.parallel.sharding import shard_params

    params, cfg = _m2_student(dev, TP_M2_F32_LAYERS, torch.float32)
    if mesh is not None:
        params = shard_params(params, mesh, "tp")
    state = init_decoder_state(cfg.text, 1, torch.float32, dev, mesh=mesh)
    tc = cfg.text
    M, W, H, Dh = tc.num_mamba2_layers, tc.conv_size, tc.num_attention_heads, tc.head_dim
    whole = {"mamba_conv": M * W * 3 * H * Dh, "mamba_h": M * H * Dh * Dh}
    held = {k: state[k].numel() for k in whole}
    ids = torch.randint(0, 150000, (1, TP_PROMPT), generator=torch.Generator().manual_seed(5))
    ids = ids.to(dev)
    pos = torch.arange(TP_PROMPT, device=dev)[None, None].expand(3, 1, TP_PROMPT)
    zero = torch.zeros((1, 1), dtype=torch.long, device=dev)
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = prefill(params, cfg, ids, pos, state)
    torch.cuda.synchronize()
    t_pre = (time.perf_counter() - t0) * 1e3
    sizes = [state_bytes(state)]
    out, fed = [logits.float().cpu()], []
    t0 = time.perf_counter()
    for _ in range(TP_NEW):
        tok = logits.argmax(-1, keepdim=True)
        fed.append(tok.cpu())
        logits, state = decode_step(params, cfg, tok, zero, state)
        out.append(logits.float().cpu())
        sizes.append(state_bytes(state))
    torch.cuda.synchronize()
    t_dec = (time.perf_counter() - t0) * 1e3 / TP_NEW
    res = dict(logits=torch.stack(out), tokens=torch.cat(fed, 1), prefill_ms=t_pre,
               decode_ms=t_dec, sizes=sizes, held=held, whole=whole,
               launches=_launch_counts(), n_m2=M)
    del params, state
    _free()
    return res


def _grad_err(parts) -> float:
    """The largest per-leaf err_ratio of the ranks' gradients, each leaf's
    sums over its model-sharded slices added (a replicated leaf: rank 0's)."""
    worst = 0.0
    for k, (d0, r0, sharded) in parts[0].items():
        d, r = (sum(p[k][0] for p in parts), sum(p[k][1] for p in parts)) if sharded else (d0, r0)
        if r > 0:
            worst = max(worst, d / r)
    return worst


def phase_tp_path(dev, card: str, full_peak_gb=None, par12=None) -> dict:
    """Phase 15: tensor parallelism at 3B, gloo ranks sharing the card. One
    world of two ranks (model_parallel 2): (a) full finetuning at TP_FULL_LAYERS
    under tp against one process, (b) stage 1 of train_3b_stage1.yaml at
    T 8,192 and TP_DT_LAYERS, (d) one multimodal LoRA step with the ViT, (e)
    a cached prefill of TP_PROMPT tokens and TP_NEW decode steps in fp32 at
    TP_F32_LAYERS and in bf16 at TP_BF16_LAYERS against one process; then one
    world of four (data 2 x model 2): (c) full finetuning under fsdp at
    TP_SHORT_LAYERS against phase 14's replicated run at that depth (the
    same global batch). Returns the launches of (a)-(e), summed over the
    ranks."""
    import os
    import shutil
    import tempfile

    from infinitevl_tpu_torch.parallel.launch import spawn_ranks
    from infinitevl_tpu_torch.train import trainer as T

    t_phase = time.perf_counter()
    missed = []  # every part runs and prints; the phase fails at its end

    def hold(ok: bool, what: str) -> None:
        if not ok:
            missed.append(what)
            print(f"[15 tp] CHECK FAILED: {what}", flush=True)

    root = tempfile.mkdtemp(prefix="ivl_tp_")
    here = os.path.dirname(os.path.abspath(__file__))
    data_dir = os.path.join(root, "packed")
    _packed_text_dataset(data_dir, n=90)
    job = {"out": os.path.join(root, "runs"), "repo_data": os.path.join(here, "data"),
           "data_dir": data_dir, "grad_file": os.path.join(root, "grads_one_fp32.pt")}
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def layer_launches(layers, steps):  # full finetuning with remat, a rank
        n_swa = sum(1 for t in _cut_3b(layers).text.layer_types if t != "linear_attention")
        return {"swa_train_flash_attention": 2 * n_swa * steps,
                "swa_train_flash_attention_bwd": n_swa * steps,
                "delta_rule_chunk_fused": 2 * (layers - n_swa) * steps}

    try:
        # (a) one process first; its fp32 gradients go to a file the ranks read
        one = _tp_full(job, T, TP_FULL_LAYERS, "tp", 1, 1)
        _tp_grads(job, T, dev, 1, save=job["grad_file"])
        _free()
        t0 = time.perf_counter()
        world = spawn_ranks(_par_rank, 2, (dict(job, kind="tp2"),), device="cuda:0",
                            timeout=PAR_DEADLINE)
        t_world = time.perf_counter() - t0
        os.remove(job["grad_file"])

        # (a)
        full = [w["full"] for w in world]
        l2, l1 = full[0]["losses"], one["losses"]
        e_l = [abs(a - b) / abs(b) for a, b in zip(l2, l1)]
        hold(len(l2) == len(l1) == TP_STEPS and all(e <= t for e, t in zip(e_l, TP_LOSS_TOL)),
                f"(a) losses over two model ranks {l2} against one process {l1}")
        e_grad = _grad_err([w["grads"] for w in world])
        hold(e_grad <= TP_GRAD_TOL, f"(a) fp32 gradients err_ratio {e_grad:.3g}")
        expect = layer_launches(TP_FULL_LAYERS, TP_STEPS)
        for r, res in enumerate(full):
            hold(2 * res["held_bytes"] == res["whole_bytes"],
                    f"(a) rank {r} holds {res['held_bytes']} of {res['whole_bytes']} bytes")
            got_l = {k: res["launches"][k] for k in expect}
            hold(got_l == expect, f"(a) rank {r} launches {got_l}, expected {expect}")
            add(res["launches"])
        vs8 = (f"phase 8's one-process full_2048 peak at {TRAIN_LAYERS} layers "
               f"{full_peak_gb:.2f} GB"
               if full_peak_gb
               else "phase 8's peak not measured in this run")
        print(f"[15 tp] (a) full finetuning through run_sft at 3B ({TP_FULL_LAYERS} "
              f"layers, T 2,048, data/demo.json streamed, remat, lr 1e-5, {TP_STEPS} steps), "
              f"model_parallel 2 under tp, two gloo ranks sharing the card: losses "
              f"{[round(x, 6) for x in l2]}, one process {[round(x, 6) for x in l1]} "
              f"(relative err {[float(f'{e:.2g}') for e in e_l]}, tol {TP_LOSS_TOL}); in fp32 the "
              f"gradients of the {len(world[0]['grads'])} trainable leaves on the first batch, "
              f"two ranks against one process, the largest leaf's err_ratio {e_grad:.3g} (tol "
              f"{TP_GRAD_TOL}, each leaf's slices summed)", flush=True)
        for r, res in enumerate(full):
            (nh, th, bh), (no, to, bo) = (res["collectives"][k] for k in ("head", "other"))
            print(f"[15 tp] (a) rank {r}: all_reduce over the {TP_STEPS} steps (host clock "
                  f"around each call after a device sync): {no + nh} calls, {to + th:.2f} s, "
                  f"{(bo + bh) / 1e9:.2f} GB; of them the head's partial logits {nh} calls, "
                  f"{th:.2f} s, {bh / 1e9:.2f} GB ({th / max(to + th, 1e-9):.0%} of the "
                  f"all_reduce seconds); the rest (the layers' sums and their backward's, "
                  f"the gradients' norm) {no} calls, {to:.2f} s", flush=True)
            print(f"[15 tp] (a) rank {r}: ms per step {res['step_ms']} (step 1 from the "
                  f"trainer's start), peak {res['peak_gb']:.2f} GB "
                  f"(one process: {one['peak_gb']:.2f} GB, {one['step_ms']} ms per step; "
                  f"{vs8}), holds {res['held_bytes'] / 1e9:.3f} GB of the model-sharded leaves' "
                  f"{res['whole_bytes'] / 1e9:.3f} GB (exactly half), H fwd / bwd / C launches "
                  f"{[res['launches'][k] for k in expect]}; on '{card}'", flush=True)

        # (b)
        s1 = [w["stage1"] for w in world]
        n_swa_b = sum(1 for t in _cut_3b(TP_DT_LAYERS).text.layer_types if t != "linear_attention")
        expect_b = {"swa_train_flash_attention": (TP_DT_LAYERS + n_swa_b) * PAR_STEPS,
                    "swa_train_flash_attention_bwd": 0,
                    "delta_rule_chunk_fused": (TP_DT_LAYERS - n_swa_b) * PAR_STEPS}
        for r, res in enumerate(s1):
            hold(res["unchanged"], f"(b) the teacher changed on rank {r}")
            hold(2 * res["held_bytes"] == res["whole_bytes"],
                    f"(b) rank {r} holds {res['held_bytes']} of {res['whole_bytes']} bytes")
            hold(len(res["losses"]) == PAR_STEPS and np.isfinite(res["losses"]).all(),
                    f"(b) rank {r}: losses {res['losses']}")
            got_l = {k: res["launches"][k] for k in expect_b}
            hold(got_l == expect_b, f"(b) rank {r} launches {got_l}, expected {expect_b}")
            add(res["launches"])
        hold(s1[0]["losses"] == s1[1]["losses"], "(b) the ranks logged different losses")
        print(f"[15 tp] (b) stage 1 of train_3b_stage1.yaml at 3B width, {TP_DT_LAYERS} layers "
              f"(teacher and student), packed rows of {TP_DT_ROWS}, model_parallel 2 under tp, "
              f"warm-up 100 -> 0, {PAR_STEPS} steps: losses "
              f"{[round(x, 6) for x in s1[0]['losses']]}, ms per step {s1[0]['step_ms']} / "
              f"{s1[1]['step_ms']}, peak {s1[0]['peak_gb']:.2f} / {s1[1]['peak_gb']:.2f} GB a "
              f"rank, {s1[0]['held_bytes'] / 1e9:.3f} of {s1[0]['whole_bytes'] / 1e9:.3f} GB of "
              f"the model-sharded leaves held; the teacher's {s1[0]['n_teacher']} leaves "
              f"bit-unchanged on each rank; on '{card}'", flush=True)

        # (d) against the same step in one process
        mm = [w["mm"] for w in world]
        mm_one = _tp_mm(job, T, 1)
        e_mm = abs(mm[0]["losses"][0] - mm_one["losses"][0]) / abs(mm_one["losses"][0])
        hold(e_mm <= TP_LOSS_TOL[0], f"(d) loss {mm[0]['losses']} against {mm_one['losses']}")
        for r, res in enumerate(mm):
            hold(res["launches"]["segment_flash_attention"] == 4
                    and res["launches"]["window_flash_attention"] == 28,
                    f"(d) rank {r}: E / F launches {res['launches']}")
            add(res["launches"])
        print(f"[15 tp] (d) one multimodal LoRA step through run_sft at 3B width "
              f"({TP_SHORT_LAYERS} layers, the ViT's 32 blocks sharded: its fused qkv gathered, "
              f"8 of 16 heads a rank), one 448x448 image, model_parallel 2: loss "
              f"{mm[0]['losses'][0]:.6f}, one process {mm_one['losses'][0]:.6f} (relative err "
              f"{e_mm:.2g}, tol {TP_LOSS_TOL[0]}), ms {mm[0]['step_ms']} / one process "
              f"{mm_one['step_ms']}, peak {mm[0]['peak_gb']:.2f} GB a rank / "
              f"{mm_one['peak_gb']:.2f}; E / F launches a rank 4 / 28; on '{card}'", flush=True)

        # (e) against one process
        for key, layers, dtype, forced in (("f32", TP_F32_LAYERS, torch.float32, None),
                                           ("bf16", TP_BF16_LAYERS, torch.bfloat16,
                                            _tp_forced_tokens())):
            ref = _tp_cached(dev, layers, dtype, None, forced)
            # bf16: the same steps of the fp32 model, the yardstick of both bf16 runs
            ref32 = None if forced is None else _tp_cached(dev, layers, torch.float32, None,
                                                           forced)["logits"]
            e_one32 = None if ref32 is None else err_ratio(ref["logits"], ref32)
            for r, w in enumerate(world):
                got = w["cached"][key]
                e = err_ratio(got["logits"], ref["logits"] if ref32 is None else ref32)
                bound = TP_LOGIT_TOL[dtype] + (e_one32 or 0.0)
                hold(e <= bound, f"(e) {key} rank {r}: logits err_ratio {e:.3g} (tol {bound:.3g})")
                hold(torch.equal(got["tokens"], ref["tokens"]),
                        f"(e) {key} rank {r}: tokens {got['tokens']} against {ref['tokens']}")
                for name in ("swa_ring_flash_attention", "swa_ring_flash_decode_stacked",
                             "delta_step_fused_stacked", "delta_rule_chunk_fused"):
                    hold(got["launches"][name] > 0, f"(e) {key} rank {r}: {name} not launched")
                add(got["launches"])
            got = world[0]["cached"][key]
            print(f"[15 tp] (e) {key}, {layers} layers at 3B width: generation.prefill of "
                  f"{TP_PROMPT} tokens, then {TP_NEW} decode_step calls "
                  f"({'greedy' if forced is None else 'fed seeded tokens'}) on the sharded params "
                  f"and each rank's part of the state ({got['state_mb']:.1f} MB a rank, one process "
                  f"{ref['state_mb']:.1f}): logits err_ratio against one process "
                  f"{max(err_ratio(w['cached'][key]['logits'], ref['logits']) for w in world):.3g}"
                  + ("" if ref32 is None else f", tokens equal; against the fp32 model's logits: "
                     f"two ranks {err_ratio(got['logits'], ref32):.3g}, one bf16 process "
                     f"{e_one32:.3g} (held: two ranks within {TP_LOGIT_TOL[dtype]} of it)")
                  + (f" (tol {TP_LOGIT_TOL[dtype]}), greedy tokens equal" if ref32 is None else "")
                  + f"; prefill {got['prefill_ms']:.1f} ms, "
                  f"{got['decode_ms']:.1f} ms a step (one process {ref['prefill_ms']:.1f} / "
                  f"{ref['decode_ms']:.1f}); launches a rank A1 / A2 / B / C "
                  f"{[got['launches'][k] for k in ('swa_ring_flash_attention', 'swa_ring_flash_decode_stacked', 'delta_step_fused_stacked', 'delta_rule_chunk_fused')]}; "
                  f"on '{card}'", flush=True)
        # (f) stage 1 with mixer mamba2 against one process
        f2 = [w["m2_stage1"] for w in world]
        f1 = _par_stage1(_m2_stage1_job(job, 1, 1), T, dev)
        _free()
        n_swa_f = sum(1 for t in _cut_3b(TP_M2_LAYERS).text.layer_types
                      if t != "linear_attention")
        expect_f = {"swa_train_flash_attention": (TP_M2_LAYERS + n_swa_f) * PAR_STEPS,
                    "swa_train_flash_attention_bwd": 0, "delta_rule_chunk_fused": 0}
        e_f = [abs(a - b) / abs(b) for a, b in zip(f2[0]["losses"], f1["losses"])]
        hold(len(e_f) == PAR_STEPS and all(e <= t for e, t in zip(e_f, TP_LOSS_TOL)),
             f"(f) losses over two model ranks {f2[0]['losses']} against one process "
             f"{f1['losses']}")
        for r, res in enumerate(f2):
            hold(res["unchanged"], f"(f) the teacher changed on rank {r}")
            got_l = {k: res["launches"][k] for k in expect_f}
            hold(got_l == expect_f, f"(f) rank {r} launches {got_l}, expected {expect_f}")
            add(res["launches"])
        hold(f2[0]["losses"] == f2[1]["losses"], "(f) the ranks logged different losses")
        print(f"[15 tp] (f) stage 1 of train_3b_stage1.yaml with mixer mamba2 at 3B width, "
              f"{TP_M2_LAYERS} layers ({n_swa_f} kept SWA, the rest Mamba2 students: q / k / v / "
              f"g_proj and A_log / dt_bias sliced, conv_w / conv_b / dt_proj / D whole a rank), "
              f"packed rows of {TP_M2_ROWS}, model_parallel 2 under tp, {PAR_STEPS} steps: "
              f"losses {[round(x, 6) for x in f2[0]['losses']]}, one process "
              f"{[round(x, 6) for x in f1['losses']]} (relative err "
              f"{[float(f'{e:.2g}') for e in e_f]}, tol {TP_LOSS_TOL}); ms per step "
              f"{f2[0]['step_ms']} / {f2[1]['step_ms']} (one process {f1['step_ms']}), peak "
              f"{f2[0]['peak_gb']:.2f} / {f2[1]['peak_gb']:.2f} GB a rank (one process "
              f"{f1['peak_gb']:.2f}); H fwd / bwd / C launches a rank "
              f"{[f2[0]['launches'][k] for k in expect_f]}; the teacher bit-unchanged; on "
              f"'{card}'", flush=True)

        # (g) the Mamba2 student's cached path against one process
        g1 = _tp_m2_cached(dev)
        for r, w in enumerate(world):
            got = w["m2_cached"]
            e = err_ratio(got["logits"], g1["logits"])
            hold(e <= TP_LOGIT_TOL[torch.float32],
                 f"(g) rank {r}: logits err_ratio {e:.3g} (tol {TP_LOGIT_TOL[torch.float32]})")
            hold(torch.equal(got["tokens"], g1["tokens"]),
                 f"(g) rank {r}: tokens {got['tokens']} against {g1['tokens']}")
            hold(all(2 * got["held"][k] == got["whole"][k] for k in got["whole"]),
                 f"(g) rank {r} holds {got['held']} of {got['whole']} Mamba2 state elements")
            hold(len(set(got["sizes"])) == 1, f"(g) rank {r}: state bytes {set(got['sizes'])}")
            for name in ("swa_ring_flash_attention", "swa_ring_flash_decode_stacked"):
                hold(got["launches"][name] > 0, f"(g) rank {r}: {name} not launched")
            add(got["launches"])
        got = world[0]["m2_cached"]
        print(f"[15 tp] (g) the Mamba2 student in fp32 at 3B width, {TP_M2_F32_LAYERS} layers "
              f"(1 SWA, {got['n_m2']} Mamba2; conv taps and dt_proj drawn beside the mimic init): "
              f"generation.prefill of {TP_PROMPT} tokens, then {TP_NEW} greedy decode_step calls "
              f"on each rank's part of the state (its heads of mamba_h, its [v | k | q] channels "
              f"of mamba_conv: {got['held']} of {got['whole']} elements): logits err_ratio "
              f"against one process "
              f"{max(err_ratio(w['m2_cached']['logits'], g1['logits']) for w in world):.3g} (tol "
              f"{TP_LOGIT_TOL[torch.float32]}), greedy tokens equal; state "
              f"{got['sizes'][0] / 1e6:.2f} MB a rank after the prefill and after every step "
              f"(one process {g1['sizes'][0] / 1e6:.2f}); prefill {got['prefill_ms']:.1f} ms, "
              f"{got['decode_ms']:.1f} ms a step (one process {g1['prefill_ms']:.1f} / "
              f"{g1['decode_ms']:.1f}); A1 / A2 launches a rank "
              f"{[got['launches'][k] for k in ('swa_ring_flash_attention', 'swa_ring_flash_decode_stacked')]}; "
              f"on '{card}'", flush=True)

        # (h) DoRA, Adam-mini, GaLore and QLoRA on the model axis against one process
        one_h = {name: _sliced_run(job, T, name, 1, 1, "tp", 1) for name in TP_SLICED}
        _sliced_hold(hold, "[15 tp] (h)", {n: [w["sliced"][n] for w in world] for n in one_h},
                     one_h, card, add)
        print(f"[15 tp] the world of two ranks took {t_world:.1f} s (spawn, weights, datasets, "
              f"steps)", flush=True)
        del world
        _free()

        # (c) data 2 x model 2 under fsdp, against phase 14's replicated run at that depth
        t0 = time.perf_counter()
        four = spawn_ranks(_par_rank, 4, (dict(job, kind="tp4"),), device="cuda:0",
                           timeout=PAR_DEADLINE)
        t_four = time.perf_counter() - t0
        fc = [w["full"] for w in four]
        expect_c = layer_launches(TP_SHORT_LAYERS, TP_STEPS)
        for r, res in enumerate(fc):
            got_l = {k: res["launches"][k] for k in expect_c}
            hold(got_l == expect_c, f"(c) rank {r} launches {got_l}, expected {expect_c}")
            hold(len(res["losses"]) == TP_STEPS and np.isfinite(res["losses"]).all(),
                    f"(c) rank {r}: losses {res['losses']}")
            add(res["launches"])
        lc = fc[0]["losses"]
        if par12 is not None:
            e_c = [abs(a - b) / abs(b) for a, b in zip(lc, par12)]
            hold(len(lc) == len(par12) and all(e <= t for e, t in zip(e_c, TP_LOSS_TOL)),
                    f"(c) losses {lc} against phase 14's replicated {par12}")
            versus = (f"phase 14 (b)'s replicated run at the same global batch {par12} "
                      f"(relative err {[float(f'{e:.2g}') for e in e_c]}, tol {TP_LOSS_TOL})")
        else:
            versus = "phase 14 not run in this call: not compared"
        print(f"[15 tp] (c) full finetuning at {TP_SHORT_LAYERS} layers, T 2,048, data 2 x model "
              f"2 under fsdp, four gloo ranks sharing the card: losses "
              f"{[round(x, 6) for x in lc]} against {versus}; ms per step "
              f"{[res['step_ms'] for res in fc]}, peak {[round(res['peak_gb'], 2) for res in fc]} "
              f"GB, each rank holds {fc[0]['held_bytes'] / 1e9:.3f} of the sharded leaves' "
              f"{fc[0]['whole_bytes'] / 1e9:.3f} GB; the world took {t_four:.1f} s; on '{card}'",
              flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for name in ("swa_ring_flash_attention", "swa_ring_flash_decode_stacked",
                 "delta_step_fused_stacked", "delta_rule_chunk_fused", "segment_flash_attention",
                 "window_flash_attention", "swa_train_flash_attention"):
        hold(total.get(name, 0) > 0, f"kernel {name} was not launched on its path")
    require(not missed, "phase 15: " + "; ".join(missed))
    print(f"[15 tp] two (and four) ranks share one card and move every collective through gloo "
          f"on the host: these times are not tensor parallelism's speed; phase 15 took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return total


# phase 16: pipeline parallelism at 3B, three gloo ranks sharing the card (pipe 3)
PP_STAGES = 3  # 36 layers are 9 pattern periods: 2 stages cannot cut them, 3 can
PP_FULL_LAYERS = 12  # (a) bf16: a period a stage (the script's time budget's)
# (b): 3 periods a stage; at 2 the optimizer's step temporaries, not the kept microbatch
# inputs, set a stage's step peak, and no growth from M 2 to 6 shows
PP_PEAK_LAYERS = 36
PP_STEPS = 2
PP_ROWS = 2048  # packed rows of (a) and (b)
PP_M, PP_M_BIG = 2, 6  # (a)'s microbatches; (b)'s (one row each)
PP_GRAD_LAYERS = 12  # (a) in fp32: 3 periods, one a stage
PP_GRAD_TOL = 1e-4  # (a) fp32 gradients, three stages against one process, err_ratio
PP_LOSS_TOL = 5e-3  # (a) and (c) bf16 step losses, relative
PP_SEQ_T, PP_SEQ_M, PP_SEQ_LAYERS = 16384, 2, 12  # (c): chunks of 8,192 = the window
# k_proj's bias has no gradient in exact arithmetic (the softmax removes a shift of every
# key's score): what it gets is rounding noise, reported and not held
PP_NO_GRADIENT = ("k_proj/bias",)


def _pp_args(job, name, layers, M, S=PP_STAGES, steps=PP_STEPS, bf16=True, **over):
    """run_sft's arguments of phase 16: full finetuning on packed rows of
    PP_ROWS (M rows a step, M microbatches of one row), remat, lr 1e-5."""
    conf = dict(cutoff_len=PP_ROWS, max_steps=steps, remat=True, learning_rate=1e-5,
                dataset="demo_packed", dataset_dir=job["data_dir"], packing=True, bf16=bf16,
                per_device_train_batch_size=M, pipeline_stages=S, n_microbatches=M)
    conf.update(over)
    return _train_args(f"{job['out']}/{name}_{layers}_{S}", **conf)


def _held_split(text) -> tuple:
    """(bytes of the decoder layers this process holds, of the other leaves)."""
    from infinitevl_tpu_torch.train.step import tree_leaves_with_path

    n = lambda tree: sum(t.numel() * t.element_size() for _, t in tree_leaves_with_path(tree))
    return n(text["layers"]), n({k: v for k, v in text.items() if k != "layers"})


def _pp_run(job, T, layers, args):
    """run_sft at 3B width, `layers` deep (Trainer.save replaced): losses,
    ms per step, the run's peak (its whole-model init included), the bytes
    held (the rank's layers, the replicated leaves), launches."""
    from infinitevl_tpu_torch.ops.swa_kernels import swa_train_flash_attention as h

    held = {}
    real_init, real_cfg = T.Trainer.__init__, T.infinitevl_3b

    def init(self, step_fn, params, *a, **kw):
        held["params"] = params
        real_init(self, step_fn, params, *a, **kw)

    T.Trainer.__init__, T.infinitevl_3b = init, lambda: _cut_3b(layers)
    _free()
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    try:
        final, recs = _trainer_records(T, lambda: T.run_sft(args))
    finally:
        T.Trainer.__init__, T.infinitevl_3b = real_init, real_cfg
    torch.cuda.synchronize()
    launches = _launch_counts()
    launches["swa_train_flash_attention_bwd"] = h.launches_bwd
    layer_b, top_b = _held_split(held.pop("params")["text"])
    n_final = len(final["text"]["layers"])
    del final
    _free()
    return dict(losses=[r["loss"] for r in recs], step_ms=_step_ms(recs),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches,
                layer_bytes=layer_b, top_bytes=top_b, final_layers=n_final)


def _pp_grads(job, T, dev, S, save=None, ref=None):
    """(a)'s gradients in fp32 at PP_GRAD_LAYERS: the SFT loss of run_sft's
    first batch differentiated with respect to every leaf full finetuning
    trains, the weights from the seed as run_sft makes them; in one process
    (S 1, remat) written whole to `save`, or on S pipe ranks through each
    schedule held leaf by leaf against `ref`: {schedule: {path: (sum |g - r|,
    sum |r|)}} and the losses."""
    from infinitevl_tpu_torch.data.loader import resolve_tokenizer
    from infinitevl_tpu_torch.models.params import init_text_params
    from infinitevl_tpu_torch.parallel import pipeline as pl
    from infinitevl_tpu_torch.parallel.sharding import create_pp_mesh, use_mesh
    from infinitevl_tpu_torch.train.step import (
        batch_to_device,
        full_finetune_leaf,
        set_trainable,
        sft_loss_fn,
        trainable_leaves,
    )

    _free()
    args = _pp_args(job, "grads", PP_GRAD_LAYERS, PP_M, S=S, steps=1, bf16=False)
    real_cfg, T.infinitevl_3b = T.infinitevl_3b, lambda: _cut_3b(PP_GRAD_LAYERS)
    try:
        cfg = T.build_config(args)
    finally:
        T.infinitevl_3b = real_cfg
    mesh = create_pp_mesh(S) if S > 1 else None
    data = T.build_dataset(args, resolve_tokenizer(args, cfg, None), cfg=cfg)
    b = batch_to_device(next(iter(T._batches(args, data, cfg, False, mesh))), dev)
    text = init_text_params(cfg.text, torch.Generator(device=dev).manual_seed(args.train.seed),
                            dev, torch.float32)
    set_trainable({"text": text}, full_finetune_leaf)
    inputs = (b["input_ids"], b["labels"], b["position_ids"])
    if save is not None:
        named = trainable_leaves({"text": text})
        loss = sft_loss_fn(text, cfg.text, *inputs, b.get("segment_ids"), remat=True,
                           segment_layout=b.get("segment_layout"))
        grads = torch.autograd.grad(loss, [t for _, t in named])
        torch.save({k: g.cpu() for (k, _), g in zip(named, grads)}, save)
        out = {"loss": float(loss)}
        del text, grads, loss
        _free()
        return out
    params = {"text": pl.shard_stage(text, cfg.text, S, mesh)}
    del text
    _free()
    want = torch.load(ref, map_location="cpu", mmap=True, weights_only=True)
    out = {"losses": {}, "sums": {}, "seconds": {}}
    pp = pl.stack_stage_params(params["text"], cfg.text, S)
    with use_mesh(mesh):
        for name, fn in (("gpipe", pl.pp_sft_value_and_grad_gpipe),
                         ("1f1b", pl.pp_sft_value_and_grad_1f1b)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, grads = fn(pp, cfg.text, *inputs, PP_M, b.get("segment_ids"), mesh=mesh,
                             segment_layout=b.get("segment_layout"))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            by_id = {id(t): g for (_, t), g in zip(trainable_leaves(pp), grads)}
            sums = {}
            for k, t in trainable_leaves(params):
                g, r = by_id[id(t)], want[k].to(dev)
                sums[k] = (float((g - r).abs().sum()), float(r.abs().sum()))
            out["losses"][name], out["sums"][name] = float(loss), sums
            out["seconds"][name] = (t1 - t0, time.perf_counter() - t1)
            del grads, by_id
            _free()
    del params, pp, want
    _free()
    return out


def _pp_peaks(job, T, dev):
    """(b) on one pipe rank: one step of each schedule at PP_M and PP_M_BIG
    microbatches of one row, on one stage of a PP_PEAK_LAYERS-deep run_sft's make-up
    (shard_stage, the optimizer's state), through make_pp_sft_train_step:
    each step's peak above the memory held before it, its ms, its loss,
    and its launches."""
    from infinitevl_tpu_torch.data.loader import resolve_tokenizer
    from infinitevl_tpu_torch.models.params import init_text_params
    from infinitevl_tpu_torch.ops.swa_kernels import swa_train_flash_attention as h
    from infinitevl_tpu_torch.parallel import pipeline as pl
    from infinitevl_tpu_torch.parallel.sharding import create_pp_mesh, use_mesh
    from infinitevl_tpu_torch.train.step import full_finetune_leaf, set_trainable

    _free()
    args = _pp_args(job, "peaks", PP_PEAK_LAYERS, PP_M_BIG, steps=1)
    real_cfg, T.infinitevl_3b = T.infinitevl_3b, lambda: _cut_3b(PP_PEAK_LAYERS)
    try:
        cfg = T.build_config(args)
    finally:
        T.infinitevl_3b = real_cfg
    mesh = create_pp_mesh(PP_STAGES)
    data = T.build_dataset(args, resolve_tokenizer(args, cfg, None), cfg=cfg)
    rows = next(iter(T._batches(args, data, cfg, False, mesh)))
    out = {}
    with use_mesh(mesh):
        text = init_text_params(cfg.text, torch.Generator(device=dev).manual_seed(0), dev)
        set_trainable({"text": text}, full_finetune_leaf)
        params = {"text": pl.shard_stage(text, cfg.text, PP_STAGES, mesh)}
        del text
        _free()
        tx = T._make_tx(args, 4)
        opt = tx.init(params)
        for M in (PP_M, PP_M_BIG):
            batch = {k: (v[:, :M] if k == "position_ids" else v[:M])
                     if isinstance(v, np.ndarray) and v.ndim else v for k, v in rows.items()}
            batch.pop("_n_tokens", None)
            for sched in ("gpipe", "1f1b"):
                step = pl.make_pp_sft_train_step(cfg.text, tx, M, PP_STAGES, mesh=mesh,
                                                 remat=True, schedule=sched)
                _free()
                _reset_launches()
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                _, _, loss = step(params, opt, dict(batch))
                torch.cuda.synchronize()
                launches = _launch_counts()
                launches["swa_train_flash_attention_bwd"] = h.launches_bwd
                out[f"{sched}_{M}"] = dict(
                    above_gb=(torch.cuda.max_memory_allocated() - base) / 1e9,
                    peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                    ms=(time.perf_counter() - t0) * 1e3, loss=float(loss), launches=launches)
    del params, opt
    _free()
    return out


def _pp_seq_args(job, S):
    return _train_args(
        f"{job['out']}/seq_{S}", cutoff_len=PP_SEQ_T, max_steps=PP_STEPS, remat=True,
        learning_rate=1e-5, dataset="demo_long", dataset_dir=job["long_dir"], packing=False,
        pipeline_stages=S, n_microbatches=PP_SEQ_M, pp_microbatch_axis="sequence")


def _pp_world(job, T, dev):
    """Phase 16 on one of PP_STAGES ranks: (a) fp32 gradients, (a) the
    PP_FULL_LAYERS-deep runs under gpipe and 1f1b, (b) the step peaks, (c) the
    sequence axis."""
    t0 = time.perf_counter()
    out = {"grads": _pp_grads(job, T, dev, PP_STAGES, ref=job["grad_file"])}
    out["grads"]["job_s"] = time.perf_counter() - t0
    for sched in ("gpipe", "1f1b"):
        out[sched] = _pp_run(job, T, PP_FULL_LAYERS, _pp_args(job, sched, PP_FULL_LAYERS, PP_M,
                                                  pipeline_schedule=sched))
    out["peaks"] = _pp_peaks(job, T, dev)
    out["seq"] = _pp_run(job, T, PP_SEQ_LAYERS, _pp_seq_args(job, PP_STAGES))
    return out


def phase_pp_path(dev, card: str) -> dict:
    """Phase 16: pipeline parallelism at 3B, PP_STAGES gloo ranks sharing
    the card (pipe 3, a third of the layers a stage; NCCL refuses ranks sharing a
    GPU). In one process first: the fp32 gradients of (a)'s first batch at
    PP_GRAD_LAYERS, (a)'s bf16 steps at PP_FULL_LAYERS, (c)'s unpipelined
    chunked steps (PR 12's path). Then one world of three ranks: (a) the
    fp32 gradients through both schedules, the PP_FULL_LAYERS-deep run_sft steps under
    gpipe and 1f1b; (b) one step of each schedule at M 2 and 6 (one row a
    microbatch), each step's peak; (c) the sequence axis at T 16,384 (two
    chunks of one window), 12 layers. Returns the launches, summed over the
    ranks."""
    import os
    import shutil
    import tempfile

    from infinitevl_tpu_torch.parallel.launch import spawn_ranks
    from infinitevl_tpu_torch.train import trainer as T

    t_phase = time.perf_counter()
    missed = []

    def hold(ok: bool, what: str) -> None:
        if not ok:
            missed.append(what)
            print(f"[16 pp] CHECK FAILED: {what}", flush=True)

    root = tempfile.mkdtemp(prefix="ivl_pp_")
    job = {"out": os.path.join(root, "runs"), "data_dir": os.path.join(root, "packed"),
           "long_dir": os.path.join(root, "long"),
           "grad_file": os.path.join(root, "grads_one_fp32.pt")}
    _packed_text_dataset(job["data_dir"], n=90)
    _long_text_dataset(job["long_dir"], PP_SEQ_T)
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    rel = lambda a, b: [abs(x - y) / abs(y) for x, y in zip(a, b)]
    try:
        # one process: (a)'s fp32 gradients to a file the ranks read, (a)'s and (c)'s steps
        g_one = _pp_grads(job, T, dev, 1, save=job["grad_file"])
        one = _pp_run(job, T, PP_FULL_LAYERS, _pp_args(job, "one", PP_FULL_LAYERS, PP_M, S=1))
        seq_one = _pp_run(job, T, PP_SEQ_LAYERS, _pp_seq_args(job, 1))
        _free()
        t0 = time.perf_counter()
        world = spawn_ranks(_par_rank, PP_STAGES, (dict(job, kind="pp3"),), device="cuda:0",
                            timeout=PAR_DEADLINE)
        t_world = time.perf_counter() - t0
        os.remove(job["grad_file"])

        # (a) fp32 gradients: each leaf from the rank that holds it (the replicated ones
        # from every rank, the same after the pipe group's sum)
        for sched in ("gpipe", "1f1b"):
            sums = {}
            for w in world:
                sums.update(w["grads"]["sums"][sched])
            errs = {k: d / r for k, (d, r) in sums.items() if r > 0}
            worst = max((e, k) for k, e in errs.items() if not k.endswith(PP_NO_GRADIENT))
            noise = max((e for k, e in errs.items() if k.endswith(PP_NO_GRADIENT)), default=0.0)
            losses = [w["grads"]["losses"][sched] for w in world]
            secs = world[0]["grads"]["seconds"][sched]
            e_loss = max(rel(losses, [g_one["loss"]] * len(losses)))
            hold(worst[0] <= PP_GRAD_TOL and e_loss <= 1e-5,
                 f"(a) fp32 {sched}: gradients err_ratio {worst}, loss {losses} against "
                 f"{g_one['loss']}")
            print(f"[16 pp] (a) fp32, {PP_GRAD_LAYERS} layers at 3B width, run_sft's first "
                  f"batch ({PP_M} packed rows of {PP_ROWS}, {PP_M} microbatches), three stages "
                  f"under {sched} against one process: loss {losses[0]:.7f} (one process "
                  f"{g_one['loss']:.7f}, relative {e_loss:.2g}), the gradients of the "
                  f"{len(sums)} trainable leaves, the largest leaf's err_ratio {worst[0]:.3g} "
                  f"({worst[1]}; tol {PP_GRAD_TOL}); k_proj's bias, no gradient in exact "
                  f"arithmetic, {noise:.3g} (not held); rank 0: the schedule {secs[0]:.1f} s, "
                  f"the comparison {secs[1]:.1f} s, the whole fp32 job (both schedules, the "
                  f"weights, the batch) {world[0]['grads']['job_s']:.1f} s", flush=True)

        # (a) bf16, PP_FULL_LAYERS deep, run_sft under both schedules against one process
        def expect(sched, M, steps, layers=PP_FULL_LAYERS):
            """Launches a rank: forwards a layer a microbatch, a stage's share."""
            n_swa = sum(1 for t in _cut_3b(layers).text.layer_types if t != "linear_attention")
            swa, lin = n_swa // PP_STAGES, (layers - n_swa) // PP_STAGES
            f = 2 if sched == "gpipe" else 3  # 1f1b: the no-grad forward, then the recompute's
            return {"swa_train_flash_attention": f * swa * M * steps,
                    "swa_train_flash_attention_bwd": swa * M * steps,
                    "delta_rule_chunk_fused": f * lin * M * steps}

        for sched in ("gpipe", "1f1b"):
            runs = [w[sched] for w in world]
            e_l = rel(runs[0]["losses"], one["losses"])
            hold(len(e_l) == PP_STEPS and max(e_l) <= PP_LOSS_TOL,
                 f"(a) {sched} losses {runs[0]['losses']} against {one['losses']}")
            hold(all(r["losses"] == runs[0]["losses"] for r in runs),
                 f"(a) {sched}: the ranks logged different losses")
            hold(sum(r["layer_bytes"] for r in runs) == one["layer_bytes"]
                 and all(r["layer_bytes"] == runs[0]["layer_bytes"]
                         and r["top_bytes"] == one["top_bytes"] for r in runs),
                 f"(a) {sched}: bytes held {[(r['layer_bytes'], r['top_bytes']) for r in runs]}"
                 f" against one process's {(one['layer_bytes'], one['top_bytes'])}")
            hold(all(r["final_layers"] == PP_FULL_LAYERS for r in runs),
                 f"(a) {sched}: a rank returned {[r['final_layers'] for r in runs]} layers")
            want = expect(sched, PP_M, PP_STEPS)
            for r, res in enumerate(runs):
                got_l = {k: res["launches"][k] for k in want}
                hold(got_l == want, f"(a) {sched} rank {r} launches {got_l}, expected {want}")
                add(res["launches"])
            print(f"[16 pp] (a) full finetuning through run_sft at 3B ({PP_FULL_LAYERS} layers, {PP_M} packed "
                  f"rows of {PP_ROWS}, {PP_M} microbatches, remat, lr 1e-5, {PP_STEPS} steps), "
                  f"pipeline_stages {PP_STAGES} under {sched}, three gloo ranks sharing the "
                  f"card: losses {[round(x, 6) for x in runs[0]['losses']]}, one process "
                  f"{[round(x, 6) for x in one['losses']]} (relative "
                  f"{[float(f'{e:.2g}') for e in e_l]}, tol {PP_LOSS_TOL})", flush=True)
            for r, res in enumerate(runs):
                print(f"[16 pp] (a) {sched} rank {r} (stage {r}): ms per step {res['step_ms']} "
                      f"(step 1 from the trainer's start), the run's peak {res['peak_gb']:.2f} "
                      f"GB (its whole-model init and the final gather of the stages included), "
                      f"holds {res['layer_bytes'] / 1e9:.3f} GB of the layers (one process "
                      f"{one['layer_bytes'] / 1e9:.3f}: a third) and {res['top_bytes'] / 1e9:.3f}"
                      f" GB of the replicated leaves (one process {one['top_bytes'] / 1e9:.3f}), "
                      f"H fwd / bwd / C launches {[res['launches'][k] for k in want]}; on "
                      f"'{card}'", flush=True)
        print(f"[16 pp] (a) one process: ms per step {one['step_ms']}, peak {one['peak_gb']:.2f}"
              f" GB on '{card}'", flush=True)

        # (b) the step peaks at M 2 and 6
        for r, w in enumerate(world):
            pk = w["peaks"]
            grow = {s: pk[f"{s}_{PP_M_BIG}"]["above_gb"] - pk[f"{s}_{PP_M}"]["above_gb"]
                    for s in ("gpipe", "1f1b")}
            hold(grow["1f1b"] < grow["gpipe"],
                 f"(b) rank {r}: 1f1b's step peak grew {grow['1f1b']:.3f} GB from M {PP_M} to "
                 f"{PP_M_BIG}, gpipe's {grow['gpipe']:.3f}")
            for key, res in pk.items():
                sched, M = key.split("_")
                want = expect(sched, int(M), 1, PP_PEAK_LAYERS)
                got_l = {k: res["launches"][k] for k in want}
                hold(got_l == want, f"(b) {key} rank {r} launches {got_l}, expected {want}")
                hold(np.isfinite(res["loss"]), f"(b) {key} rank {r} loss {res['loss']}")
                add(res["launches"])
            print(f"[16 pp] (b) rank {r} (stage {r}), {PP_PEAK_LAYERS} layers, one step a schedule on "
                  f"microbatches of one packed row of {PP_ROWS}: the step's peak above the "
                  f"memory held before it (params, moments) at M {PP_M} / {PP_M_BIG}: gpipe "
                  f"{pk[f'gpipe_{PP_M}']['above_gb']:.3f} / {pk[f'gpipe_{PP_M_BIG}']['above_gb']:.3f}"
                  f" GB, 1f1b {pk[f'1f1b_{PP_M}']['above_gb']:.3f} / "
                  f"{pk[f'1f1b_{PP_M_BIG}']['above_gb']:.3f} GB (growth {grow['gpipe']:.3f} "
                  f"against {grow['1f1b']:.3f}); absolute peaks "
                  f"{[round(pk[k]['peak_gb'], 2) for k in sorted(pk)]} GB ({sorted(pk)}); ms "
                  f"{[round(pk[k]['ms']) for k in sorted(pk)]}; on '{card}'", flush=True)

        # (c) the sequence axis against the unpipelined chunked run
        seq = [w["seq"] for w in world]
        e_s = rel(seq[0]["losses"], seq_one["losses"])
        hold(len(e_s) == PP_STEPS and max(e_s) <= PP_LOSS_TOL,
             f"(c) losses {seq[0]['losses']} against {seq_one['losses']}")
        for r, res in enumerate(seq):
            for k in ("swa_train_flash_attention", "swa_train_flash_attention_bwd",
                      "delta_rule_chunk_fused"):
                hold(res["launches"][k] > 0, f"(c) rank {r}: {k} not launched")
            add(res["launches"])
        print(f"[16 pp] (c) pp_microbatch_axis sequence through run_sft at 3B width "
              f"({PP_SEQ_LAYERS} layers, one row of {PP_SEQ_T}, {PP_SEQ_M} chunks of "
              f"{PP_SEQ_T // PP_SEQ_M}, gpipe, remat, {PP_STEPS} steps), three stages: losses "
              f"{[round(x, 6) for x in seq[0]['losses']]}, the unpipelined chunked run "
              f"{[round(x, 6) for x in seq_one['losses']]} (relative "
              f"{[float(f'{e:.2g}') for e in e_s]}, tol {PP_LOSS_TOL}); ms per step "
              f"{[res['step_ms'] for res in seq]} (one process {seq_one['step_ms']}), peak "
              f"{[round(res['peak_gb'], 2) for res in seq]} GB (one process "
              f"{seq_one['peak_gb']:.2f}); H fwd / bwd / C launches a rank "
              f"{[[res['launches'][k] for k in ('swa_train_flash_attention', 'swa_train_flash_attention_bwd', 'delta_rule_chunk_fused')] for res in seq]};"
              f" on '{card}'", flush=True)
        print(f"[16 pp] the world of three ranks took {t_world:.1f} s (spawn, weights, "
              f"datasets, steps)", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for name in ("swa_train_flash_attention", "delta_rule_chunk_fused"):
        hold(total.get(name, 0) > 0, f"kernel {name} was not launched on its path")
    require(not missed, "phase 16: " + "; ".join(missed))
    print(f"[16 pp] three ranks share one card and hand activations through gloo on the host: "
          f"these times are not pipeline parallelism's speed; phase 16 took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return total


BOARD_LAYERS = 4  # phase 17: one hybrid period (3 DeltaNet layers and 1 SWA layer) at 3B width
BOARD_CUTOFF = 1024  # phase 17: the board's LoRA run
BOARD_STEPS = 3
BOARD_CHAT_TOKENS = 16


def _board_wait(port: int, path: str, done, what: str, limit_s: float = 600.0) -> dict:
    """Poll a board route until `done(status)`; fails after `limit_s`."""
    t0 = time.perf_counter()
    while True:
        code, st = _http(port, path=path)
        require(code == 200, f"{what}: GET {path} answered {code}")
        if done(st):
            return st
        require(time.perf_counter() - t0 < limit_s, f"{what}: not done after {limit_s:.0f} s: {st}")
        time.sleep(0.1)


def _board_losses(port: int, run: str) -> list:
    code, log = _http(port, path=f"/api/log?run={run}")
    require(code == 200, f"/api/log of {run} answered {code}: {log}")
    return [(r["current_steps"], r["loss"]) for r in log["records"] if "loss" in r]


def _script_module(name: str):
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _board_image_uri(hw: int) -> str:
    """data/images/red_square.png resized to hw x hw, as a PNG data URI."""
    import base64
    import io
    import os

    from PIL import Image

    img = Image.open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "images",
                                  "red_square.png")).convert("RGB").resize((hw, hw))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def phase_board_path(dev, card: str) -> dict:
    """Phase 17: the training web board (serve/webui.py) at 3B width and
    BOARD_LAYERS deep, through its HTTP routes on a loopback port: LoRA SFT,
    an aborted run, MCQ and predict evals, chat with text and a 448x448
    image, export and reload; utils/profiling's StepTimer, mfu, trace and
    weight-read floor; the three card-side script twins."""
    import glob
    import os
    import shutil
    import tempfile
    import threading

    import infinitevl_tpu_torch.train.trainer as T
    from infinitevl_tpu_torch.generation import Generator, decode_step
    from infinitevl_tpu_torch.models.params import init_params, load_hf_checkpoint, param_count
    from infinitevl_tpu_torch.models.state import init_decoder_state, state_bytes
    from infinitevl_tpu_torch.serve.webui import create_board_server
    from infinitevl_tpu_torch.train.step import tree_leaves_with_path
    from infinitevl_tpu_torch.utils.checkpoint import export_hf_safetensors
    from infinitevl_tpu_torch.utils.profiling import (
        H100_PEAK_BF16,
        StepTimer,
        decode_hbm_floor_ms,
        decode_weight_read_bytes,
        mfu,
        trace,
    )

    tag = "17 board"
    cfg = _cut_3b(BOARD_LAYERS)
    tc = cfg.text
    data_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
    root = tempfile.mkdtemp(prefix="ivl_board_")
    server = None
    real_train = T.Trainer.train
    try:
        _free()
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))  # bf16
        n_params = param_count(params)
        # on disk at once: the checkpoint, the export, two LoRA train states
        need = 3 * 2 * n_params
        free = shutil.disk_usage(root).free
        require(free >= need, f"phase 17 needs {need / 1e9:.1f} GB of disk under {root}, "
                              f"{free / 1e9:.1f} GB are free")
        ckpt = os.path.join(root, "ckpt")
        t0 = time.perf_counter()
        nbytes = export_hf_safetensors(params, cfg, ckpt)
        print(f"[{tag}] 3B width, {BOARD_LAYERS} layers ({', '.join(tc.layer_types)}) with the "
              f"ViT, bf16 from seed 0: {n_params / 1e9:.3f} B parameters exported as HF "
              f"safetensors ({nbytes / 1e9:.2f} GB) in {time.perf_counter() - t0:.1f} s on "
              f"'{card}'", flush=True)
        base = dict(model_name_or_path=ckpt, template="qwen2_vl", bf16=True,
                    dataset_dir=data_dir)
        torch.cuda.synchronize()
        _reset_launches()
        t_phase = time.perf_counter()
        server = create_board_server(host="127.0.0.1", port=0, runs_root=root)
        require(server.runner.device.type == "cuda", f"the board's device is {server.runner.device}")
        threading.Thread(target=server.serve_forever, daemon=True).start()
        port = server.server_address[1]
        code, ds = _http(port, path=f"/api/datasets?dir={data_dir}")
        require(code == 200 and "demo" in [d["name"] for d in ds["datasets"]], f"datasets {ds}")
        code, prev = _http(port, path=f"/api/dataset?name=demo&dir={data_dir}&template=qwen2_vl")
        require(code == 200 and prev["count"] > 0, f"dataset preview {prev}")

        # 1. LoRA SFT through /api/train; the Trainer's steps timed by
        # StepTimer, its base tree kept for the bit-equality check
        timer = StepTimer(dev, warmup=1)
        bases = []

        def timed_train(self, batches, max_steps=None):
            fn = self.step_fn
            bases.append(self.extra[0] if self.extra else None)

            def step(*a):
                with timer:
                    return fn(*a)

            self.step_fn = step
            return real_train(self, batches, max_steps)

        T.Trainer.train = timed_train
        run1 = os.path.join(root, "run1")
        train_cfg = dict(base, stage="sft", finetuning_type="lora", dataset="demo",
                         cutoff_len=BOARD_CUTOFF, per_device_train_batch_size=1,
                         max_steps=BOARD_STEPS, logging_steps=1, save_steps=10**6,
                         learning_rate=1e-4, output_dir=run1)
        code, res = _http(port, train_cfg, path="/api/train")
        require(code == 200 and res.get("ok"), f"/api/train: {code} {res}")
        st = _board_wait(port, "/api/status", lambda s: not s["running"], "the LoRA run")
        require(not st.get("error"), f"the LoRA run failed: {st}")
        losses = _board_losses(port, run1)
        require([s for s, _ in losses] == list(range(1, BOARD_STEPS + 1))
                and all(np.isfinite([l for _, l in losses])),
                f"the LoRA run's log: {losses} (one line a step, finite)")
        require(len(timer.times_ms) == BOARD_STEPS, f"{len(timer.times_ms)} steps timed")
        ours = dict(tree_leaves_with_path(params))
        held = dict(tree_leaves_with_path(bases[0]))
        require(held.keys() == {k for k in ours if k.startswith("text/")}  # a text-only run
                and all(torch.equal(v, ours[k]) for k, v in held.items()),
                "the LoRA run's base weights are not bit-equal to the checkpoint's")
        summ = timer.summary()
        tps = BOARD_CUTOFF / (summ["avg_ms"] / 1e3)
        print(f"[{tag}] /api/train LoRA, cutoff {BOARD_CUTOFF}, {BOARD_STEPS} steps: losses "
              f"{[round(l, 6) for _, l in losses]}, base bit-unchanged ({len(held)} leaves); "
              f"StepTimer {[round(t, 1) for t in timer.times_ms]} ms, steps 2.. avg "
              f"{summ['avg_ms']:.1f} ms, p50 {summ['p50_ms']:.1f}, {tps:.0f} positions/s, MFU "
              f"{100 * mfu(3 * tps, cfg, H100_PEAK_BF16):.2f}% of {H100_PEAK_BF16 / 1e12:.0f} "
              f"TFLOP/s (fwd + bwd = 3x the forward's matmul FLOPs, remat's recompute and "
              f"the pads' share counted as work) on '{card}'", flush=True)
        timer.print_summary(f"[{tag}] LoRA steps on '{card}'")
        T.Trainer.train = real_train

        # 2. a second run, aborted after its first logged step
        run2 = os.path.join(root, "run2")
        code, res = _http(port, dict(train_cfg, max_steps=1000, output_dir=run2),
                          path="/api/train")
        require(code == 200 and res.get("ok"), f"/api/train (run 2): {code} {res}")
        _board_wait(port, "/api/status",
                    lambda s: not s["running"] or bool(_board_losses(port, run2)), "run 2's step 1")
        code, res = _http(port, {}, path="/api/abort")
        require(code == 200 and res.get("ok"), f"/api/abort: {res}")
        st = _board_wait(port, "/api/status", lambda s: not s["running"], "the aborted run")
        steps2 = _board_losses(port, run2)
        require(not st.get("error") and 1 <= len(steps2) < 1000,
                f"the aborted run: status {st}, {len(steps2)} logged steps")
        print(f"[{tag}] run 2 aborted through /api/abort after {len(steps2)} logged step(s); "
              f"status {st.get('running')} with no error", flush=True)

        # 3. MCQ eval, then predict mode
        t0 = time.perf_counter()
        code, res = _http(port, dict(base, dataset="mcq_demo", n_shot=2, eval_batch_size=2),
                          path="/api/eval")
        require(code == 200 and res.get("ok"), f"/api/eval: {res}")
        st = _board_wait(port, "/api/eval/status", lambda s: s["state"] in ("done", "error"),
                         "the MCQ eval")
        acc = st.get("results", {}).get("accuracy")
        require(st["state"] == "done" and acc is not None and 0.0 <= acc <= 1.0,
                f"the MCQ eval: {st}")
        t_mcq = time.perf_counter() - t0
        code, res = _http(port, dict(base, mode="predict", dataset="demo", cutoff_len=BOARD_CUTOFF,
                                     predict_samples=2, output_dir=os.path.join(root, "predict")),
                          path="/api/eval")
        require(code == 200 and res.get("ok"), f"/api/eval predict: {res}")
        st = _board_wait(port, "/api/eval/status", lambda s: s["state"] in ("done", "error"),
                         "the predict eval")
        pr = st.get("results", {})
        require(st["state"] == "done" and pr.get("samples", 0) > 0
                and all(np.isfinite(v) for k, v in pr.items() if k != "samples"),
                f"the predict eval: {st}")
        print(f"[{tag}] /api/eval MCQ on mcq_demo: accuracy {acc} ({t_mcq:.1f} s); predict "
              f"mode: {pr} on '{card}'", flush=True)

        # 4. chat: a greedy text turn against Generator.generate, an image turn
        code, res = _http(port, base, path="/api/chat/load")
        require(code == 200 and res.get("ok"), f"/api/chat/load: {res}")
        st = _board_wait(port, "/api/chat/status", lambda s: s["state"] in ("ready", "error"),
                         "the chat model's load")
        require(st["state"] == "ready", f"the chat model: {st}")
        chat_gen = server.chatter.model.generator
        calls, states = [], []
        real_generate, real_prefill = chat_gen.generate, chat_gen.prefill_prompt

        def generate(ids, *a, **kw):
            out = real_generate(ids, *a, **kw)
            calls.append((np.asarray(ids), out))
            return out

        def prefill_prompt(*a, **kw):
            out = real_prefill(*a, **kw)
            states.append(out[1])
            return out

        chat_gen.generate, chat_gen.prefill_prompt = generate, prefill_prompt
        expect_bytes = _expected_state_bytes(tc)
        turn = {"messages": [{"role": "user", "content": "Describe a red square in one line."}],
                "max_new_tokens": BOARD_CHAT_TOKENS, "temperature": 0.0}
        t0 = time.perf_counter()
        code, res = _http(port, turn, path="/api/chat")
        t_text = time.perf_counter() - t0
        require(code == 200 and "content" in res, f"/api/chat: {res}")
        require(len(calls) == 1 and state_bytes(states[-1]) == expect_bytes,
                "the text turn's call or its state size")
        ids, board_tokens = calls[0]
        direct = Generator(params, cfg).generate(ids, max_new_tokens=BOARD_CHAT_TOKENS,
                                                 temperature=0.0)
        require(board_tokens.shape[1] >= 1 and np.array_equal(board_tokens, direct),
                f"the board's greedy tokens {board_tokens.tolist()} differ from "
                f"Generator.generate's {direct.tolist()}")
        image_turn = {"messages": [{"role": "user", "content": "<image>What is in it?"}],
                      "images": [_board_image_uri(SERVE_IMAGE_HW)],
                      "max_new_tokens": BOARD_CHAT_TOKENS, "temperature": 0.0}
        launches_e = _read_launches(())["segment_flash_attention"]
        t0 = time.perf_counter()
        code, res = _http(port, image_turn, path="/api/chat")
        t_image = time.perf_counter() - t0
        require(code == 200 and "content" in res, f"/api/chat with an image: {res}")
        require(len(calls) == 2 and state_bytes(states[-1]) == expect_bytes,
                "the image turn's call or its state size")
        require(_read_launches(())["segment_flash_attention"] > launches_e,
                "the image turn launched no E")
        print(f"[{tag}] /api/chat greedy text turn: {board_tokens.shape[1]} tokens equal to "
              f"Generator.generate's ({t_text:.2f} s); image turn at {SERVE_IMAGE_HW}x"
              f"{SERVE_IMAGE_HW} (ViT: E and F) {calls[1][1].shape[1]} tokens ({t_image:.2f} s); "
              f"state {expect_bytes / 1e6:.1f} MB in each turn on '{card}'", flush=True)

        # 5. profiling: one chat turn under trace(), a decode step against its floor
        logdir = os.path.join(root, "trace")
        with trace(logdir):
            torch.cuda._sleep(1000)  # a session can lose its first kernel (_device_profile)
            code, res = _http(port, dict(turn, max_new_tokens=2), path="/api/chat")
            torch.cuda.synchronize()
        require(code == 200 and "content" in res, f"/api/chat under trace(): {res}")
        files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
        require(len(files) == 1, f"trace() wrote {files}")
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"
                   and "spin_kernel" not in e.get("name", "")]
        by_name = {}
        for e in kernels:
            key = next((k for k in ("swa_prefill", "swa_decode", "delta_step", "delta_chunk")
                        if k in e["name"]), None)
            if key:
                by_name[key] = by_name.get(key, 0) + 1
        require(len(kernels) > 0, "the trace holds no CUDA kernel event")
        wbytes = decode_weight_read_bytes(params["text"])
        floor = decode_hbm_floor_ms(wbytes, dtype_bytes=1)
        state = init_decoder_state(tc, 1, torch.bfloat16)
        tok = torch.as_tensor(ids[:, -1:], device=dev)
        pos = torch.zeros((1, 1), dtype=torch.long, device=dev)
        dtimer = StepTimer(dev, warmup=2)
        for i in range(8):
            with dtimer:
                _, state = decode_step(params, cfg, tok, pos + i, state)
        dstep = dtimer.summary()
        require(dstep["p50_ms"] >= floor, f"a decode step ({dstep['p50_ms']:.3f} ms) is below "
                                          f"its weight-read floor ({floor:.3f} ms)")
        print(f"[{tag}] trace(): {len(kernels)} CUDA kernel events in {os.path.basename(files[0])} "
              f"({by_name}); decode_weight_read_bytes {wbytes / 1e9:.3f} GB -> "
              f"decode_hbm_floor_ms {floor:.3f} ms at 3.35 TB/s; a B 1 decode step (StepTimer, "
              f"steps 3..8) p50 {dstep['p50_ms']:.3f} ms, avg {dstep['avg_ms']:.3f} ms on '{card}'",
              flush=True)

        # 6. export through the board, reloaded: the same greedy tokens
        out = os.path.join(root, "export")
        code, res = _http(port, dict(base, output_dir=out), path="/api/export")
        require(code == 200 and "error" not in res, f"/api/export: {res}")
        st = _board_wait(port, "/api/export/status", lambda s: s["state"] in ("done", "error"),
                         "the export")
        require(st["state"] == "done" and os.path.exists(os.path.join(out, "Modelfile")),
                f"the export: {st}")
        reloaded = load_hf_checkpoint(out, cfg)
        again = Generator(reloaded, cfg).generate(ids, max_new_tokens=BOARD_CHAT_TOKENS,
                                                  temperature=0.0)
        require(np.array_equal(again, direct), "the reloaded export's greedy tokens differ")
        del reloaded
        print(f"[{tag}] /api/export reloaded: greedy tokens equal to the in-memory model's",
              flush=True)
        server.shutdown()
        server.server_close()
        server = None
        del params, chat_gen
        _free()

        # 7. the card-side script twins, in this process
        pb = _script_module("torch_prefill_bench").main(seqlen=2048, layers=BOARD_LAYERS,
                                                         train=True)
        cm = _script_module("torch_cal_mfu").main(measure=True, layers=BOARD_LAYERS)
        rows = _script_module("torch_batch_infer").main(
            ["--dataset", "demo", "--dataset_dir", data_dir, "--checkpoint", ckpt,
             "--max_new_tokens", str(BOARD_CHAT_TOKENS),
             "--save_name", os.path.join(root, "preds.jsonl")])
        require(np.isfinite(pb["ms"]) and pb["ms"] > 0 and np.isfinite(cm["mfu"])
                and len(rows) > 0, f"the script twins: {pb} {cm} {len(rows)} rows")
        print(f"[{tag}] scripts: torch_prefill_bench LoRA step T 2048 {pb['ms']:.1f} ms; "
              f"torch_cal_mfu --measure {cm['tokens_per_sec']:.0f} tok/s, MFU "
              f"{100 * cm['mfu']:.2f}%; torch_batch_infer {len(rows)} rows on '{card}'",
              flush=True)
        torch.cuda.synchronize()
        launches = _read_launches(("swa_ring_flash_attention", "swa_ring_flash_decode_stacked",
                                   "delta_step_fused_stacked", "delta_rule_chunk_fused",
                                   "segment_flash_attention", "window_flash_attention",
                                   "swa_train_flash_attention"))
        from infinitevl_tpu_torch.ops.swa_kernels import swa_train_flash_attention as h

        launches["swa_train_flash_attention_bwd"] = h.launches_bwd
        print(f"[{tag}] the phase's routes and scripts in {time.perf_counter() - t_phase:.1f} s; "
              f"launches {launches} on '{card}'", flush=True)
        return launches
    finally:
        T.Trainer.train = real_train
        if server is not None:
            server.shutdown()
            server.server_close()
        shutil.rmtree(root, ignore_errors=True)
        _free()


def main(argv) -> int:
    kernels_only = "--kernels-only" in argv
    only = next((a.split("=", 1)[1].split(",") for a in argv if a.startswith("--only=")), None)
    text_only = "--text-only" in argv
    if only and not (kernels_only or text_only or "--train-only" in argv
                     or "--dt-only" in argv or "--pref-only" in argv or "--long-only" in argv
                     or "--mamba2-only" in argv or "--parallel-only" in argv
                     or "--pp-only" in argv or "--board-only" in argv):
        print("chip_smoke: --only= needs --kernels-only, --text-only, --train-only, "
              "--dt-only, --pref-only, --long-only, --mamba2-only, --parallel-only, "
              "--pp-only or --board-only (the whole run reports every kernel)",
              file=sys.stderr)
        return 2
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
    clock = [time.perf_counter()]

    def took(what: str) -> None:  # each phase's wall seconds, for the time budget
        now = time.perf_counter()
        print(f"[time] {what}: {now - clock[0]:.1f} s", flush=True)
        clock[0] = now

    card = phase_env()
    phase_build(start_bytecode_cache())
    res = phase_kernels(dev, only)
    took("phases 1-3")
    if kernels_only:
        return 0
    if text_only:  # the text path alone (phase 5, with the decode-step profile)
        cfg = infinitevl_3b()
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
        phase_text_path(dev, card, params, cfg, "--profile" in argv)
        return 0
    if "--train-only" in argv:  # the training phases alone (4's training part, 8, 9)
        phase_train_cross_device(dev)
        phase_dt_cross_device(dev)
        phase_train_path(dev, card, "--profile" in argv)
        phase_vit_window_path(dev, card)
        return 0
    if "--dt-only" in argv:  # 4's distillation steps, then phase 10 alone
        phase_dt_cross_device(dev)
        phase_dt_path(dev, card, "--profile" in argv)
        return 0
    if "--pref-only" in argv:  # 4's preference steps, then phase 11 alone
        phase_pref_cross_device(dev)
        phase_pref_path(dev, card)
        return 0
    if "--long-only" in argv:  # 4's long-context and optimizer steps, then phase 12 alone
        phase_long_cross_device(dev)
        phase_long_path(dev, card)
        return 0
    if "--mamba2-only" in argv:  # 4's mamba2 and DoRA steps, then phase 13 alone
        phase_mamba2_cross_device(dev)
        phase_mamba2_path(dev, card)
        return 0
    if "--parallel-only" in argv:  # phases 14 (with 4's two-rank steps) and 15 alone
        par12 = phase_parallel_path(dev, card)[1]
        phase_tp_path(dev, card, par12=par12)
        return 0
    if "--pp-only" in argv:  # phase 16 alone
        phase_pp_path(dev, card)
        return 0
    if "--board-only" in argv:  # phase 17 alone
        phase_board_path(dev, card)
        return 0
    phase_cross_device(dev)
    phase_train_cross_device(dev)
    phase_dt_cross_device(dev)
    phase_pref_cross_device(dev)
    phase_long_cross_device(dev)
    phase_mamba2_cross_device(dev)  # (its two-rank steps run in phase 14's world)
    took("phase 4")

    cfg = infinitevl_3b()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))  # bf16, on the card
    torch.cuda.synchronize()
    print(f"[weights] InfiniteVL-3B random init from seed 0 in {time.perf_counter() - t0:.2f} s",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    text_launches = phase_text_path(dev, card, params, cfg, "--profile" in argv)
    stream_launches, image_launches = phase_stream_path(
        dev, card, params, cfg, "--profile" in argv)
    serve_launches = phase_serve_path(dev, card, params, cfg, "--profile" in argv)
    took("phases 5-7")
    del params  # phase 8 makes its own weights from the seed, recipe by recipe
    _free()
    train = phase_train_path(dev, card, "--profile" in argv)
    train_launches = train["total_launches"]
    vit_launches, vit_peaks = phase_vit_window_path(dev, card)
    res["f"]["vit_train_step_peaks"] = vit_peaks
    took("phases 8-9")
    _free()
    dt_launches = phase_dt_path(dev, card, "--profile" in argv)
    took("phase 10")
    _free()
    pref_launches = phase_pref_path(dev, card)["total_launches"]
    took("phase 11")
    _free()
    long_launches = phase_long_path(dev, card, train["full_2048"]["peak_gb"])["total_launches"]
    took("phase 12")
    _free()
    m2_launches = phase_mamba2_path(dev, card)
    took("phase 13")
    _free()
    par_launches, par12 = phase_parallel_path(dev, card)
    took("phase 14")
    _free()
    tp_launches = phase_tp_path(dev, card, train["full_2048"]["peak_gb"], par12)
    took("phase 15")
    _free()
    pp_launches = phase_pp_path(dev, card)
    took("phase 16")
    _free()
    board_launches = phase_board_path(dev, card)
    took("phase 17")
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
        ("int4_matmul_fused", "int4_matmul.cu",
         "infinitevl_tpu/ops/int4_pallas.py:104", res["g"]),
        # kernel D is on no model path (in the JAX package too): 0 launches
        ("swa_ring_flash_decode", "swa_ring_flash.cu",
         "infinitevl_tpu/ops/swa_pallas.py:418", res["d"]),
        ("window_flash_attention", "vit_flash.cu",
         "infinitevl_tpu/ops/vit_flash.py:169", res["f"]),
        # kernel H: `launches` counts forward launches; the backward's are beside them
        ("swa_train_flash_attention", "swa_train_flash.cu",
         "infinitevl_tpu/ops/swa.py:178", res["h"]),
    ]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"infinitevl_tpu_torch/csrc/{src}",
         "replaces": rep,
         "launches": text_launches[name] + stream_launches[name] + image_launches[name]
         + serve_launches[name] + train_launches[name] + vit_launches[name]
         + dt_launches.get(name, 0) + pref_launches.get(name, 0) + long_launches.get(name, 0)
         + m2_launches.get(name, 0) + par_launches.get(name, 0) + tp_launches.get(name, 0)
         + pp_launches.get(name, 0) + board_launches.get(name, 0),
         "launches_text_path": text_launches[name],
         "launches_stream_path": stream_launches[name],
         "launches_image_path": image_launches[name],
         "launches_serve_path": serve_launches[name],
         "launches_train_path": train_launches[name],
         "launches_vit_window_path": vit_launches[name],
         "launches_dt_path": dt_launches.get(name, 0),
         "launches_pref_path": pref_launches.get(name, 0),
         "launches_long_path": long_launches.get(name, 0),
         "launches_mamba2_path": m2_launches.get(name, 0),
         # summed over the ranks of phase 14's worlds, and of phase 15's
         "launches_parallel_path": par_launches.get(name, 0),
         "launches_tp_path": tp_launches.get(name, 0),
         # summed over the ranks of phase 16's world
         "launches_pp_path": pp_launches.get(name, 0),
         "launches_board_path": board_launches.get(name, 0),
         **({"launches_bwd": train_launches["swa_train_flash_attention_bwd"]
             + dt_launches["swa_train_flash_attention_bwd"]
             + pref_launches["swa_train_flash_attention_bwd"]
             + long_launches["swa_train_flash_attention_bwd"]
             + m2_launches["swa_train_flash_attention_bwd"]
             + par_launches["swa_train_flash_attention_bwd"]
             + tp_launches["swa_train_flash_attention_bwd"]
             + pp_launches["swa_train_flash_attention_bwd"]
             + board_launches["swa_train_flash_attention_bwd"]}
            if name == "swa_train_flash_attention" else {}), **r}
        for name, src, rep, r in rows
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
