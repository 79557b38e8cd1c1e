"""Tracing and profiling harness (torch port of infinitevl_tpu/utils/profiling.py).

- `trace()` wraps `torch.profiler` over the CPU and, where there is one, the
  CUDA card, and writes a Chrome trace (open in chrome://tracing, Perfetto
  or TensorBoard's profiler plugin)
- `StepTimer` keeps the streaming demo's per-step latency / FPS summary
  (demo:504-510); it synchronises the timed work's device, since CUDA calls
  return before their kernels finish
- `device_time_ms` times a step on the card with CUDA events after warm-up
  (the role of the JAX package's TPU-relay timer, utils/benchlib.py, which
  is not ported), and `card_line` names the card and its power limit to
  print beside every time
- FLOPs / MFU / weight-read estimators for the InfiniteVL architecture
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import Device, resolve_device

H100_PEAK_BF16 = 989e12  # FLOP/s: NVIDIA H100 SXM, dense bf16 (data sheet, 700 W)
H100_HBM_BW = 3.35e12  # B/s: NVIDIA H100 SXM, HBM3


@contextlib.contextmanager
def trace(logdir: str = "ivl_trace"):
    """torch.profiler session over the CPU and the CUDA card (when there is
    one); on exit a Chrome trace `<ms>.pt.trace.json` is written in
    `logdir`. Yields `logdir`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, f"{int(time.time() * 1e3)}.pt.trace.json"))


class StepTimer:
    """Per-step latency collector with the demo's summary format
    (demo:504-510). Each step runs inside `with timer:`; on a CUDA `device`
    the timer synchronises it on entry and exit, so a step's time holds its
    kernels and nothing queued before it."""

    def __init__(self, device: Optional[Device] = None, warmup: int = 1):
        self.device = resolve_device(device)
        self.times_ms: List[float] = []
        self.warmup = warmup
        self._t0: Optional[float] = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.times_ms.append((time.perf_counter() - self._t0) * 1e3)

    def summary(self) -> Dict[str, float]:
        arr = np.asarray(self.times_ms[self.warmup:] or self.times_ms)
        return {
            "steps": len(self.times_ms),
            "avg_ms": float(arr.mean()),
            "p50_ms": float(np.percentile(arr, 50)),
            "p99_ms": float(np.percentile(arr, 99)),
            "fps": float(1000.0 / arr.mean()),
        }

    def print_summary(self, label: str = "Performance Summary"):
        s = self.summary()
        print("=" * 60)
        print(f"{label}:")
        print(f"Average Latency per Step: {s['avg_ms']:.3f} ms")
        print(f"Average Throughput: {s['fps']:.2f} steps/s")
        print("=" * 60)


def card_line(device: Optional[Device] = None) -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` gives them."""
    index = resolve_device(device).index or 0
    return subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def device_time_ms(step, carry, warmup: int = 2, iters: int = 6) -> float:
    """Mean device milliseconds of `carry = step(carry)` on the CUDA card:
    `warmup` calls (kernel builds, allocator), then `iters` calls between
    two CUDA events on the current stream."""
    for _ in range(warmup):
        carry = step(carry)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        carry = step(carry)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def require_card(what: str) -> torch.device:
    """The CUDA card for a measurement that only the card can give; raises
    naming `what` where there is none (no fallback to the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} measures the CUDA card and none is available "
            "(torch.cuda.is_available() is False)")
    return torch.device("cuda", torch.cuda.current_device())


def decoder_flops_per_token(cfg) -> float:
    """2 * active params per token (matmul FLOPs; attention extra excluded)."""
    t = cfg.text
    D, I = t.hidden_size, t.intermediate_size
    swa = 2 * D * t.head_dim * (t.num_attention_heads + 2 * t.num_key_value_heads) + 3 * D * I
    HK = t.num_linear_heads * t.linear_head_dim
    lin = (
        D * HK + D * t.linear_key_dim + D * t.linear_value_dim
        + 2 * D * t.num_linear_heads
        + D * t.num_linear_heads * t.head_v_dim * 2
        + 3 * D * I
    )
    total = t.num_swa_layers * swa + t.num_linear_layers * lin
    return 2.0 * total


def mfu(tokens_per_sec: float, cfg, peak: float = H100_PEAK_BF16) -> float:
    return tokens_per_sec * decoder_flops_per_token(cfg) / peak


def decode_hbm_floor_ms(n_params: int, dtype_bytes: int = 2,
                        bw: float = H100_HBM_BW) -> float:
    """Weights-read lower bound per decode step."""
    return n_params * dtype_bytes / bw * 1e3


def _named_leaves(tree, key=""):
    """(innermost dict key, tensor) for every tensor of a nested
    dict / list / tuple tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, k)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _named_leaves(v, key)
    elif isinstance(tree, torch.Tensor):
        yield key, tree


def decode_weight_read_bytes(text_params) -> int:
    """Bytes a B=1 text decode step streams from device memory for weights.

    - vision params are never touched at decode: pass ``params["text"]``;
    - the embedding gather reads ~one row, so the [vocab, hidden] table
      counts only when the tied head matmul reads it in full. Tied:
      ``embed`` counts once (the head read). Untied: ``embed`` is
      gather-only (excluded) and ``lm_head`` / ``lm_head_q`` counts.
      quantize_embed serving: ``embed_q`` is the gather copy (excluded),
      ``head_q`` the pre-transposed head operand (counted).

    Activation and state reads (the 133.9 MB ring + delta state) are not
    weights and are excluded: this bounds the weight stream only, so a
    measured step must sit at or above the floor it gives."""
    untied = "lm_head" in text_params or "lm_head_q" in text_params
    total = 0
    for key, leaf in _named_leaves(text_params):
        if key == "embed_q" or (key == "embed" and untied):
            continue  # gather-only table: ~one row per token, not a stream
        total += leaf.numel() * leaf.element_size()
    return int(total)
