"""Static request batching for serving (torch port of
infinitevl_tpu/serve/batching.py).

Decode at small batch is bound by the weight read, so the serving-side win
is BATCHING decode steps: one weight read per step amortizes over B
requests.

Design:
- requests are grouped by EXACT prompt length: no padding, no masks, and
  the shared cum_len stays right for every row. Batch sizes are restricted
  to a small ladder.
- a worker thread drains the queue: it waits up to max_wait_ms for
  same-length companions, picks the largest ladder batch that fits, pads
  the batch by REPEATING a row (dropped on output), prefills once into a
  FRESH state, then decodes chunks (decode_chunk: one host sync per chunk,
  per-row EOS).
- greedy / sampled rows in one batch share the chunk; outputs are trimmed
  per row and futures resolved individually.

All device work happens on the worker thread, one batch at a time.
`quant` ("int8" / "int4") quantizes the weights first (models/quant.py)."""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import Device, resolve_device
from ..generation import (
    check_params_device,
    decode_chunk,
    prefill,
    sample_token,
    serving_params,
)
from ..models.state import init_decoder_state

Params = Dict[str, Any]


class _Request:
    __slots__ = ("ids", "max_new_tokens", "temperature", "top_k", "top_p",
                 "seed", "eos", "future", "t_submit")

    def __init__(self, ids, max_new_tokens, temperature, top_k, top_p, seed,
                 eos):
        self.ids = np.asarray(ids, np.int64)
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.seed = seed
        self.eos = eos
        self.future: Future = Future()
        self.t_submit = time.perf_counter()


class BatchingEngine:
    """Thread-safe batched generation over one model replica."""

    def __init__(
        self,
        params: Params,
        cfg,
        dtype: torch.dtype = torch.bfloat16,
        # a B = 32 state of the 3B model is 4.3 GB beside the weights
        batch_sizes: Sequence[int] = (32, 16, 8, 4, 2, 1),
        max_wait_ms: float = 30.0,
        chunk_size: int = 8,
        quant: Optional[str] = None,
        device: Optional[Device] = None,
    ):
        self.device = resolve_device(device)
        check_params_device(params, self.device)
        self.params = serving_params(params, False, quant)
        self.cfg = cfg
        self.dtype = dtype
        self.batch_sizes = tuple(sorted(batch_sizes, reverse=True))
        self.max_wait_ms = max_wait_ms
        self.chunk_size = chunk_size
        self.queue: "queue.Queue[_Request]" = queue.Queue()
        self.stats = {"batches": 0, "requests": 0, "rows": 0}
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------- public
    def generate(
        self,
        ids: np.ndarray,  # [T] or [1, T] token ids
        max_new_tokens: int = 128,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int = 0,
        eos_token_id: Optional[int] = None,
        timeout: Optional[float] = None,
    ) -> List[int]:
        """Blocking submit; returns generated token ids (EOS excluded)."""
        ids = np.asarray(ids)
        if ids.ndim == 2:
            ids = ids[0]
        eos = eos_token_id if eos_token_id is not None else self.cfg.eos_token_id
        req = _Request(ids, max_new_tokens, temperature, top_k, top_p, seed, eos)
        self.queue.put(req)
        return req.future.result(timeout=timeout)

    def shutdown(self):
        self._stop.set()
        self._worker.join(timeout=5)

    # ------------------------------------------------------------- worker
    def _collect(self) -> List[_Request]:
        """Pull a same-length group, waiting briefly for companions."""
        try:
            first = self.queue.get(timeout=0.1)
        except queue.Empty:
            return []
        group = [first]
        L = len(first.ids)
        deadline = time.perf_counter() + self.max_wait_ms / 1000.0
        leftovers: List[_Request] = []
        while len(group) < self.batch_sizes[0]:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                r = self.queue.get(timeout=remaining)
            except queue.Empty:
                break
            if len(r.ids) == L:
                group.append(r)
            else:
                leftovers.append(r)
        for r in leftovers:  # different lengths go back for the next batch
            self.queue.put(r)
        return group

    def _run(self):
        while not self._stop.is_set():
            group = self._collect()
            if not group:
                continue
            try:
                self._serve_batch(group)
            except Exception as e:  # propagate to the waiting callers
                for r in group:
                    if not r.future.done():
                        r.future.set_exception(e)

    def _serve_batch(self, group: List[_Request]):
        cfg = self.cfg
        B = next(b for b in self.batch_sizes if b <= len(group))
        # requests beyond the ladder size go back for the next batch —
        # NEVER dropped (their futures must resolve)
        for r in group[B:]:
            self.queue.put(r)
        group = group[:B]
        rows = [r.ids for r in group]
        # pad the batch to the ladder size by repeating row 0 (dropped later)
        while len(rows) < B:
            rows.append(rows[0])
        dev = self.device
        ids = torch.as_tensor(np.stack(rows), dtype=torch.long, device=dev)
        T = ids.shape[1]
        pos = torch.arange(T, device=dev).expand(3, B, T)
        # a fresh state per batch: nothing carries over between batches
        state = init_decoder_state(cfg.text, B, dtype=self.dtype, device=dev)
        logits, state = prefill(self.params, cfg, ids, pos, state)
        rope_delta = torch.zeros((B, 1), dtype=torch.long, device=dev)
        # sampling knobs are shared per batch (first request wins; the API
        # layer routes same-temperature requests together in practice)
        r0 = group[0]
        gen = torch.Generator(device=dev)
        gen.manual_seed(r0.seed)
        tok = sample_token(logits, gen, r0.temperature, r0.top_k, r0.top_p)
        t0 = tok.cpu().numpy()
        eos = r0.eos
        outs: List[List[int]] = [[] for _ in range(B)]
        done = t0 == eos
        for b in range(B):
            if not done[b]:
                outs[b].append(int(t0[b]))
        max_new = max(r.max_new_tokens for r in group)
        finished = torch.as_tensor(done, device=dev)
        tok_in = tok[:, None]
        produced = 1
        while produced < max_new and not bool(finished.all()):
            steps = min(self.chunk_size, max_new - produced)
            toks, state, finished, _ = decode_chunk(
                self.params, cfg, tok_in, rope_delta, state, finished, gen,
                steps=steps, eos=eos,
                temperature=r0.temperature, top_k=r0.top_k, top_p=r0.top_p,
            )
            t = toks.cpu().numpy()  # one sync per chunk
            for b in range(B):
                if done[b]:
                    continue
                for x in t[b]:
                    if x == eos or len(outs[b]) >= group[min(b, len(group) - 1)].max_new_tokens:
                        done[b] = True
                        break
                    outs[b].append(int(x))
            produced += steps
            tok_in = toks[:, -1:]
        self.stats["batches"] += 1
        self.stats["requests"] += len(group)
        self.stats["rows"] += B
        for b, r in enumerate(group):
            r.future.set_result(outs[b][: r.max_new_tokens])
