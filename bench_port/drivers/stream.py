"""Multi-camera streaming: `cameras` streams of raw frames, one lockstep
`StreamingEngine.push_frames_batched` call a step, in a closed loop.

Set-up draws a pool of `pool_frames` raw uint8 frames per camera from the
seed (camera c's frame n is pool[c][n % pool_frames]), builds the weights,
and primes every stream with `prime_frames` steps through the same entry,
which also warms every shape the window uses. In the window the port's
`native.FramePipeline` prepares step n + 1's frames on its host workers
while the card runs step n. A step runs from the first wait for its frames
to the engine's return.

Correctness: the state of `check_streams` streams drawn from the seed is
copied after window step `check_step` (drawn from the seed); once the
window has closed the program decodes one probe token from each copy. The
plain fp32 reference recomputes each checked stream from its raw frames,
from an empty state, and the state and the probe's logits are compared."""

from __future__ import annotations

import json
import time

import numpy as np


def _frames(traffic, seed: int, device):
    """The raw frame pools [cameras, pool, H, W, 3] uint8, drawn on the device."""
    import torch
    from harness.weights import torch_seed

    H, W = traffic["frame_hw"]
    g = torch.Generator(device=device).manual_seed(torch_seed(seed) ^ 0x5F3759DF)
    shape = (traffic["cameras"], traffic["pool_frames"], H, W, 3)
    return torch.randint(0, 256, shape, generator=g, device=device, dtype=torch.uint8).cpu().numpy()


def plan(traffic, seed: int):
    """(streams checked, the window step after which they are copied, probe
    token). The checked streams are spread over the batch: one drawn from
    each of `check_streams` equal slices of it."""
    rng = np.random.default_rng([int(seed), 1])
    B, n = traffic["cameras"], traffic["check_streams"]
    rows = [int(rng.integers(k * B // n, (k + 1) * B // n)) for k in range(n)]
    lo, hi = traffic["check_step"]
    return rows, int(rng.integers(lo, hi + 1)), int(rng.integers(0, traffic["probe_vocab"]))


def run(ctx):
    import torch
    from harness import flops, trace
    from harness.context import DriverResult, Readings
    from harness.weights import build, port_config
    from infinitevl_tpu_torch.generation import decode_step
    from infinitevl_tpu_torch.models.state import clone_state, state_row
    from infinitevl_tpu_torch.native import FramePipeline
    from infinitevl_tpu_torch.streaming import StreamingEngine

    tr, spec, dev = ctx.cell.traffic, ctx.cell.config, ctx.device
    cfg = port_config(spec)
    B, (H, W), fps = tr["cameras"], tr["frame_hw"], tr["fps"]
    n_pool, prime = tr["pool_frames"], tr["prime_frames"]
    rows, check_step, probe = plan(tr, ctx.seed)
    pool = _frames(tr, ctx.seed, dev)
    params = build(spec, ctx.seed, dev)
    eng = StreamingEngine(params, cfg, frame_hw=(H, W), batch_size=B, device=dev)
    v = cfg.vision
    pipe = FramePipeline(workers=tr["prep_workers"], patch_size=v.patch_size,
                         temporal_patch_size=v.temporal_patch_size, merge_size=v.spatial_merge_size)
    rf = torch.profiler.record_function

    def submit(n):
        return [pipe.submit(pool[c, n % n_pool], (H, W)) for c in range(B)]

    def step(n, tickets):
        """Step n: wait for its frames, queue step n + 1's, run the engine.
        Returns (step seconds, wait seconds, the next tickets)."""
        t0 = time.perf_counter()
        with rf("bench.collect_frames"):
            pv = np.concatenate([pipe.collect(t, (H, W)) for t in tickets])
        t1 = time.perf_counter()
        nxt = submit(n + 1)
        with rf("bench.engine_step"):
            eng.push_frames_batched(pv, fps)
        return time.perf_counter() - t0, t1 - t0, nxt

    try:
        tickets = submit(0)
        for n in range(prime):
            _, _, tickets = step(n, tickets)
        setup_s = time.perf_counter() - ctx.t_process

        n, steps, waits, snap = prime, [], [], None
        t_start = time.perf_counter()
        t_end = t_start + ctx.seconds
        while time.perf_counter() < t_end:
            dt, wait, tickets = step(n, tickets)
            steps.append(dt)
            waits.append(wait)
            n += 1
            if n - prime == check_step:
                snap = [state_row(eng.state, r) for r in rows], eng.pos_max
        t_last = time.perf_counter()
        frames_done = len(steps) * B
        while snap is None:  # a window shorter than the checked step: go on, untimed
            _, _, tickets = step(n, tickets)
            n += 1
            if n - prime == check_step:
                snap = [state_row(eng.state, r) for r in rows], eng.pos_max

        summary, calls = None, {}
        if ctx.trace:
            n_traced = tr["traced_steps"]
            with trace.profiled() as prof:
                with trace.window_mark():
                    for _ in range(n_traced):
                        _, _, tickets = step(n, tickets)
                        n += 1
            summary = trace.summarize(prof, n_traced)
            calls = declared_calls(spec, cfg, B, eng.tokens_per_frame + 1, n_traced,
                                   (H // v.patch_size) * (W // v.patch_size))
        # drain the pipeline's last tickets before it closes
        for t in tickets:
            pipe.collect(t, (H, W))
    finally:
        pipe.close()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    states, pos_max = snap
    probes = []
    for st in states:
        st = clone_state(st)
        delta = torch.tensor([[pos_max + 1 - st["cum_len"]]], dtype=torch.long, device=dev)
        logits, _ = decode_step(eng.params, cfg, torch.tensor([[probe]], device=dev), delta, st)
        probes.append(logits[0].float())
    del eng, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks, by_key = compare(spec, ctx.seed, dev, pool, rows, prime + check_step, (H, W), fps,
                             probe, pos_max + 1, states, probes)

    gh, gw = H // v.patch_size, W // v.patch_size
    T = 1 + (gh // v.spatial_merge_size) * (gw // v.spatial_merge_size)
    window_flops = frames_done * flops.stream_frame_flops(spec, gh, gw, prime * T)
    wall = t_last - t_start
    from harness.stats import percentile, rate

    e2e = {"frames_per_s": rate(frames_done, t_start, t_last),
           "frame_step_p95_ms": 1e3 * percentile(steps, 95.0), "setup_s": setup_s}
    window = {"prep_wait_ms": [1e3 * w for w in waits], "flops": window_flops, "wall_s": wall,
              "tokens_per_frame": T}
    return DriverResult(end_to_end=e2e, attempted=frames_done, failed=0, checks=checks,
                        memory_peak_bytes=int(peak),
                        readings=Readings(ctx.cell.bench_dir, summary, calls, window),
                        notes=[f"steps {len(steps)}, frames {frames_done}, checked streams {rows} "
                               f"after window step {check_step}",
                               "worst state leaf by key: " + json.dumps(by_key)])


def declared_calls(spec, cfg, B, T, n_steps, n_patches):
    """The kernel calls of n_steps steady steps, with their shapes, for the
    work counts (work/<kernel>.py): C per DeltaNet layer, A1 per SWA layer
    (the ring full after priming), F per window block of the ViT."""
    tc, v = cfg.text, cfg.vision
    calls = {"delta_chunk": [], "swa_ring": [], "vit_flash": []}
    win = ((v.window_size // v.spatial_merge_size // v.patch_size) * v.spatial_merge_size) ** 2
    for _ in range(n_steps):
        for i in range(tc.num_hidden_layers):
            role = tc.layer_role(i)
            if role == "linear_attention" and T > tc.recurrent_threshold:
                calls["delta_chunk"].append(dict(B=B, T=T, H=tc.num_linear_heads,
                                                 K=tc.linear_head_dim, V=tc.head_v_dim))
            elif role == "sliding_attention":
                calls["swa_ring"].append(dict(B=B, T=T, Hq=tc.num_attention_heads,
                                              Hkv=tc.num_key_value_heads, D=tc.head_dim,
                                              cap=tc.swa_capacity, cum_len=tc.swa_capacity,
                                              window=tc.sliding_window))
        for j in range(v.depth):
            if j not in v.fullatt_block_indexes:
                calls["vit_flash"].append(dict(S=B * n_patches, H=v.num_heads,
                                               D=v.hidden_size // v.num_heads, L=win))
    return {k: c for k, c in calls.items() if c}


def compare(spec, seed, dev, pool, rows, n_frames, hw, fps, probe, probe_pos, states, probes,
            matmul=None):
    """Each checked stream recomputed by the plain reference from its raw
    frames: the worst relative error (L2) of any state leaf of any layer,
    and of the probe's logits."""
    import torch
    from harness.weights import build
    from reference import infinitevl as ref

    ref.fp32_exact()
    mm = matmul or ref.mm_fp32
    S = ref.Sizes(spec)
    params = build(spec, seed, dev)
    worst = {}
    probe_err = 0.0
    for r, st, lp in zip(rows, states, probes):
        rs, logits = reference_stream(params, S, pool[r], n_frames, hw, fps, probe, probe_pos,
                                      dev, mm)
        for key, val in rs.items():
            got = st[key][:, 0].float()
            for layer in range(val.shape[0]):
                worst[key] = max(worst.get(key, 0.0), rel_err(got[layer], val[layer]))
        probe_err = max(probe_err, rel_err(lp, logits[0]))
        del rs
    return {"state_err": max(worst.values()), "probe_logit_err": probe_err}, worst


def reference_stream(params, S, frames, n_frames, hw, fps, probe, probe_pos, dev, mm):
    """The reference's state after n_frames frames of one camera and the
    probe token's logits after them."""
    import torch
    from reference import infinitevl as ref

    H, W = hw
    gh, gw = H // S.ps, W // S.ps
    ids, pos, conv_start = ref.stream_sequence(S, n_frames, gh, gw, fps, dev)
    x = ref.embed(params["text"], ids)
    vis_rows = torch.nonzero(ids == S.image_token_id)[:, 0]
    per = vis_rows.numel() // n_frames
    for f in range(n_frames):
        frame = torch.as_tensor(frames[f % frames.shape[0]], device=dev)
        patches = ref.normalize_patchify(frame, S)
        x[vis_rows[f * per: (f + 1) * per]] = ref.vit_frame(params["visual"], S, patches, gh, gw, mm)
    T = x.shape[0]
    x = torch.cat([x, ref.embed(params["text"], torch.tensor([probe], device=dev))])
    pos = torch.cat([pos, torch.full((3, 1), probe_pos, dtype=pos.dtype, device=dev)], 1)
    conv_start = torch.cat([conv_start, conv_start.new_zeros(1)])
    return ref.decoder(params["text"], S, x, pos, conv_start, logits_at=[T], state_at=T, mm=mm)


def control(cell, seed: int, dev, matmul, checked=None):
    """The control's readings: the reference with `matmul`'s arithmetic in
    the program's place, on the streams, frames and probe a run of `seed`
    checks, against the fp32 reference."""
    from harness.weights import build
    from reference import infinitevl as ref

    tr, spec = cell.traffic, cell.config
    ref.fp32_exact()
    S = ref.Sizes(spec)
    rows, check_step, probe = plan(tr, seed)
    pool = _frames(tr, seed, dev)
    params = build(spec, seed, dev)
    n = tr["prime_frames"] + check_step
    probe_pos = 2 + ref.frame_t_offset(n - 1, tr["fps"], S)
    worst, probe_err = {}, 0.0
    for r in rows:
        want, lw = reference_stream(params, S, pool[r], n, tr["frame_hw"], tr["fps"], probe,
                                    probe_pos, dev, ref.mm_fp32)
        got, lg = reference_stream(params, S, pool[r], n, tr["frame_hw"], tr["fps"], probe,
                                   probe_pos, dev, matmul)
        for key, val in want.items():
            for layer in range(val.shape[0]):
                worst[key] = max(worst.get(key, 0.0), rel_err(got[key][layer], val[layer]))
        probe_err = max(probe_err, rel_err(lg[0], lw[0]))
    return {"state_err": max(worst.values()), "probe_logit_err": probe_err, "by_key": worst}


def rel_err(got, want) -> float:
    want = want.float()
    return float((got.float() - want).norm() / want.norm().clamp(min=1e-30))
