"""Wrappers of the Gated-DeltaNet kernels, under the names of their Pallas
counterparts in infinitevl_tpu/ops/delta_pallas.py: the decode step (B,
csrc/delta_step.cu) and the chunkwise prefill (C, csrc/delta_chunk.cu).

A tensor on the CPU takes the plain version (ops/delta_rule.delta_rule_step;
for C, ops/delta_rule.delta_rule_chunk in fp32 for fp32 inputs and
`delta_chunk_passes`, the twin of the kernel's bf16 passes, for bf16
inputs); a CUDA tensor launches the kernel or raises. Each wrapper counts
its launches in its `launches` attribute."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .delta_rule import delta_rule_chunk, delta_rule_step
from .norms import l2norm
from .vit_kernels import sm_count

KERNEL_K = 128  # the key head dim the kernels are written for
CHUNK = 64  # chunk length of kernel C
CHUNK_BV = 64  # value columns per block of kernel C's fp32 scan
CHUNK_BF16_MAX_V = 256  # the largest value dim of kernel C's bf16 body
STEP_VT = 32  # value columns per block of kernel B
# value columns a block of kernel C's bf16 scan may take, widest first, and
# the share of the card's SMs its blocks should fill (see scan_v_tile)
SCAN_V_TILES = (64, 32, 16)
SCAN_FILL = 0.75

_DTYPES = {torch.float32: _build.DTYPE_F32, torch.bfloat16: _build.DTYPE_BF16}


def delta_step_fused_stacked(
    q: torch.Tensor,  # [B, H, K] post-conv raw projections (pre-l2norm)
    k: torch.Tensor,
    v: torch.Tensor,  # [B, H, V]
    g: torch.Tensor,  # [B, H] log-decay, fp32
    beta: torch.Tensor,  # [B, H] fp32
    stacked_h: torch.Tensor,  # [L, B, H, K, V] fp32, updated in place
    layer: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One decode step of DeltaNet layer `layer`: updates stacked_h[layer]
    IN PLACE (other layers untouched) and returns o [B, H, V] in v.dtype.
    Semantics of delta_rule_step, qk l2norm included. On the card this is
    one launch: the kernel normalizes q and k, scales q and takes exp(g)
    itself, and writes o in v's dtype."""
    name = "delta_step_fused_stacked"
    if stacked_h.device.type == "cpu":
        o, new_h = delta_rule_step(q, k, v, g, beta, stacked_h[layer], scale)
        stacked_h[layer].copy_(new_h)
        return o
    if stacked_h.device.type != "cuda":
        raise ValueError(f"{name}: device {stacked_h.device} is neither cpu nor cuda")
    B, H, K = q.shape
    V = v.shape[-1]
    L = stacked_h.shape[0]
    if stacked_h.dtype != torch.float32 or not stacked_h.is_contiguous():
        raise TypeError(f"{name}: the state must be contiguous float32")
    if stacked_h.shape != (L, B, H, K, V):
        raise ValueError(f"{name}: state shape {tuple(stacked_h.shape)} is not "
                         f"[L, {B}, {H}, {K}, {V}]")
    if K != KERNEL_K or V % STEP_VT:
        raise ValueError(f"{name}: key head dim {K} and value dim {V}; the kernel takes "
                         f"{KERNEL_K} and a multiple of {STEP_VT}")
    if not 0 <= layer < L:
        raise IndexError(f"{name}: layer {layer} outside the stack of {L}")
    if v.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {v.dtype} not supported (float32, bfloat16)")
    shapes = dict(q=(B, H, K), k=(B, H, K), v=(B, H, V), g=(B, H), beta=(B, H))
    dtypes = dict(q=v.dtype, k=v.dtype, v=v.dtype, g=torch.float32, beta=torch.float32)
    args = dict(q=q, k=k, v=v, g=g, beta=beta)
    for arg, t in args.items():
        if t.device != stacked_h.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, state on {stacked_h.device}")
        if tuple(t.shape) != shapes[arg]:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected {shapes[arg]}")
        if t.dtype != dtypes[arg]:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, the kernel takes "
                            f"{dtypes[arg]}")
    if scale is None:
        scale = K**-0.5
    # the model's slices are contiguous already: no copy is made there
    q, k, v, g, beta = (t.contiguous() for t in (q, k, v, g, beta))
    o = torch.empty((B, H, V), dtype=v.dtype, device=v.device)
    lib = _build.load_library()
    with torch.cuda.device(q.device):  # launch on the tensors' card
        _build.check(
            lib.ivl_delta_step(
                _DTYPES[v.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                beta.data_ptr(), stacked_h.data_ptr(), o.data_ptr(),
                B, H, K, V, int(layer), float(scale),
                torch.cuda.current_stream(q.device).cuda_stream,
            ),
            name,
        )
    delta_step_fused_stacked.launches += 1
    return o


delta_step_fused_stacked.launches = 0


def chunk_scratch_bytes(B: int, T: int, H: int, V: int, dtype: torch.dtype) -> int:
    """Scratch of kernel C per (b, h, chunk) (csrc/delta_chunk.cu). fp32: w
    and q e^g transposed, k e^{g_C - g}, the masked q k^T transposed, u,
    e^{g_C} and the flag of a segment starting at the chunk's edge, all
    fp32. bf16: w, q e^g, k e^{g_C - g}, the masked q k^T and u in bf16,
    row-major, then the two fp32 scalars."""
    n_chunks = B * H * -(-T // CHUNK)
    tiles = 3 * KERNEL_K * CHUNK + CHUNK * CHUNK + CHUNK * V
    if dtype == torch.float32:
        return 4 * n_chunks * (tiles + 2)
    return n_chunks * (2 * tiles + 8)


def scan_v_tile(B: int, H: int, V: int, sms: int) -> int:
    """Value columns a block of kernel C's bf16 scan takes, on a card of
    `sms` SMs: the widest of SCAN_V_TILES that divides V and still gives
    B H V / tile blocks on at least SCAN_FILL of the SMs, else the narrowest
    that divides V. A block walks every chunk of its (b, h) in order and
    reads each chunk's w, q e^g, k e^{g_C - g} and masked q k^T whole, so a
    narrower tile buys SMs for the sequential walk with reads of those
    operands repeated over more blocks: 32 at B 1 and H 16 (128 blocks), 64
    at B 2, as the sweep of chip_smoke.py phase 3 found them fastest."""
    tiles = [bv for bv in SCAN_V_TILES if V % bv == 0]
    if not tiles:
        raise ValueError(f"scan_v_tile: value dim {V} is no multiple of {min(SCAN_V_TILES)}")
    for bv in tiles:
        if B * H * (V // bv) >= SCAN_FILL * sms:
            return bv
    return tiles[-1]


def _pad_chunks(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero rows appended along T (dim 1)."""
    if not pad:
        return x
    return torch.nn.functional.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))


def _chunk_prep(qn, kn, vf, gf, bf, sid, rnd):
    """Pass 1 of kernel C on [B, H, N, C, *] chunks, all chunks at once:
    (I + A)^-1 formed in fp32, then w and u as products of it rounded (the
    kernel's delta_chunk_prep_bf16_kernel). `sid` [B, 1, N, C] segment ids
    or None (g already zero on a segment's first token). Returns (w, u,
    q e^g, the masked q k^T, k e^{g_C - g}, e^{g_C}), each rounded by
    `rnd` except the last."""
    C = qn.shape[-2]
    dev = qn.device
    gcs = torch.cumsum(gf, dim=-1)
    tril = torch.tril(torch.ones((C, C), dtype=torch.bool, device=dev))
    ratio = torch.where(tril, torch.exp(torch.clamp(gcs[..., :, None] - gcs[..., None, :],
                                                    max=0.0)), 0.0)
    if sid is not None:
        ratio = torch.where(sid[..., :, None] == sid[..., None, :], ratio, 0.0)
        first = (sid == sid[..., :1])[..., None]
        last = (sid == sid[..., -1:])[..., None]
    a = torch.tril(kn @ kn.transpose(-1, -2) * ratio, diagonal=-1) * bf[..., :, None]
    eye = torch.eye(C, dtype=torch.float32, device=dev)
    x = rnd(torch.linalg.solve_triangular(a, eye.expand_as(a), upper=False,
                                          unitriangular=True))
    eg = torch.exp(gcs)[..., None]
    kb, qb = kn * eg, qn * eg
    k_out = kn * torch.exp(gcs[..., -1:] - gcs)[..., None]
    bend = torch.exp(gcs[..., -1])
    if sid is not None:
        kb = torch.where(first, kb, 0.0)
        qb = torch.where(first, qb, 0.0)
        k_out = torch.where(last, k_out, 0.0)
        bend = torch.where(sid[..., 0] == sid[..., -1], bend, 0.0)
    w = rnd(x @ rnd(kb * bf[..., None]))
    u = rnd(x @ rnd(vf * bf[..., None]))
    attn = rnd(torch.where(tril, qn @ kn.transpose(-1, -2) * ratio, 0.0))
    return w, u, rnd(qb), attn, rnd(k_out), bend


def _chunk_scan(w, u, k_out, bend, keep, s0, rnd):
    """The sequential pass: the fp32 state threaded through the chunks, read
    rounded by w S and q S. Returns (the state before each chunk as read
    [B, H, N, K, V], y [B, H, N, C, V], the final fp32 state)."""
    B, H, N, C, K = w.shape
    V = u.shape[-1]
    s = (torch.zeros((B, H, K, V), dtype=torch.float32, device=w.device)
         if s0 is None else s0.float())
    states, ys = [], []
    for n in range(N):
        if keep is not None:  # a segment starts at the chunk's edge: no state enters
            s = s * keep[:, :, n, None, None]
        sb = rnd(s)
        y = rnd(u[:, :, n] - w[:, :, n] @ sb)
        states.append(sb)
        ys.append(y)
        s = s * bend[:, :, n, None, None] + k_out[:, :, n].transpose(-1, -2) @ y
    return torch.stack(states, dim=2), torch.stack(ys, dim=2), s


def delta_chunk_passes(
    q: torch.Tensor,  # [B, T, H, K] raw (pre-l2norm)
    k: torch.Tensor,
    v: torch.Tensor,  # [B, T, H, V]
    g: torch.Tensor,  # [B, T, H] log-decay
    beta: torch.Tensor,  # [B, T, H]
    initial_state: Optional[torch.Tensor] = None,  # [B, H, K, V] fp32
    scale: Optional[float] = None,
    segment_ids: Optional[torch.Tensor] = None,  # [B, T] ids of packed sequences
    chunk_size: int = CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain twin of kernel C's passes, with the kernel's rounding
    points: l2norm(q), l2norm(k) in the input dtype (JAX's l2norm), q scale
    rounded; pass 1 forms (I + A)^-1 explicitly in fp32 and computes w and
    u from it rounded, all stored operands rounded; the scan reads the
    state rounded and rounds y; the output pass is (q e^g) S_n + tril(q
    k^T) y_n over the stored per-chunk states and y. Rounding is to bf16
    for bf16 inputs (the JAX model path's delta_rule_chunk for bf16 models,
    but for (I + A)^-1, which JAX forms by Newton-Schulz in bf16) and none
    for fp32 inputs. The kernel's chunk is CHUNK; the math holds for any.
    Returns (o [B, T, H, V] in v.dtype, final state fp32)."""
    B, T, H, K = q.shape
    V = v.shape[-1]
    C = chunk_size
    cd = torch.bfloat16 if v.dtype == torch.bfloat16 else torch.float32
    rnd = (lambda x: x) if cd == torch.float32 else (lambda x: x.to(cd).float())
    if scale is None:
        scale = K**-0.5
    kn = l2norm(k).float()
    qn = rnd(l2norm(q).float() * scale)
    vf, gf, bf = v.float(), g.float(), beta.float()
    pad = (-T) % C
    start = None
    if segment_ids is not None:
        start = torch.cat([torch.zeros((B, 1), dtype=torch.bool, device=q.device),
                           segment_ids[:, 1:] != segment_ids[:, :-1]], dim=1)
        if pad:  # rows past T continue the last segment
            segment_ids = torch.cat([segment_ids, segment_ids[:, -1:].expand(B, pad)], dim=1)
            start = torch.nn.functional.pad(start, (0, pad))
    qn, kn, vf, gf, bf = (_pad_chunks(x, pad) for x in (qn, kn, vf, gf, bf))
    N = (T + pad) // C

    def chunked(x):  # [B, N C, H, *] -> [B, H, N, C, *]
        return x.reshape(B, N, C, H, *x.shape[3:]).movedim(3, 1)

    qn, kn, vf, gf, bf = map(chunked, (qn, kn, vf, gf, bf))
    sid = keep = None
    if segment_ids is not None:
        sid = segment_ids.reshape(B, 1, N, C)
        starts = start.reshape(B, 1, N, C)
        gf = torch.where(starts, 0.0, gf)
        keep = 1.0 - starts[..., 0].float()
    w, u, qb, attn, k_out, bend = _chunk_prep(qn, kn, vf, gf, bf, sid, rnd)
    states, ys, final = _chunk_scan(w, u, k_out, bend, keep, initial_state, rnd)
    o = qb @ states + attn @ ys  # [B, H, N, C, V]
    o = o.reshape(B, H, N * C, V)[:, :, :T].transpose(1, 2)
    return o.to(v.dtype), final


def delta_rule_chunk_fused(
    q: torch.Tensor,  # [B, T, H, K] raw (pre-l2norm)
    k: torch.Tensor,
    v: torch.Tensor,  # [B, T, H, V]
    g: torch.Tensor,  # [B, T, H] log-decay
    beta: torch.Tensor,  # [B, T, H]
    initial_state: Optional[torch.Tensor] = None,  # [B, H, K, V] fp32
    scale: Optional[float] = None,
    chunk_size: int = CHUNK,
    out_state: Optional[torch.Tensor] = None,  # [B, H, K, V] fp32, written in place
    segment_ids: Optional[torch.Tensor] = None,  # [B, T] integer ids of packed sequences
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel C: chunkwise gated delta rule forward, q and k l2-normalized
    inside. Returns (o [B, T, H, V] in v.dtype, final_state [B, H, K, V]
    fp32). fp32 inputs: all arithmetic in fp32, the semantics of
    delta_rule_chunk(..., compute_dtype=torch.float32). bf16 inputs: the
    JAX model path's precision (bf16 operands, fp32 accumulation, the
    state an fp32 accumulator read as bf16), the semantics of
    `delta_chunk_passes`. The final state is written into `out_state` where
    one is given (it may be `initial_state` itself: a layer's slab of the
    stacked state is then updated where it lies), else into a new tensor.
    `segment_ids` mark sequences packed along T: the state restarts at each
    segment's first token and `initial_state` seeds the first segment only.
    With a gradient the backward recomputes the plain fp32 chunk form."""
    name = "delta_rule_chunk_fused"
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: device {q.device} is neither cpu nor cuda")
    if q.device.type == "cpu" and v.dtype != torch.bfloat16:
        o, final = delta_rule_chunk(
            q, k, v, g, beta, initial_state, scale, True, chunk_size,
            segment_ids=segment_ids, compute_dtype=torch.float32,
        )
        if out_state is not None:
            final = out_state.copy_(final)
        return o, final
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, g, beta, initial_state)
    ):
        if out_state is not None:
            raise ValueError(f"{name}: out_state is written in place and carries "
                             "no gradient; training forwards are stateless")
        return _DeltaChunkFn.apply(q, k, v, g, beta, initial_state, scale, chunk_size,
                                   segment_ids)
    return _launch_chunk(q, k, v, g, beta, initial_state, scale, chunk_size, out_state,
                         segment_ids)


def _launch_chunk(q, k, v, g, beta, initial_state, scale, chunk_size, out_state,
                  segment_ids=None):
    """Check the operands and launch kernel C on CUDA tensors; on CPU
    tensors (bf16 here) compute its twin, `delta_chunk_passes`."""
    name = "delta_rule_chunk_fused"
    if q.device.type == "cpu":
        o, final = delta_chunk_passes(q, k, v, g, beta, initial_state, scale, segment_ids,
                                      chunk_size)
        if out_state is not None:
            final = out_state.copy_(final)
        return o, final
    B, T, H, K = q.shape
    V = v.shape[-1]
    if v.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {v.dtype} not supported (float32, bfloat16)")
    if v.dtype == torch.bfloat16 and V > CHUNK_BF16_MAX_V:
        raise ValueError(f"{name}: the bf16 kernel takes a value dim up to "
                         f"{CHUNK_BF16_MAX_V} (got {V})")
    if K != KERNEL_K or V % CHUNK_BV or chunk_size != CHUNK or T < 1:
        raise ValueError(
            f"{name}: the kernel takes key dim {KERNEL_K}, a value dim that is a "
            f"multiple of {CHUNK_BV} and chunk_size {CHUNK} "
            f"(got K={K}, V={V}, chunk_size={chunk_size}, T={T})"
        )
    shapes = dict(q=(B, T, H, K), k=(B, T, H, K), v=(B, T, H, V), g=(B, T, H),
                  beta=(B, T, H))
    for arg, t in dict(q=q, k=k, v=v, g=g, beta=beta).items():
        if t.device != q.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, q on {q.device}")
        if tuple(t.shape) != shapes[arg]:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected {shapes[arg]}")
    for arg, t in dict(q=q, k=k).items():
        if t.dtype != v.dtype:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, v has {v.dtype}")
    if initial_state is not None:
        if initial_state.device != q.device or initial_state.dtype != torch.float32:
            raise TypeError(f"{name}: the initial state must be float32 on {q.device}")
        if tuple(initial_state.shape) != (B, H, K, V):
            raise ValueError(f"{name}: initial state shape "
                             f"{tuple(initial_state.shape)} is not {(B, H, K, V)}")
        initial_state = initial_state.contiguous()
    if out_state is None:
        final = torch.empty((B, H, K, V), dtype=torch.float32, device=q.device)
    else:
        if (out_state.device != q.device or out_state.dtype != torch.float32
                or not out_state.is_contiguous()):
            raise TypeError(f"{name}: out_state must be contiguous float32 on {q.device}")
        if tuple(out_state.shape) != (B, H, K, V):
            raise ValueError(f"{name}: out_state shape {tuple(out_state.shape)} "
                             f"is not {(B, H, K, V)}")
        final = out_state
    if segment_ids is not None:
        if segment_ids.device != q.device or tuple(segment_ids.shape) != (B, T) \
                or segment_ids.is_floating_point():
            raise ValueError(f"{name}: segment_ids must be integer [{B}, {T}] on {q.device}, "
                             f"got {segment_ids.dtype} {tuple(segment_ids.shape)} on "
                             f"{segment_ids.device}")
        segment_ids = segment_ids.to(torch.int32).contiguous()
    if scale is None:
        scale = K**-0.5
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    gf, bf = g.float().contiguous(), beta.float().contiguous()
    o = torch.empty_like(v)
    n_scratch = chunk_scratch_bytes(B, T, H, V, v.dtype)
    scratch = torch.empty((n_scratch,), dtype=torch.uint8, device=q.device)
    bv = scan_v_tile(B, H, V, sm_count(q.device.index)) if v.dtype == torch.bfloat16 else 0
    lib = _build.load_library()
    with torch.cuda.device(q.device):  # launch on the tensors' card
        _build.check(
            lib.ivl_delta_chunk(
                _DTYPES[v.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                gf.data_ptr(), bf.data_ptr(),
                None if segment_ids is None else segment_ids.data_ptr(),
                None if initial_state is None else initial_state.data_ptr(),
                o.data_ptr(), final.data_ptr(), scratch.data_ptr(), n_scratch,
                B, T, H, K, V, float(scale), bv,
                torch.cuda.current_stream(q.device).cuda_stream,
            ),
            name,
        )
    delta_rule_chunk_fused.launches += 1
    return o, final


delta_rule_chunk_fused.launches = 0


class _DeltaChunkFn(torch.autograd.Function):
    """Kernel C with a gradient. The forward launches the kernel (on a CPU
    tensor, bf16 only: its twin); the backward recomputes the plain fp32
    chunk form (with the same segment ids) under autograd and returns its
    gradients (the JAX package differentiates its plain chunk form too:
    there is no backward kernel on either side yet)."""

    @staticmethod
    def forward(ctx, q, k, v, g, beta, initial_state, scale, chunk_size, segment_ids=None):
        ctx.save_for_backward(q, k, v, g, beta, initial_state, segment_ids)
        ctx.scale, ctx.chunk_size = scale, chunk_size
        ctx.set_materialize_grads(False)  # an unused output's cotangent is None
        return _launch_chunk(q, k, v, g, beta, initial_state, scale, chunk_size, None,
                             segment_ids)

    @staticmethod
    def backward(ctx, d_o, d_final):
        *saved, segment_ids = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(t.is_floating_point())
                      for t in saved]
            o, final = delta_rule_chunk(
                *leaves[:5], leaves[5], ctx.scale, True, ctx.chunk_size,
                segment_ids=segment_ids, compute_dtype=torch.float32,
            )
            wanted = [i for i, t in enumerate(saved)
                      if t is not None and ctx.needs_input_grad[i]]
            pairs = [(y, ct) for y, ct in ((o, d_o), (final, d_final)) if ct is not None]
            outs, cots = [y for y, _ in pairs], [ct for _, ct in pairs]
            grads = torch.autograd.grad(outs, [leaves[i] for i in wanted], cots,
                                        allow_unused=True)
        result = [None] * 9
        for i, gr in zip(wanted, grads):
            result[i] = gr
        return tuple(result)
