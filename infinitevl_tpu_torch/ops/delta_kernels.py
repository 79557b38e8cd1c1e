"""Wrappers of the Gated-DeltaNet kernels, under the names of their Pallas
counterparts in infinitevl_tpu/ops/delta_pallas.py: the decode step (B,
csrc/delta_step.cu) and the chunkwise prefill (C, csrc/delta_chunk.cu).

A tensor on the CPU takes the plain version (ops/delta_rule.delta_rule_step,
ops/delta_rule.delta_rule_chunk in fp32); a CUDA tensor launches the kernel
or raises. Each wrapper counts its launches in its `launches` attribute."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .delta_rule import delta_rule_chunk, delta_rule_step
from .norms import l2norm

KERNEL_K = 128  # the key head dim the kernels are written for
CHUNK = 64  # chunk length of kernel C
CHUNK_BV = 64  # value columns per block of kernel C's sequential pass

_DTYPES = {torch.float32: _build.DTYPE_F32, torch.bfloat16: _build.DTYPE_BF16}


def delta_step_fused_stacked(
    q: torch.Tensor,  # [B, H, K] post-conv raw projections (pre-l2norm)
    k: torch.Tensor,
    v: torch.Tensor,  # [B, H, V]
    g: torch.Tensor,  # [B, H] log-decay
    beta: torch.Tensor,  # [B, H]
    stacked_h: torch.Tensor,  # [L, B, H, K, V] fp32, updated in place
    layer: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One decode step of DeltaNet layer `layer`: updates stacked_h[layer]
    IN PLACE (other layers untouched) and returns o [B, H, V] in v.dtype.
    Semantics of delta_rule_step, qk l2norm included."""
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
    if K != KERNEL_K:
        raise ValueError(f"{name}: key head dim {K}, the kernel takes {KERNEL_K}")
    if not 0 <= layer < L:
        raise IndexError(f"{name}: layer {layer} outside the stack of {L}")
    shapes = dict(q=(B, H, K), k=(B, H, K), v=(B, H, V), g=(B, H), beta=(B, H))
    for arg, t in dict(q=q, k=k, v=v, g=g, beta=beta).items():
        if t.device != stacked_h.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, state on {stacked_h.device}")
        if tuple(t.shape) != shapes[arg]:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected {shapes[arg]}")
    if scale is None:
        scale = K**-0.5
    # l2norm, scale, exp(g) and beta stay in torch, as in the JAX wrapper
    qf = (l2norm(q).float() * scale).contiguous()
    kf = l2norm(k).float().contiguous()
    vf = v.float().contiguous()
    eg = torch.exp(g.float()).contiguous()
    bf = beta.float().contiguous()
    o = torch.empty((B, H, V), dtype=torch.float32, device=q.device)
    lib = _build.load_library()
    with torch.cuda.device(q.device):  # launch on the tensors' card
        _build.check(
            lib.ivl_delta_step(
                qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), eg.data_ptr(),
                bf.data_ptr(), stacked_h.data_ptr(), o.data_ptr(),
                B, H, K, V, int(layer),
                torch.cuda.current_stream(q.device).cuda_stream,
            ),
            name,
        )
    delta_step_fused_stacked.launches += 1
    return o.to(v.dtype)


delta_step_fused_stacked.launches = 0


def chunk_scratch_floats(B: int, T: int, H: int, V: int) -> int:
    """fp32 scratch of kernel C: per (b, h, chunk) the transposed w and
    q e^g, k e^{g_C - g}, the masked q k^T, u, e^{g_C} and the flag of a
    segment starting at the chunk's edge (csrc/delta_chunk.cu)."""
    n_chunks = -(-T // CHUNK)
    return B * H * n_chunks * (3 * KERNEL_K * CHUNK + CHUNK * CHUNK + CHUNK * V + 2)


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
    inside, all arithmetic in fp32. Returns (o [B, T, H, V] in v.dtype,
    final_state [B, H, K, V] fp32). The final state is written into
    `out_state` where one is given (it may be `initial_state` itself: a
    layer's slab of the stacked state is then updated where it lies), else
    into a new tensor. `segment_ids` mark sequences packed along T: the
    state restarts at each segment's first token and `initial_state` seeds
    the first segment only. Semantics of
    delta_rule_chunk(..., segment_ids=..., compute_dtype=torch.float32)."""
    name = "delta_rule_chunk_fused"
    if q.device.type == "cpu":
        o, final = delta_rule_chunk(
            q, k, v, g, beta, initial_state, scale, True, chunk_size,
            segment_ids=segment_ids, compute_dtype=torch.float32,
        )
        if out_state is not None:
            final = out_state.copy_(final)
        return o, final
    if q.device.type != "cuda":
        raise ValueError(f"{name}: device {q.device} is neither cpu nor cuda")
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
    """Check the operands and launch kernel C (CUDA tensors only)."""
    name = "delta_rule_chunk_fused"
    B, T, H, K = q.shape
    V = v.shape[-1]
    if v.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {v.dtype} not supported (float32, bfloat16)")
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
    n_scratch = chunk_scratch_floats(B, T, H, V)
    scratch = torch.empty((n_scratch,), dtype=torch.float32, device=q.device)
    lib = _build.load_library()
    with torch.cuda.device(q.device):  # launch on the tensors' card
        _build.check(
            lib.ivl_delta_chunk(
                _DTYPES[v.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                gf.data_ptr(), bf.data_ptr(),
                None if segment_ids is None else segment_ids.data_ptr(),
                None if initial_state is None else initial_state.data_ptr(),
                o.data_ptr(), final.data_ptr(), scratch.data_ptr(), n_scratch,
                B, T, H, K, V, float(scale),
                torch.cuda.current_stream(q.device).cuda_stream,
            ),
            name,
        )
    delta_rule_chunk_fused.launches += 1
    return o, final


delta_rule_chunk_fused.launches = 0


class _DeltaChunkFn(torch.autograd.Function):
    """Kernel C with a gradient. The forward launches the kernel; the
    backward recomputes the plain fp32 chunk form (with the same segment
    ids) under autograd and returns its gradients (the JAX package
    differentiates its plain chunk form too: there is no backward kernel on
    either side yet)."""

    @staticmethod
    def forward(ctx, q, k, v, g, beta, initial_state, scale, chunk_size, segment_ids=None):
        ctx.save_for_backward(q, k, v, g, beta, initial_state, segment_ids)
        ctx.scale, ctx.chunk_size = scale, chunk_size
        ctx.set_materialize_grads(False)  # an unused output's cotangent is None
        o, final = _launch_chunk(q, k, v, g, beta, initial_state, scale, chunk_size, None,
                                 segment_ids)
        return o, final

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
