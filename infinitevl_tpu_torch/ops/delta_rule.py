"""Gated delta rule: sequential recurrence, single decode step and the
chunkwise (WY/UT) form; torch port of infinitevl_tpu/ops/delta_rule.py.

Per head, with state S in R^{K x V} kept in float32:

    S      = exp(g_t) * S
    v_eff  = beta_t * (v_t - k_t^T S)
    S      = S + outer(k_t, v_eff)
    o_t    = (scale * q_t)^T S

with q, k L2-normalized first and scale = K^-0.5. The chunk form
compresses C tokens at a time (A = beta K K^T .* decay, strictly lower;
(I + A)^{-1} by forward substitution in fp32, by Newton-Schulz in half
precision; w/u pseudo-keys/values; inter-chunk state
carried in fp32). The chunk precompute runs for all chunks at once and a
Python loop threads the state; the JAX `stream` order computes the same
numbers and is not needed here.

`delta_rule_step` is the plain version of the Hopper kernel
`ops/delta_kernels.delta_step_fused_stacked` (B), and `delta_rule_chunk`
with `compute_dtype=torch.float32` that of
`ops/delta_kernels.delta_rule_chunk_fused` (C) on fp32 inputs, which
`gated_delta_rule` dispatches to for T above the recurrent threshold (on
bf16 inputs C computes this module's bf16 precision model; its plain twin
is `ops/delta_kernels.delta_chunk_passes`).

Matmuls follow the JAX precision model: operands in the compute dtype
(the input dtype for bf16/fp16 models, fp32 otherwise) and fp32
accumulation, written here as fp32 matmuls of the rounded operands
(`_mm`)."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .norms import l2norm


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with fp32 accumulation and fp32 result (JAX's
    preferred_element_type=float32 on half-precision operands: products of
    bf16 values are exact in fp32)."""
    return torch.matmul(a.float(), b.float())


def _solve_unit_lower(
    a: torch.Tensor, rhs: torch.Tensor, compute_dtype=torch.float32
) -> torch.Tensor:
    """Solve (I + A) X = rhs for strictly-lower-triangular A [..., C, C].

    In fp32 by forward substitution. With a half-precision compute dtype by
    Newton-Schulz X <- X (2I - L X): E_0 = -A is nilpotent of index <= C,
    so ceil(log2 C) - 1 iterations after the first-order seed are exact;
    the operands are rounded (fp32 accumulation), as the reference Triton
    kernels do."""
    af = a.float()
    if compute_dtype in (torch.float32, torch.float64):
        # fp32: forward substitution, as kernel C solves it. The values are
        # those of the Newton-Schulz product; the gradient is two more
        # triangular solves, where differentiating through the squarings of
        # X overflows fp32 once a chunk's keys are nearly parallel
        return torch.linalg.solve_triangular(
            af, rhs.float(), upper=False, unitriangular=True).to(rhs.dtype)
    C = a.shape[-1]
    eye = torch.eye(C, dtype=torch.float32, device=a.device)
    n_iter = max(int(math.ceil(math.log2(max(C, 2)))) - 1, 0)
    lb = (af + eye).to(compute_dtype)
    x = (eye - af).to(compute_dtype)
    for _ in range(n_iter):
        t = _mm(lb, x)
        x = _mm(x, (2.0 * eye - t).to(compute_dtype)).to(compute_dtype)
    return _mm(x, rhs.to(compute_dtype)).to(rhs.dtype)


def _prep(q, k, v, g, beta, scale, use_qk_l2norm):
    K = q.shape[-1]
    if scale is None:
        scale = K**-0.5
    if use_qk_l2norm:
        q = l2norm(q)
        k = l2norm(k)
    return q.float() * scale, k.float(), v.float(), g.float(), beta.float()


def delta_rule_recurrent(
    q: torch.Tensor,  # [B, T, H, K]
    k: torch.Tensor,
    v: torch.Tensor,  # [B, T, H, V]
    g: torch.Tensor,  # [B, T, H] log-decay (<= 0)
    beta: torch.Tensor,  # [B, T, H]
    initial_state: Optional[torch.Tensor] = None,  # [B, H, K, V] fp32
    scale: Optional[float] = None,
    use_qk_l2norm: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential scan; the ground-truth semantics. Returns
    (o [B, T, H, V] in v.dtype, final_state [B, H, K, V] fp32)."""
    B, T, H, K = q.shape
    V = v.shape[-1]
    qf, kf, vf, gf, bf = _prep(q, k, v, g, beta, scale, use_qk_l2norm)
    if initial_state is None:
        s = torch.zeros((B, H, K, V), dtype=torch.float32, device=q.device)
    else:
        s = initial_state.float()
    outs = []
    for t in range(T):
        s = s * torch.exp(gf[:, t])[..., None, None]
        pred = torch.einsum("bhk,bhkv->bhv", kf[:, t], s)
        verr = (vf[:, t] - pred) * bf[:, t][..., None]
        s = s + kf[:, t][..., :, None] * verr[..., None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", qf[:, t], s))
    o = torch.stack(outs, dim=1)
    return o.to(v.dtype), s


def delta_rule_step(
    q: torch.Tensor,  # [B, H, K]
    k: torch.Tensor,
    v: torch.Tensor,  # [B, H, V]
    g: torch.Tensor,  # [B, H]
    beta: torch.Tensor,  # [B, H]
    state: torch.Tensor,  # [B, H, K, V] fp32
    scale: Optional[float] = None,
    use_qk_l2norm: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token decode step; returns (o [B, H, V] in v.dtype, new
    state). One joint read of the state serves q.S and k.S:
    s' = eg*s + k (x) verr,  o = eg*(q.s) + (q.k)*verr."""
    qf, kf, vf, gf, bf = _prep(q, k, v, g, beta, scale, use_qk_l2norm)
    eg = torch.exp(gf)  # [B, H]
    red = torch.einsum("bhsk,bhkv->bhsv", torch.stack([qf, kf], dim=2), state)
    qh, kh = red[:, :, 0], red[:, :, 1]
    verr = (vf - eg[..., None] * kh) * bf[..., None]
    s = state * eg[..., None, None] + kf[..., :, None] * verr[..., None, :]
    qdotk = (qf * kf).sum(dim=-1)
    o = eg[..., None] * qh + qdotk[..., None] * verr
    return o.to(v.dtype), s


def _wyut_precompute(qf, kf, vf, gf, bf, compute_dtype, seg=None):
    """Per-chunk WY/UT precompute over [..., C, *] (all chunks at once).
    `seg` [..., C] (head axis broadcast) masks interactions across packed
    segments; `gf` then has the segment starts already zeroed. Returns
    (w, u, q_b, attn, k_out, carry)."""
    K = qf.shape[-1]
    C = qf.shape[-2]
    dev = qf.device
    gcs = torch.cumsum(gf, dim=-1)  # [..., C]
    b_end = gcs[..., -1]
    tril = torch.tril(torch.ones((C, C), dtype=torch.bool, device=dev))
    stril = torch.tril(torch.ones((C, C), dtype=torch.bool, device=dev), diagonal=-1)
    diff = gcs[..., :, None] - gcs[..., None, :]
    ratio = torch.where(tril, torch.exp(torch.clamp(diff, max=0.0)), 0.0)
    if seg is not None:
        first, last = seg[..., :1], seg[..., -1:]
        same_as_start = (seg == first)[..., None]
        ratio = torch.where(seg[..., :, None] == seg[..., None, :], ratio, 0.0)
    kk = _mm(kf, kf.transpose(-1, -2))
    a_mat = torch.where(stril, kk * ratio, 0.0) * bf[..., :, None]
    kb = kf.float() * torch.exp(gcs)[..., None]
    if seg is not None:
        # the decay from the chunk start holds within its first segment only
        kb = torch.where(same_as_start, kb, 0.0)
    rhs = (torch.cat([kb, vf.float()], dim=-1) * bf[..., None]).to(compute_dtype)
    x = _solve_unit_lower(a_mat, rhs, compute_dtype)
    w, u = x[..., :K], x[..., K:]
    qk = _mm(qf, kf.transpose(-1, -2))
    attn = torch.where(tril, qk * ratio, 0.0).to(compute_dtype)
    q_b = qf.float() * torch.exp(gcs)[..., None]
    if seg is not None:
        q_b = torch.where(same_as_start, q_b, 0.0)
    q_b = q_b.to(compute_dtype)
    k_out = kf.float() * torch.exp(b_end[..., None] - gcs)[..., None]
    carry = torch.exp(b_end)
    if seg is not None:
        # only the chunk's last segment carries state into the next chunk; a
        # boundary inside the chunk kills the incoming state's carry
        k_out = torch.where((seg == last)[..., None], k_out, 0.0)
        carry = torch.where((first == last)[..., 0], carry, 0.0)
    return w, u, q_b, attn, k_out.to(compute_dtype), carry


def delta_rule_chunk(
    q: torch.Tensor,  # [B, T, H, K]
    k: torch.Tensor,
    v: torch.Tensor,  # [B, T, H, V]
    g: torch.Tensor,  # [B, T, H]
    beta: torch.Tensor,  # [B, T, H]
    initial_state: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    use_qk_l2norm: bool = True,
    chunk_size: int = 64,
    segment_ids: Optional[torch.Tensor] = None,
    compute_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunkwise-parallel gated delta rule (prefill path). Returns
    (o [B, T, H, V] in v.dtype, final_state [B, H, K, V] fp32).

    `compute_dtype` None follows the JAX precision model (operands in the
    input dtype for bf16/fp16 inputs, fp32 otherwise). torch.float32 widens
    the inputs first and keeps every intermediate in fp32, whatever the
    input dtype: the arithmetic of the fused kernel C.

    `segment_ids` [B, T] marks independent sequences packed along T: the
    state is reset at segment boundaries by zeroing the decay carried over
    and masking interactions across segments. `initial_state` then seeds
    the first segment only."""
    B, T, H, K = q.shape
    V = v.shape[-1]
    C = chunk_size
    out_dtype = v.dtype
    if compute_dtype is None:
        cd = v.dtype if v.dtype in (torch.bfloat16, torch.float16) else torch.float32
    elif compute_dtype == torch.float32:
        cd = torch.float32
        q, k, v = q.float(), k.float(), v.float()
    else:
        raise ValueError(f"compute_dtype {compute_dtype} (None or torch.float32)")
    if scale is None:
        scale = K**-0.5
    if use_qk_l2norm:
        q = l2norm(q)
        k = l2norm(k)
    is_start = None
    if segment_ids is not None:
        # token t starts a packed sequence iff its id differs from token t-1's
        is_start = torch.cat(
            [torch.zeros((B, 1), dtype=torch.bool, device=q.device),
             segment_ids[:, 1:] != segment_ids[:, :-1]], dim=1)
    pad = (-T) % C
    if pad:
        # zero-padded tail tokens have beta = 0 and g = 0: inert
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        g = torch.nn.functional.pad(g, (0, 0, 0, pad))
        beta = torch.nn.functional.pad(beta, (0, 0, 0, pad))
        if segment_ids is not None:
            # pad tokens continue the last segment
            segment_ids = torch.cat(
                [segment_ids, segment_ids[:, -1:].expand(B, pad)], dim=1)
            is_start = torch.nn.functional.pad(is_start, (0, pad))
    Tp = T + pad
    N = Tp // C

    def chunked(x):  # [B, Tp, H, *] -> [B, H, N, C, *]
        x = x.reshape(B, N, C, H, *x.shape[3:])
        return x.movedim(3, 1)

    qf = (chunked(q).float() * scale).to(cd)
    kf = chunked(k).to(cd)
    vf = chunked(v).to(cd)
    gf = chunked(g).float()
    bf = chunked(beta).float()
    seg = edge_start = None
    if segment_ids is not None:
        seg = segment_ids.reshape(B, 1, N, C)
        # the decay resets at a segment's first token
        gf = torch.where(is_start.reshape(B, 1, N, C), 0.0, gf)
        # a boundary exactly at a chunk edge is invisible to the masks within
        # the chunk: the incoming state is severed per chunk [B, N]
        edge_start = is_start.reshape(B, N, C)[:, :, 0].float()
    w, u, q_b, attn, k_out, carry = _wyut_precompute(qf, kf, vf, gf, bf, cd, seg)
    # the per-chunk operands hold cd-rounded values: widening them to fp32
    # once keeps _mm's numbers and takes the casts out of the chunk loop
    w, u, q_b, attn, k_out = (x.float() for x in (w, u, q_b, attn, k_out))

    if initial_state is None:
        s = torch.zeros((B, H, K, V), dtype=torch.float32, device=q.device)
    else:
        s = initial_state.float()
    outs = []
    for n in range(N):
        if edge_start is not None:
            s = s * (1.0 - edge_start[:, n])[:, None, None, None]
        sc = s.to(cd).float()  # half-precision state READ; the accumulator stays fp32
        y = (u[:, :, n] - w[:, :, n] @ sc).to(cd).float()
        outs.append(q_b[:, :, n] @ sc + attn[:, :, n] @ y)
        s = s * carry[:, :, n][..., None, None] + k_out[:, :, n].transpose(-1, -2) @ y
    o = torch.stack(outs, dim=2).reshape(B, H, Tp, V)[:, :, :T]
    return o.transpose(1, 2).to(out_dtype), s


def gated_delta_rule(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    g: torch.Tensor,
    beta: torch.Tensor,
    initial_state: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    use_qk_l2norm: bool = True,
    chunk_size: int = 64,
    recurrent_threshold: int = 64,
    segment_ids: Optional[torch.Tensor] = None,
    out_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch: the recurrence for T <= recurrent_threshold (the
    reference's q_len <= 64 switch), else the chunk form through the fused
    kernel's wrapper. The kernel normalizes q and k itself, as its Pallas
    original does, so without the l2norm a CUDA tensor raises; CPU tensors
    take the plain chunk form. The final state is written into `out_state`
    where one is given (it may be `initial_state` itself).

    `segment_ids` (packed sequences) exist in the chunk form only, as in
    the JAX package; they go through kernel C's packed path on a CUDA
    tensor and its plain version on a CPU tensor. Ids that only mark
    padding after one sequence per row never come here (the training
    losses keep them from this rule: train/step._layer_segments)."""
    if segment_ids is not None and q.shape[1] <= recurrent_threshold:
        raise ValueError("segment_ids only supported in chunk mode")
    if q.shape[1] <= recurrent_threshold:
        o, s = delta_rule_recurrent(
            q, k, v, g, beta, initial_state, scale, use_qk_l2norm
        )
    elif use_qk_l2norm:
        from .delta_kernels import delta_rule_chunk_fused  # imports this module

        return delta_rule_chunk_fused(
            q, k, v, g, beta, initial_state, scale, chunk_size, out_state, segment_ids
        )
    elif q.device.type == "cpu":
        o, s = delta_rule_chunk(
            q, k, v, g, beta, initial_state, scale, False, chunk_size, segment_ids
        )
    else:
        raise NotImplementedError(
            "gated_delta_rule: the chunk kernel l2-normalizes q and k inside; "
            f"use_qk_l2norm=False is not available for tensors on {q.device}"
        )
    if out_state is not None:
        s = out_state.copy_(s)
    return o, s
