"""Mamba2 SSD (state-space duality) scan: the token recurrence, one decode
step and the chunkwise dual form; torch port of
infinitevl_tpu/ops/mamba2.py.

The reference's second conversion mixer computes, per head with state
h in R^{N x P} kept in float32:

    a_t = exp(A * dt_t)                      (A < 0, one scalar a head)
    h_t = a_t * h_{t-1} + dt_t * B_t x_t^T   (an outer-product update)
    y_t = C_t^T h_t

It is the gated-linear-attention family (a DeltaNet without the delta
correction), so the chunk form is the same dual form as ops/delta_rule.py:
inside a chunk the causal interaction is one [C, C] product, across chunks
the state hops. Here every chunk's own work (scores, decays, the intra-chunk
output, the state each chunk injects) runs for all chunks at once and a
Python loop threads only the state, one fused multiply-add a chunk; the
carried-in state's output is again one product over all chunks.

The JAX package runs these through XLA (no Pallas kernel), and so does the
port: plain torch on the CPU and on the card alike."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def mamba2_recurrent(
    x: torch.Tensor,  # [B, T, H, P] values
    dt: torch.Tensor,  # [B, T, H] (softplus'd)
    A: torch.Tensor,  # [H] negative decay rates
    B_: torch.Tensor,  # [B, T, H, N]
    C_: torch.Tensor,  # [B, T, H, N]
    initial_state: Optional[torch.Tensor] = None,  # [B, H, N, P]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-by-token recurrence in fp32, the chunk form's reference.
    Returns (y [B, T, H, P] in x's dtype, final state [B, H, N, P] fp32)."""
    Bsz, T, H, P = x.shape
    N = B_.shape[-1]
    h = (initial_state.float() if initial_state is not None
         else x.new_zeros((Bsz, H, N, P), dtype=torch.float32))
    ys = []
    for t in range(T):
        y, h = mamba2_step(x[:, t].float(), dt[:, t], A, B_[:, t], C_[:, t], h)
        ys.append(y)
    return torch.stack(ys, dim=1).to(x.dtype), h


def mamba2_step(
    x: torch.Tensor,  # [B, H, P]
    dt: torch.Tensor,  # [B, H] (softplus'd)
    A: torch.Tensor,  # [H]
    B_: torch.Tensor,  # [B, H, N]
    C_: torch.Tensor,  # [B, H, N]
    h: torch.Tensor,  # [B, H, N, P] fp32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step: (y [B, H, P] in x's dtype, new state fp32). The
    state passed in is not modified."""
    dtf = dt.float()
    a = torch.exp(A.float()[None] * dtf)  # [B, H]
    upd = (dtf[..., None] * B_.float())[..., None] * x.float()[..., None, :]
    h = a[..., None, None] * h + upd
    y = torch.einsum("bhn,bhnp->bhp", C_.float(), h)
    return y.to(x.dtype), h


def _chunks(t: torch.Tensor, K: int, C: int) -> torch.Tensor:
    """[B, K*C, H, ...] -> [B, K, H, C, ...] in fp32."""
    t = t.reshape(t.shape[0], K, C, *t.shape[2:]).float()
    return t.movedim(2, 3)


def mamba2_chunk_scan(
    x: torch.Tensor,  # [B, T, H, P]
    dt: torch.Tensor,  # [B, T, H] (softplus'd, >= 0)
    A: torch.Tensor,  # [H] negative
    B_: torch.Tensor,  # [B, T, H, N]
    C_: torch.Tensor,  # [B, T, H, N]
    initial_state: Optional[torch.Tensor] = None,  # [B, H, N, P]
    chunk_size: int = 128,
    segment_ids: Optional[torch.Tensor] = None,  # [B, T]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunkwise-dual SSD in fp32. Returns (y [B, T, H, P] in x's dtype,
    final state [B, H, N, P] fp32).

    T is padded to a chunk multiple with dt = 0 (decay exp(0) = 1, no
    injection). Packed rows (`segment_ids`, as in ops/delta_rule.py): pairs
    across segments are masked inside a chunk, a segment that starts inside
    a chunk or on its edge kills the carried state, and only the chunk's
    last segment injects state into the next; `initial_state` seeds the
    first segment only. The log-decay between two positions is clipped to
    [-60, 0], as in JAX."""
    Bsz, T, H, P = x.shape
    N = B_.shape[-1]
    Cn = chunk_size
    pad = (-T) % Cn
    if pad:
        x, dt, B_, C_ = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, dt, B_, C_))
        if segment_ids is not None:
            segment_ids = torch.cat(
                [segment_ids, segment_ids[:, -1:].expand(Bsz, pad)], dim=1)
    K = (T + pad) // Cn
    xc, bc, cc = _chunks(x, K, Cn), _chunks(B_, K, Cn), _chunks(C_, K, Cn)  # [B, K, H, C, *]
    dtc = _chunks(dt, K, Cn)  # [B, K, H, C]
    if segment_ids is not None:
        sc = segment_ids.reshape(Bsz, K, Cn)
    else:
        sc = torch.zeros((Bsz, K, Cn), dtype=torch.int32, device=x.device)

    # cumulative log-decay inside each chunk, inclusive of t
    L = torch.cumsum(A.float()[:, None] * dtc, dim=-1)  # [B, K, H, C]
    # intra-chunk: y_t = sum_{s <= t} (C_t . B_s) exp(L_t - L_s) dt_s x_s
    causal = torch.ones((Cn, Cn), dtype=torch.bool, device=x.device).tril()
    same = (sc[..., :, None] == sc[..., None, :]) & causal  # [B, K, C, C]
    decay = torch.exp(torch.clamp(L[..., :, None] - L[..., None, :], -60.0, 0.0))
    M = torch.einsum("bkhtn,bkhsn->bkhts", cc, bc) * decay * dtc[..., None, :]
    y = torch.einsum("bkhts,bkhsp->bkhtp", M * same[:, :, None], xc)

    # the carried state reaches only the tokens of the chunk's first
    # segment, and only if that segment continues the previous chunk
    prev_last = torch.cat([sc[:, :1, 0], sc[:, :-1, -1]], dim=1)  # [B, K]
    cont = (sc[..., 0] == prev_last).float()
    no_bound = torch.cumprod((sc == sc[..., :1]).float(), dim=-1)  # [B, K, C]
    # state out: the decayed carry survives a boundary-free continuing
    # chunk; injections come from the chunk's final segment only
    Lc = L[..., -1]  # [B, K, H]
    hop = torch.exp(Lc) * (no_bound[..., -1] * cont)[..., None]  # [B, K, H]
    w = torch.exp(torch.clamp(Lc[..., None] - L, -60.0, 0.0)) * dtc
    w = w * (sc == sc[..., -1:]).float()[:, :, None]
    inj = torch.einsum("bkhcn,bkhcp->bkhnp", bc * w[..., None], xc)  # [B, K, H, N, P]

    h = (initial_state.float() if initial_state is not None
         else x.new_zeros((Bsz, H, N, P), dtype=torch.float32))
    h_in = []
    for k in range(K):
        h_in.append(h)
        h = torch.addcmul(inj[:, k], hop[:, k, :, None, None], h)
    h_in = torch.stack(h_in, dim=1)  # [B, K, H, N, P]: the state entering each chunk
    gate = torch.exp(L) * (no_bound * cont[..., None])[:, :, None]  # [B, K, H, C]
    y = y + torch.einsum("bkhtn,bkhnp->bkhtp", cc * gate[..., None], h_in)
    y = y.movedim(3, 2).reshape(Bsz, K * Cn, H, P)[:, :T]
    return y.to(x.dtype), h
