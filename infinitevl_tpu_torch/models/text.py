"""Hybrid SWA / Gated-DeltaNet text decoder (torch port of
infinitevl_tpu/models/text.py: the serving paths and the stateless
training forward).

Parameters are the JAX layout (models/params.py); the layer loop is a
Python loop. With a state, every layer updates its part of the stacked
state IN PLACE: T == 1 goes through the decode kernels (A2 for SWA
layers, B for DeltaNet layers), T > 1 through the prefill kernel A1 plus a
plain ring write for SWA layers and, for DeltaNet layers, the chunked
delta rule kernel C (T above cfg.recurrent_threshold; the plain recurrence
below it). A CUDA tensor always reaches the kernel, which raises on what it
cannot take; a CPU tensor takes the kernel's plain version. Mamba2 layers
(the mamba2 conversion's students, models/convert.py) run plain torch on
every device (`mamba2_forward`, ops/mamba2.py), as XLA runs them in JAX.

Without a state the forward is stateless and differentiable (training):
SWA layers go through kernel H (forward and backward), DeltaNet layers
through kernel C with its autograd wrapper, `segment_ids` mask packed
sequences (with `tail_pads_only`, ids that only mark padding after one
sequence per row stay away from the DeltaNet rule), dense nodes may carry LoRA side paths (`lora_a` / `lora_b`,
train/lora.attach_lora), and `remat` checkpoints each layer (or group of
layers) so its internals are recomputed in the backward. Nothing is
updated in place on that path.

Above `cfg.delta_seq_chunk_t` positions (0 turns this off) a stateless
layer runs in SEQUENCE chunks, each a checkpoint of its own, so that no
full-length intermediate of the layer exists in its backward: SWA layers
in chunks of one window with the previous chunk's post-RoPE K/V carried
(kernel H over the 2W keys), DeltaNet layers in chunks of
min(delta_seq_chunk_t, delta_seq_chunk_eval) with the fp32 state and the
conv tails carried (kernel C from the carried state), the MLP in chunks of
`cfg.mlp_chunk_t`. The chunked forms are exact: they compute the full-T
layer's numbers up to summation order. Under `remat` the layer's
checkpoint wraps its chunks' own, so a chunk's forward runs three times a
step and only the layer boundaries stay alive (PERF.md §6: dropping the
outer checkpoint at 32K saved no time and held more memory).
`decoder_layer_chunk_forward` threads the same carries across calls.

Under FSDP (parallel/sharding.py) `text_forward` gathers the tree's
top-level leaves once and each layer inside its checkpointed unit; with
no shard in the process the gathers return their argument.

Under tensor parallelism (the model axis of parallel/sharding.py) a layer
runs on this rank's slices of its kernels, with its collectives written
into the forward: q/k/v (and the DeltaNet's a/b/g, the MLP's gate/up) are
column-parallel behind one `tp_copy` of the normed input, o_proj and down
row-parallel, their partial outputs summed by `tp_sum` inside `_dense`
(the LoRA side path added before the sum, the replicated bias after it).
Head counts come from the local leaves' widths: the rank computes the
query heads whose o_proj rows it holds; where the k/v projections' split
cuts a KV head (2 KV heads over 4 ranks) their outputs are gathered whole
and the KV heads those queries read are kept (`kv_head_range`); the
DeltaNet's per-head gated norm reads its replicated weight through
`tp_copy`. A Mamba2 layer runs the rank's heads: its q / k / v / g columns,
its channels of the whole conv (three blocks of [v | k | q]) and its heads
of the whole dt_proj and D, each whole leaf read through `tp_copy`
(`_mamba2_entry`). The embedding, sharded on D, is gathered after the
lookup; the head computes partial logits from the rank's D slice and sums
them. The cached forward runs on the rank's part of the state (its KV
heads' rings, its DeltaNet heads' states and conv channels, its Mamba2
heads' states and conv channels)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import FULL, LINEAR, MAMBA2, SLIDING, TextConfig
from ..ops.delta_kernels import delta_rule_chunk_fused, delta_step_fused_stacked
from ..ops.delta_rule import gated_delta_rule
from ..ops.int4_kernels import int4_matmul_fused
from ..ops.mamba2 import mamba2_chunk_scan, mamba2_step
from ..ops.norms import rms_norm, rms_norm_gated, silu
from ..ops.rope import apply_rotary, mrope_cos_sin
from ..ops.short_conv import causal_conv1d, short_conv, short_conv_step
from ..ops.swa import ring_write_stacked, swa_prefill_dense
from ..ops.swa_kernels import (
    swa_ring_flash_attention,
    swa_ring_flash_decode_stacked,
)
from ..parallel.sharding import (
    gather_top,
    gather_tree,
    kv_head_range,
    tp_copy,
    tp_gather,
    tp_info,
    tp_sum,
)
from .state import DecoderState

Params = Dict[str, Any]

# parameter layouts of the JAX package that are not ported yet
_LATER = {
    "kernel_q4b": "biased int4 storage (no entry point produces it)",
}


def _not_ported(p: Params) -> None:
    for key, what in _LATER.items():
        if key in p:
            raise NotImplementedError(
                f"parameter layout {key!r} ({what}) is not ported to torch yet"
            )


def _kernel(p) -> Optional[torch.Tensor]:
    """A dense node's kernel (bf16 / fp32, or the int8 `kernel_q`)."""
    return p.get("kernel", p.get("kernel_q")) if isinstance(p, dict) else None


def _tp(p) -> Optional[Any]:
    """The model-axis layout (parallel/sharding.ShardInfo) of a dense node's
    kernel; None where it is whole."""
    return tp_info(_kernel(p))


def dora_column_norms(kernel: torch.Tensor, a: torch.Tensor, b_scaled: torch.Tensor,
                      row_sum=None) -> torch.Tensor:
    """DoRA's column L2 norms of W + a @ b_scaled (train/lora.py) in fp32
    without forming the [d_in, d_out] product: ||W_j||^2 + 2 (W^T a b)_jj +
    (b^T a^T a b)_jj, two [*, r] products a weight. Differentiable in a, b.
    Each term is a sum
    over W's rows: `row_sum` (tensor parallelism's `tp_sum`) adds the
    squares of a slice of the rows (W's and a's) over the ranks holding the
    others before the root."""
    w, af, bf = kernel.float(), a.float(), b_scaled.float()
    t1 = (w * w).sum(dim=0)  # [d_out]
    t2 = ((w.T @ af) * bf.T).sum(dim=1)
    t3 = ((af.T @ af @ bf) * bf).sum(dim=0)
    sq = t1 + 2.0 * t2 + t3
    return torch.sqrt(torch.clamp(sq if row_sum is None else row_sum(sq), min=1e-12))


def _dense(x: torch.Tensor, p: Params) -> torch.Tensor:
    """x @ kernel (+ bias); kernel is [d_in, d_out], stored in the weights'
    dtype, as weight-only int8 (`kernel_q` + `scale`: plain torch, the
    column scale commutes with the contraction) or as nibble-packed int4
    (`kernel_q4` / `kernel_q4f` + `scale4`: kernel G on a CUDA tensor).
    `lora_a` [d_in, r] and `lora_b` [r, d_out] (pre-scaled) add the low-rank
    side path (x @ a) @ b to the frozen kernel's output, so gradients and
    intermediates stay rank-r sized. `dora_m` [d_out] (DoRA,
    train/lora.attach_lora) rescales the columns before the bias:
    y = x @ (m * (W + a b) / ||W + a b||_col) without forming the weight,
    the norms taken here from the kernel as the layer holds it.

    A model-axis slice of the kernel (tensor parallelism): column-parallel
    (its output columns), x whole and y this rank's columns; row-parallel
    (its input rows), x this rank's features and y summed over the model
    group (`tp_sum`) before the replicated bias. The replicated LoRA
    factors are cut to the kernel's slice and read through `tp_copy`, so
    their gradients are summed over the group. DoRA on a column-parallel
    slice: its columns are whole, so their norms are local (m read through
    `tp_copy`, cut to them); on a row-parallel slice the squared partial
    norms are summed over the group (`tp_sum`) and the scale multiplies
    the summed output."""
    _not_ported(p)
    tp = _tp(p)
    if "kernel_q" in p:
        y = (x @ p["kernel_q"].to(x.dtype)) * p["scale"].to(x.dtype)
    elif "kernel_q4" in p or "kernel_q4f" in p:
        y = int4_matmul_fused(x, p)
    else:
        y = x @ p["kernel"]
    scale = None
    if "lora_a" in p:
        a, b = p["lora_a"], p["lora_b"]
        if tp is not None:  # the factor beside the kernel's sliced dim, cut to its slice
            a, b = tp_copy(a), tp_copy(b)
            if tp.dim == 1:
                b = b.narrow(1, tp.rank * y.shape[-1], y.shape[-1])
            else:
                a = a.narrow(0, tp.rank * x.shape[-1], x.shape[-1])
        y = y + ((x @ a.to(x.dtype)) @ b.to(x.dtype)).to(y.dtype)
        if "dora_m" in p:
            m = p["dora_m"].float()
            if tp is not None and tp.dim == 1:
                m = tp_copy(m).narrow(0, tp.rank * y.shape[-1], y.shape[-1])
            scale = m / dora_column_norms(p["kernel"], a, b, row_sum=(
                tp_sum if tp is not None and tp.dim == 0 else None))
    if scale is not None and (tp is None or tp.dim == 1):
        y = y * scale.to(y.dtype)
    if tp is not None and tp.dim == 0:
        y = tp_sum(y)
        if scale is not None:
            y = y * scale.to(y.dtype)
    if "bias" in p:
        y = y + p["bias"]
    return y


def mlp_forward(p: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP; takes the fused `gate_up` layout of models/fuse.py."""
    if "gate_up" in p:
        gu = _dense(x, p["gate_up"])
        inter = gu.shape[-1] // 2
        return _dense(silu(gu[..., :inter]) * gu[..., inter:], p["down"])
    if _tp(p["gate"]) is not None:
        x = tp_copy(x)
    return _dense(silu(_dense(x, p["gate"])) * _dense(x, p["up"]), p["down"])


def _tp_heads(y: torch.Tensor, node: Params, h0: int, h1: int, d: int) -> torch.Tensor:
    """Heads [h0, h1) of a column-parallel projection's output `y` (this
    rank's columns): `y` itself where its columns are those heads, else
    the model group's columns gathered whole and the heads cut out (the
    split cuts a head; the gather's backward sums the ranks' parts)."""
    info = _tp(node)
    if info is None:
        raise NotImplementedError(
            "tensor parallelism with a k/v projection the rules leave whole beside a sharded "
            "q projection is not ported to torch")
    n = y.shape[-1]
    if info.rank * n == h0 * d and n == (h1 - h0) * d:
        return y
    return tp_gather(y, summed=True)[..., h0 * d : h1 * d]


def _swa_qkv(p: Params, cfg: TextConfig, x: torch.Tensor):
    """q [B, T, hq, Dh], k and v [B, T, hkv, Dh] of the unfused layout,
    after the projections: every head, or under tensor parallelism the
    rank's query heads and the KV heads they read."""
    B, T, _ = x.shape
    Dh = cfg.head_dim
    tp = _tp(p["q_proj"])
    if tp is not None:
        x = tp_copy(x)
    q, k, v = (_dense(x, p[n]) for n in ("q_proj", "k_proj", "v_proj"))
    if tp is not None:
        kv0, kv1 = kv_head_range(cfg.num_attention_heads, cfg.num_key_value_heads,
                                 tp.world, tp.rank)
        k, v = (_tp_heads(t, p[n], kv0, kv1, Dh) for t, n in ((k, "k_proj"), (v, "v_proj")))
    return (q.reshape(B, T, -1, Dh), k.reshape(B, T, -1, Dh), v.reshape(B, T, -1, Dh))


def _swa_heads(p: Params, cfg: TextConfig) -> Tuple[int, int]:
    """(query heads, KV heads) this rank computes in an SWA layer."""
    tp = _tp(p.get("q_proj"))
    if tp is None:
        return cfg.num_attention_heads, cfg.num_key_value_heads
    kv0, kv1 = kv_head_range(cfg.num_attention_heads, cfg.num_key_value_heads, tp.world,
                             tp.rank)
    return cfg.num_attention_heads // tp.world, kv1 - kv0


def _delta_entry(p: Params, x: torch.Tensor):
    """(x, o_norm weight) of a DeltaNet layer's unfused layout: under tensor
    parallelism the input through `tp_copy` and the replicated per-head
    norm's weight read through it too (each rank normalises its heads)."""
    tp = _tp(p["q_proj"])
    if tp is None:
        return x, p["o_norm"]
    if _tp(p["a_proj"]) is None:  # H does not divide over the model axis
        raise NotImplementedError(
            f"tensor parallelism over {tp.world} ranks with {p['A_log'].shape[0]} "
            "DeltaNet heads (a split that cuts a head) is not ported to torch")
    return tp_copy(x), tp_copy(p["o_norm"])


def _maybe_checkpoint(fn, *args):
    """fn(*args), as a non-reentrant checkpoint when autograd records."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def mlp_forward_chunked(p: Params, x: torch.Tensor, chunk_t: int) -> torch.Tensor:
    """The MLP over sequence chunks of `chunk_t` positions, each a
    checkpoint: the SwiGLU backward's three [T, intermediate] temporaries
    exist for one chunk at a time. Pointwise over T, so exact."""
    T = x.shape[1]
    return torch.cat([_maybe_checkpoint(mlp_forward, p, x[:, t0 : t0 + chunk_t])
                      for t0 in range(0, T, chunk_t)], dim=1)


def seq_chunked(cfg: TextConfig, T: int) -> bool:
    """Whether a stateless forward of T positions runs its DeltaNet layers
    (and, at T >= 2 windows, its SWA layers) sequence-chunked."""
    return bool(cfg.delta_seq_chunk_t) and T > cfg.delta_seq_chunk_t


def swa_attention_forward(
    p: Params,
    cfg: TextConfig,
    x: torch.Tensor,  # [B, T, D]
    cos: torch.Tensor,  # [B, T, head_dim]
    sin: torch.Tensor,
    rings_k: Optional[torch.Tensor],  # [S, B, Hkv, cap, Dh] stacked rings or None
    rings_v: Optional[torch.Tensor],
    cum_len: Optional[int],
    layer_idx: int = 0,
    window: Optional[int] = None,
    segment_ids: Optional[torch.Tensor] = None,  # [B, T]; stateless forward only
) -> torch.Tensor:
    """GQA with qkv bias, mRoPE and the sliding-window mask, no o_proj bias.
    With rings, layer `layer_idx` of the stacked rings is updated IN PLACE
    with the new tokens' K/V. Returns [B, T, D]."""
    B, T, _ = x.shape
    window = window if window is not None else cfg.sliding_window
    if rings_k is None and "q_proj" in p and T >= 2 * window and seq_chunked(cfg, T):
        # long stateless forward: the layer in window-sized sequence chunks
        # (swa_forward_seq_chunked), gated by the DeltaNet layers' threshold
        return swa_forward_seq_chunked(p, cfg, x, cos, sin, segment_ids, window)
    if "qkv_proj" in p:  # fused layout (models/fuse.py): one matmul
        Hq, Hkv, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        qkv = _dense(x, p["qkv_proj"])
        nq, nk = Hq * Dh, Hkv * Dh
        q = qkv[..., :nq].reshape(B, T, Hq, Dh)
        k = qkv[..., nq : nq + nk].reshape(B, T, Hkv, Dh)
        # q and k come out of the rotation dense; v stays a strided column
        # slice, and the attention kernels read dense rows
        v = qkv[..., nq + nk :].reshape(B, T, Hkv, Dh).contiguous()
    else:
        q, k, v = _swa_qkv(p, cfg, x)
        if _tp(p["q_proj"]) is not None:  # rope's tables, read per head
            cos, sin = tp_copy(cos), tp_copy(sin)
    q, k = apply_rotary(q, k, cos, sin)
    if rings_k is None:
        out = swa_prefill_dense(q, k, v, window, segment_ids=segment_ids)
    elif T == 1:
        # write-then-attend over the ring alone (kernel A2)
        out = swa_ring_flash_decode_stacked(
            q, k, v, rings_k, rings_v, layer_idx, cum_len, window
        )
    else:
        out = swa_ring_flash_attention(
            q, k, v, rings_k[layer_idx], rings_v[layer_idx], cum_len, window
        )
        ring_write_stacked(rings_k, rings_v, layer_idx, k, v, cum_len)
    return _dense(out.reshape(B, T, -1), p["o_proj"])


def delta_forward(
    p: Params,
    cfg: TextConfig,
    x: torch.Tensor,  # [B, T, D]
    conv_q: Optional[torch.Tensor],  # stacked [L, B, W, HK] or None
    conv_k: Optional[torch.Tensor],
    conv_v: Optional[torch.Tensor],
    h: Optional[torch.Tensor],  # stacked [L, B, H, K, V] fp32 or None
    layer_idx: int = 0,
    segment_ids: Optional[torch.Tensor] = None,  # [B, T]; stateless forward only
    tail_pads_only: bool = False,
) -> torch.Tensor:
    """Gated DeltaNet layer. With a state, layer `layer_idx` of the stacked
    conv histories and recurrent state is updated IN PLACE. Returns
    [B, T, D].

    `tail_pads_only` says that `segment_ids` mark nothing but padding after
    the one sequence of each row. The rule is causal, so the pads cannot
    reach the real tokens before them: it then runs without the ids (on a
    CUDA tensor through kernel C, which has no packed path), and only the
    pads' own outputs, which no label supervises, differ from the packed
    form's."""
    B, T, _ = x.shape
    K, V = cfg.linear_head_dim, cfg.head_v_dim
    if conv_q is None and "q_proj" in p and seq_chunked(cfg, T):
        # long stateless forward: the whole layer in sequence chunks
        # (delta_forward_seq_chunked); delta_seq_chunk_t gates it and
        # delta_seq_chunk_eval caps the chunk
        return delta_forward_seq_chunked(
            p, cfg, x, segment_ids, min(cfg.delta_seq_chunk_t, cfg.delta_seq_chunk_eval),
            tail_pads_only=tail_pads_only)
    o_norm = p["o_norm"]
    if "fused_proj" in p:  # fused layout (models/fuse.py): one matmul
        H = cfg.num_linear_heads
        fused = _dense(x, p["fused_proj"])  # [B, T, 2 HK + VD + 2 H + HV]
        hk, vd = H * K, H * V
        q_raw, k_raw, v_raw, a_lin, b_lin, g_lin = fused.split(
            [hk, hk, vd, H, H, fused.shape[-1] - 2 * hk - vd - 2 * H], dim=-1)
    else:
        x, o_norm = _delta_entry(p, x)
        q_raw = _dense(x, p["q_proj"])
        k_raw = _dense(x, p["k_proj"])
        v_raw = _dense(x, p["v_proj"])
        a_lin = _dense(x, p["a_proj"])
        b_lin = _dense(x, p["b_proj"])
        g_lin = _dense(x, p["g_proj"])
        H = a_lin.shape[-1]  # this rank's heads under tensor parallelism

    use_cache = conv_q is not None
    decode = use_cache and T == 1
    convs = []
    for raw, name, stack in ((q_raw, "q", conv_q), (k_raw, "k", conv_k), (v_raw, "v", conv_v)):
        w, bias = p[f"conv_{name}_w"], p.get(f"conv_{name}_b")
        if decode:
            y, new_c = short_conv_step(raw[:, 0], w, bias, stack[layer_idx])
            y = y[:, None]
        else:
            y, new_c = short_conv(
                raw, w, bias, stack[layer_idx] if use_cache else None,
                carry_history=cfg.conv_carry, segment_ids=segment_ids,
            )
        if use_cache:
            stack[layer_idx].copy_(new_c)
        convs.append(y)
    q = convs[0].reshape(B, T, H, K)
    k = convs[1].reshape(B, T, H, K)
    v = convs[2].reshape(B, T, H, V)

    beta = torch.sigmoid(b_lin.float())  # [B, T, H]; g/beta in fp32
    g = -torch.exp(p["A_log"].float()) * F.softplus(a_lin.float() + p["dt_bias"].float())

    if decode:
        # kernel B: both state reductions, the decay + rank-1 update and the
        # in-place write of the layer's slab of the stacked state
        o = delta_step_fused_stacked(
            q[:, 0], k[:, 0], v[:, 0], g[:, 0], beta[:, 0], h, layer_idx
        )[:, None]
    else:
        # the chunk math is chunk-size invariant; short inputs take a
        # smaller chunk so the pad to a chunk multiple stays small
        chunk = cfg.delta_chunk_size
        if T <= 512:
            chunk = min(chunk, 64)
        # with a state, kernel C reads the layer's slab of the stacked state
        # and writes the final state back into it
        slab = h[layer_idx] if use_cache else None
        o, _ = gated_delta_rule(
            q, k, v, g, beta,
            initial_state=slab,
            chunk_size=chunk,
            recurrent_threshold=cfg.recurrent_threshold,
            segment_ids=None if tail_pads_only else segment_ids,
            out_state=slab,
        )
    o = rms_norm_gated(o, g_lin.reshape(B, T, H, V), o_norm, eps=cfg.norm_eps)
    return _dense(o.reshape(B, T, H * V), p["o_proj"])


def mamba2_forward(
    p: Params,
    cfg: TextConfig,
    x: torch.Tensor,  # [B, T, D]
    conv_state: Optional[torch.Tensor],  # stacked [M, B, W, 3 H Dh] or None
    h_state: Optional[torch.Tensor],  # stacked [M, B, H, Dh, Dh] fp32 or None
    layer_idx: int = 0,
    segment_ids: Optional[torch.Tensor] = None,  # [B, T]; stateless forward only
) -> torch.Tensor:
    """Mamba2 SSD mixer, the conversion's second target: q / k / v
    projections (the SSD's C / B / x), one short conv over [v, k, q], per-
    head dt from dt_proj, the D skip, the gated RMSNorm over g_proj, o_proj.
    Stateless (segment_ids mask packed rows), cached chunked prefill (the
    conv's history read with cfg.conv_carry, as the DeltaNet layer's), or a
    T = 1 decode step; with a state, layer `layer_idx` of the stacked conv
    history and SSM state is updated IN PLACE. Plain torch on every device
    (the JAX package has no kernel for it). Returns [B, T, D].

    Under tensor parallelism the rank runs its heads (`_mamba2_entry`): its
    columns of q / k / v / g, its channels of the conv, its heads of
    dt_proj, D and the SSM state; o_proj sums the heads' parts."""
    B, T, _ = x.shape
    Dh = cfg.head_dim
    x, conv_w, conv_b, dt_proj, D, o_norm = _mamba2_entry(p, x)
    H = p["A_log"].shape[0]  # this rank's heads under tensor parallelism
    HD = H * Dh
    vkq = torch.cat([_dense(x, p["v_proj"]), _dense(x, p["k_proj"]), _dense(x, p["q_proj"])],
                    dim=-1)
    use_cache = conv_state is not None
    decode = use_cache and T == 1
    if decode:
        y1, new_cs = short_conv_step(vkq[:, 0], conv_w, conv_b, conv_state[layer_idx])
        vkq = y1[:, None]
    else:
        vkq, new_cs = short_conv(vkq, conv_w, conv_b,
                                 conv_state[layer_idx] if use_cache else None,
                                 carry_history=cfg.conv_carry, segment_ids=segment_ids)
    if use_cache:
        conv_state[layer_idx].copy_(new_cs)
    v, k, q = (t.reshape(B, T, H, Dh) for t in vkq.split(HD, dim=-1))
    dt = F.softplus(_dense(x, dt_proj).float() + p["dt_bias"].float())  # [B, T, H]
    A = -torch.exp(p["A_log"].float())
    if decode:
        y1, new_h = mamba2_step(v[:, 0], dt[:, 0], A, k[:, 0], q[:, 0], h_state[layer_idx])
        y = y1[:, None]
    else:
        y, new_h = mamba2_chunk_scan(
            v, dt, A, k, q, initial_state=h_state[layer_idx] if use_cache else None,
            chunk_size=cfg.delta_chunk_size, segment_ids=segment_ids)
    if use_cache:
        h_state[layer_idx].copy_(new_h)
    y = y + D.to(y.dtype)[None, None, :, None] * v
    o = rms_norm_gated(y, _dense(x, p["g_proj"]).reshape(B, T, H, Dh), o_norm,
                       eps=cfg.norm_eps)
    return _dense(o.reshape(B, T, HD), p["o_proj"])


def _mamba2_entry(p: Params, x: torch.Tensor):
    """(x, conv_w, conv_b, dt_proj node, D, o_norm) of a Mamba2 layer. Under
    tensor parallelism JAX's rules slice q / k / v / g_proj (columns),
    o_proj (rows), A_log and dt_bias (heads) and leave the rest whole: the
    input goes through `tp_copy` and each whole leaf is read through it and
    cut to this rank's heads (conv_w's and conv_b's channels are three
    blocks of the fused [v | k | q] stream, dt_proj's columns, D's
    entries; the per-head norm's weight whole), so every whole leaf's
    gradient is summed over the model group."""
    tp = _tp(p["q_proj"])
    if tp is None:
        return x, p["conv_w"], p.get("conv_b"), p["dt_proj"], p["D"], p["o_norm"]
    if tp_info(p["A_log"]) is None:  # H does not divide over the model axis
        raise NotImplementedError(
            f"tensor parallelism over {tp.world} ranks with {p['A_log'].shape[0]} Mamba2 "
            "heads (a split that cuts a head) is not ported to torch")
    Hl = p["A_log"].shape[0]
    h0 = tp.rank * Hl
    third = p["conv_w"].shape[-1] // 3
    n = third // tp.world

    def channels(t):  # this rank's channels of v, of k and of q
        t = tp_copy(t)
        return torch.cat([t.narrow(-1, j * third + tp.rank * n, n) for j in range(3)], dim=-1)

    dt = {}
    for key, val in p["dt_proj"].items():  # its output columns: the rank's heads
        if isinstance(val, torch.Tensor):
            val = tp_copy(val).narrow(val.ndim - 1, h0, Hl)
        dt[key] = val
    conv_b = p.get("conv_b")
    return (tp_copy(x), channels(p["conv_w"]), None if conv_b is None else channels(conv_b),
            dt, tp_copy(p["D"]).narrow(0, h0, Hl), tp_copy(p["o_norm"]))


def _pad_time(x: torch.Tensor, pad: int, value=0) -> torch.Tensor:
    """x [B, T, ...] with `pad` rows of `value` appended along T."""
    return torch.cat([x, x.new_full((x.shape[0], pad, *x.shape[2:]), value)], dim=1)


def _seq_ids(segment_ids: Optional[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    B, T = x.shape[:2]
    if segment_ids is None:
        return torch.zeros((B, T), dtype=torch.int32, device=x.device)
    return segment_ids.to(torch.int32)


def _swa_chunk(p, cfg, window, x_c, cos_c, sin_c, seg_c, pk, pv, pseg):
    """One chunk of swa_forward_seq_chunked: (y_c, k, v)."""
    B, C, _ = x_c.shape
    q, k, v = _swa_qkv(p, cfg, x_c)
    if _tp(p["q_proj"]) is not None:
        cos_c, sin_c = tp_copy(cos_c), tp_copy(sin_c)
    q, k = apply_rotary(q, k, cos_c, sin_c)
    # the query block is padded with inert zero rows so that (prev ++ cur)
    # is square, as kernel H takes it; their outputs are dropped
    out = swa_prefill_dense(
        torch.cat([torch.zeros_like(q), q], dim=1), torch.cat([pk, k], dim=1),
        torch.cat([pv, v], dim=1), window, segment_ids=torch.cat([pseg, seg_c], dim=1))
    return _dense(out[:, C:].reshape(B, C, -1), p["o_proj"]), k, v


def swa_forward_seq_chunked(
    p: Params,
    cfg: TextConfig,
    x: torch.Tensor,  # [B, T, D]
    cos: torch.Tensor,  # [B, T, head_dim]
    sin: torch.Tensor,
    segment_ids: Optional[torch.Tensor],
    window: int,
    carry: Optional[Tuple] = None,
    return_carry: bool = False,
):
    """Stateless sliding-window attention layer in window-sized sequence
    chunks, each a checkpoint. A query at p sees keys in (p - W, p], so at
    C = W with the previous chunk's post-RoPE K/V carried every query has
    its window: attention runs over (prev ++ cur), 2W positions, through
    kernel H, and keeps the current chunk's outputs. The first chunk's zero
    history has segment id -1 and tail pads (T padded to a multiple of W)
    -2, which no real token matches. Exact against the full-T layer; the
    attention's operations double, and the backward never holds full-T
    projections.

    `carry` / `return_carry` thread the (k, v, segment ids) of the last
    chunk across calls (decoder_layer_chunk_forward); they need T % window
    == 0. Returns y [B, T, D], or (y, carry) with `return_carry`."""
    B, T, _ = x.shape
    Hkv, Dh = _swa_heads(p, cfg)[1], cfg.head_dim
    C = window
    seg = _seq_ids(segment_ids, x)
    pad = (-T) % C
    if pad:
        if carry is not None or return_carry:
            raise ValueError(f"carry threading requires T % window == 0 (T={T}, W={C})")
        x, cos, sin = (_pad_time(t, pad) for t in (x, cos, sin))
        seg = _pad_time(seg, pad, -2)
    if carry is None:
        carry = (x.new_zeros((B, C, Hkv, Dh)), x.new_zeros((B, C, Hkv, Dh)),
                 torch.full((B, C), -1, dtype=torch.int32, device=x.device))
    pk, pv, pseg = carry
    ys = []
    for t0 in range(0, T + pad, C):
        sl = slice(t0, t0 + C)
        y_c, pk, pv = _maybe_checkpoint(_swa_chunk, p, cfg, window, x[:, sl], cos[:, sl],
                                        sin[:, sl], seg[:, sl], pk, pv, pseg)
        pseg = seg[:, sl]
        ys.append(y_c)
    y = torch.cat(ys, dim=1)[:, :T]
    return (y, (pk, pv, pseg)) if return_carry else y


def _delta_chunk(p, cfg, x_c, seg_c, rule_ids, s, tq, tk, tv, tseg):
    """One chunk of delta_forward_seq_chunked: (y_c, state, q/k/v tails)."""
    B, C, _ = x_c.shape
    K, V = cfg.linear_head_dim, cfg.head_v_dim
    H = p["A_log"].shape[0]  # this rank's heads under tensor parallelism
    W = p["conv_q_w"].shape[0]
    x_c, o_norm = _delta_entry(p, x_c)
    raws, convs = [], []
    for name, tail in (("q", tq), ("k", tk), ("v", tv)):
        raw = _dense(x_c, p[f"{name}_proj"])
        # the conv reads the tail's last W-1 rows as its left context
        hist = torch.cat([torch.zeros_like(tail[:, :1]), tail], dim=1)
        convs.append(causal_conv1d(raw, p[f"conv_{name}_w"], p.get(f"conv_{name}_b"),
                                   initial_state=hist, segment_ids=seg_c,
                                   initial_state_segment_ids=tseg))
        raws.append(raw)
    beta = torch.sigmoid(_dense(x_c, p["b_proj"]).float())
    g = -torch.exp(p["A_log"].float()) * F.softplus(
        _dense(x_c, p["a_proj"]).float() + p["dt_bias"].float())
    # a segment starting on the chunk's edge severs the carried state
    cont = (seg_c[:, 0] == tseg[:, -1]).float()[:, None, None, None]
    o, s_new = delta_rule_chunk_fused(
        convs[0].reshape(B, C, H, K), convs[1].reshape(B, C, H, K),
        convs[2].reshape(B, C, H, V), g, beta, initial_state=s * cont,
        chunk_size=cfg.delta_chunk_size, segment_ids=rule_ids)
    o = rms_norm_gated(o, _dense(x_c, p["g_proj"]).reshape(B, C, H, V), o_norm,
                       eps=cfg.norm_eps)
    y_c = _dense(o.reshape(B, C, H * V), p["o_proj"])
    return (y_c, s_new, *(r[:, C - (W - 1):] for r in raws))


def delta_forward_seq_chunked(
    p: Params,
    cfg: TextConfig,
    x: torch.Tensor,  # [B, T, D]
    segment_ids: Optional[torch.Tensor],
    seq_chunk: int,
    carry: Optional[Tuple] = None,
    return_carry: bool = False,
    tail_pads_only: bool = False,
):
    """Stateless DeltaNet layer in sequence chunks of `seq_chunk`, each a
    checkpoint: projections, short conv, the delta rule (kernel C from the
    carried state), gated norm and o_proj run per chunk, so the backward
    never holds full-T intermediates. Exact against the full-T layer:
    - conv: the previous chunk's last W-1 raw projections ride the carry
      with their segment ids (-1 for the zero history), so taps across the
      chunk edge match the full-T segment-masked conv;
    - delta state: carried in fp32 [B, H, K, V] and zeroed where a chunk's
      first token starts a new segment (the full rule's restart there).
    Tail pads (T padded to a multiple of the chunk) take segment id -2.
    The rule gets the chunk's ids only for packed rows: with
    `tail_pads_only` or without ids, pads only follow the real tokens and
    the causal rule keeps them from those (as delta_forward does).

    `carry` / `return_carry` thread (state, q/k/v tails, tail ids) across
    calls (decoder_layer_chunk_forward); they need T % seq_chunk == 0.
    Returns y [B, T, D], or (y, carry) with `return_carry`."""
    B, T, _ = x.shape
    C = seq_chunk
    seg = _seq_ids(segment_ids, x)
    packed = segment_ids is not None and not tail_pads_only
    pad = (-T) % C
    if pad:
        if carry is not None or return_carry:
            raise ValueError(f"carry threading requires T % seq_chunk == 0 "
                             f"(T={T}, chunk={C})")
        x = _pad_time(x, pad)
        seg = _pad_time(seg, pad, -2)
    if carry is None:
        carry = init_layer_seq_carry(p, cfg, LINEAR, B, x.dtype, x.device)
    s, tq, tk, tv, tseg = carry
    ys = []
    for t0 in range(0, T + pad, C):
        seg_c = seg[:, t0 : t0 + C]
        y_c, s, tq, tk, tv = _maybe_checkpoint(
            _delta_chunk, p, cfg, x[:, t0 : t0 + C], seg_c, seg_c if packed else None,
            s, tq, tk, tv, tseg)
        tseg = seg_c[:, C - tq.shape[1]:]
        ys.append(y_c)
    y = torch.cat(ys, dim=1)[:, :T]
    return (y, (s, tq, tk, tv, tseg)) if return_carry else y


def init_layer_seq_carry(p: Params, cfg: TextConfig, role: str, B: int, dtype,
                         device=None) -> Tuple:
    """The zero carry of a layer's first sequence chunk
    (decoder_layer_chunk_forward). SLIDING: the previous window's post-RoPE
    (k, v) and their segment ids, -1 (the zero history, seen by no real
    token). LINEAR: the fp32 delta state, the conv tails (the last W-1 raw
    projections) and their segment ids, -1."""
    device = device or p["input_norm"].device
    if role == SLIDING:
        W, Hkv, Dh = cfg.sliding_window, _swa_heads(p, cfg)[1], cfg.head_dim
        return (torch.zeros((B, W, Hkv, Dh), dtype=dtype, device=device),
                torch.zeros((B, W, Hkv, Dh), dtype=dtype, device=device),
                torch.full((B, W), -1, dtype=torch.int32, device=device))
    if role == LINEAR:
        H, K, V = p["A_log"].shape[0], cfg.linear_head_dim, cfg.head_v_dim
        W = p["conv_q_w"].shape[0]
        tails = tuple(torch.zeros((B, W - 1, p[f"conv_{n}_w"].shape[1]), dtype=dtype,
                                  device=device) for n in ("q", "k", "v"))
        return (torch.zeros((B, H, K, V), dtype=torch.float32, device=device), *tails,
                torch.full((B, W - 1), -1, dtype=torch.int32, device=device))
    raise NotImplementedError(
        f"the sequence-chunk carry exists for sliding and linear layers only (got {role!r}); "
        "a full_attention layer needs every earlier key")


def decoder_layer_chunk_forward(
    p: Params,
    cfg: TextConfig,
    role: str,
    x: torch.Tensor,  # [B, Tc, D] one sequence chunk
    cos: torch.Tensor,
    sin: torch.Tensor,
    segment_ids: Optional[torch.Tensor],
    carry: Tuple,
) -> Tuple[torch.Tensor, Tuple]:
    """The pre-norm residual block over one sequence chunk with the
    cross-chunk state explicit: feeding a sequence's chunks left to right
    and threading the carry (init_layer_seq_carry first) gives the full-T
    stateless forward. SWA layers need Tc % sliding_window == 0. Returns
    (x', carry')."""
    h = rms_norm(x, p["input_norm"], cfg.rms_norm_eps)
    if role == SLIDING:
        attn, new_carry = swa_forward_seq_chunked(
            p, cfg, h, cos, sin, segment_ids, cfg.sliding_window, carry=carry,
            return_carry=True)
    elif role == LINEAR:
        Tc = x.shape[1]
        sc = min(cfg.delta_seq_chunk_t or Tc, cfg.delta_seq_chunk_eval, Tc)
        if Tc % sc:
            sc = Tc
        attn, new_carry = delta_forward_seq_chunked(p, cfg, h, segment_ids, sc, carry=carry,
                                                    return_carry=True)
    else:
        raise NotImplementedError(f"the sequence-chunk carry exists for sliding and linear "
                                  f"layers only (got {role!r})")
    x = x + attn
    return x + _mlp(p, cfg, rms_norm(x, p["post_norm"], cfg.rms_norm_eps), True), new_carry


def _mlp(p: Params, cfg: TextConfig, h: torch.Tensor, stateless: bool) -> torch.Tensor:
    """The MLP, sequence-chunked where JAX chunks it: a stateless forward
    of more than cfg.mlp_chunk_t positions, a multiple of it."""
    ct, T = cfg.mlp_chunk_t, h.shape[1]
    if ct and stateless and T > ct and T % ct == 0:
        return mlp_forward_chunked(p["mlp"], h, ct)
    return mlp_forward(p["mlp"], h)


def decoder_layer_forward(
    p: Params,
    cfg: TextConfig,
    role: str,
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    state: Optional[DecoderState],
    stack_idx: int,
    segment_ids: Optional[torch.Tensor] = None,
    tail_pads_only: bool = False,
) -> torch.Tensor:
    """Pre-norm residual block. `stack_idx` is the layer's index within the
    SWA, DeltaNet or Mamba2 stack of `state` (updated in place)."""
    if segment_ids is not None and state is not None:
        raise ValueError("segment_ids (packed sequences) belong to the stateless "
                         "forward; a cached forward takes one sequence per row")
    h = rms_norm(x, p["input_norm"], cfg.rms_norm_eps)
    if role in (SLIDING, FULL):
        if role == FULL and state is not None:
            raise NotImplementedError(
                "cached decoding with full_attention layers is not supported "
                "(the deployed InfiniteVL config has none)"
            )
        window = cfg.sliding_window if role == SLIDING else (1 << 30)
        if state is None:
            attn = swa_attention_forward(p, cfg, h, cos, sin, None, None, None,
                                         window=window, segment_ids=segment_ids)
        else:
            attn = swa_attention_forward(
                p, cfg, h, cos, sin, state["swa_k"], state["swa_v"],
                state["cum_len"], layer_idx=stack_idx, window=window,
            )
    elif role == LINEAR:
        if state is None:
            attn = delta_forward(p, cfg, h, None, None, None, None,
                                 segment_ids=segment_ids, tail_pads_only=tail_pads_only)
        else:
            attn = delta_forward(
                p, cfg, h, state["conv_q"], state["conv_k"], state["conv_v"],
                state["delta_h"], layer_idx=stack_idx,
            )
    elif role == MAMBA2:
        if state is None:
            attn = mamba2_forward(p, cfg, h, None, None, segment_ids=segment_ids)
        else:
            attn = mamba2_forward(p, cfg, h, state["mamba_conv"], state["mamba_h"],
                                  layer_idx=stack_idx)
    else:
        raise NotImplementedError(f"layer role {role!r} is not ported to torch yet")
    x = x + attn
    return x + _mlp(p, cfg, rms_norm(x, p["post_norm"], cfg.rms_norm_eps), state is None)


def _run_layers(layers, cfg, roles, x, cos, sin, segment_ids, tail_pads_only):
    """A run of stateless layers (one checkpointed unit of `remat_group`).
    A sharded layer is gathered here, inside the checkpoint: its full
    weights live while it runs and are gathered again by the recompute."""
    for layer_p, role in zip(layers, roles):
        x = decoder_layer_forward(gather_tree(layer_p), cfg, role, x, cos, sin, None, 0,
                                  segment_ids, tail_pads_only)
    return x


def text_forward(
    params: Params,
    cfg: TextConfig,
    inputs_embeds: torch.Tensor,  # [B, T, D]
    position_ids: torch.Tensor,  # [3, B, T]
    state: Optional[DecoderState] = None,
    segment_ids: Optional[torch.Tensor] = None,  # [B, T]; packed sequences
    remat: bool = False,
    remat_group: int = 1,
    tail_pads_only: bool = False,  # the ids mark only pads after one sequence per row
    output_hidden_states: bool = False,
):
    """Run the decoder stack. With a state, the state is updated IN PLACE
    (rings, conv histories, delta_h, and cum_len += T) and returned.
    Returns (final-normed hidden [B, T, D], state), and with
    `output_hidden_states` (hidden, state, hidden_states) as in JAX:
    hidden_states[i] is layer i's input, [n] the last layer's output
    before the final norm (what distillation regresses onto), [n + 1] the
    normed final hidden.

    Without a state the forward is stateless (training). `remat` then wraps
    each layer in torch.utils.checkpoint: only the layer boundaries stay
    alive and a layer's internals are recomputed in its backward;
    `remat_group` > 1 checkpoints runs of that many layers instead (fewer
    boundaries, the run's interior recomputed as a whole). The Python loop
    recomputes one unit at a time by construction, which is what the JAX
    package's stacked layout (`layer_stacks`, scan_layers, remat_mode) is
    for: that layout is not built here."""
    if "layer_stacks" in params:
        raise NotImplementedError(
            "scan-over-layers params (layer_stacks) are not ported to torch: the "
            "Python layer loop with per-layer checkpointing takes their place"
        )
    params = gather_top(params)
    cos, sin = mrope_cos_sin(
        position_ids, params["inv_freq"], cfg.mrope_section,
        cfg.attention_scaling, dtype=inputs_embeds.dtype,
    )
    x = inputs_embeds
    layers = params["layers"]
    roles = [cfg.layer_role(idx) for idx in range(len(layers))]
    collected = [] if output_hidden_states else None
    if remat and state is None and torch.is_grad_enabled():
        # collecting needs every layer boundary: one layer a checkpoint
        group = 1 if collected is not None else max(int(remat_group), 1)
        for start in range(0, len(layers), group):
            if collected is not None:
                collected.append(x)
            run = (layers[start : start + group], cfg, roles[start : start + group], x, cos,
                   sin, segment_ids, tail_pads_only)
            x = checkpoint(_run_layers, *run, use_reentrant=False)
    else:
        # each role's index within its stack of the state: SWA, DeltaNet, Mamba2
        stack_of = {SLIDING: 0, FULL: 0, LINEAR: 1, MAMBA2: 2}
        counts = [0, 0, 0]
        for layer_p, role in zip(layers, roles):
            if collected is not None:
                collected.append(x)
            which = stack_of.get(role, 1)
            x = decoder_layer_forward(gather_tree(layer_p), cfg, role, x, cos, sin, state,
                                      counts[which], segment_ids, tail_pads_only)
            counts[which] += 1
    if collected is not None:
        collected.append(x)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    if state is not None:
        state["cum_len"] += inputs_embeds.shape[1]
    if collected is not None:
        collected.append(x)
        return x, state, collected
    return x, state


def lm_head(params: Params, cfg: TextConfig, hidden: torch.Tensor) -> torch.Tensor:
    """fp32 logits; tied to the embedding when cfg.tie_word_embeddings.
    With a quantized table (models/quant.quantize_embed_rows) the head
    reads the pre-transposed int8 copy `head_q` [hidden, vocab] (or an
    untied `lm_head_q`); the row scales are per-logit column scales and
    commute with the contraction."""
    if "lm_head_q" in params:  # untied quantized head [hidden, vocab]
        q, s = params["lm_head_q"], params["lm_head_scale"]
    elif "lm_head" in params:
        return head_logits(hidden, params["lm_head"], False).float()
    elif "head_q" in params:  # tied quantized table, head copy
        q, s = params["head_q"], params["embed_scale"]
    else:
        return head_logits(hidden, params["embed"], True).float()
    return ((hidden @ q.to(hidden.dtype)) * s.to(hidden.dtype)).float()


def head_logits(hidden: torch.Tensor, w: torch.Tensor, w_is_vd: bool) -> torch.Tensor:
    """hidden @ the head weight (lm_head [D, V], or with `w_is_vd` the tied
    table [V, D]) in the hidden's dtype. A weight sharded on D (tensor
    parallelism) gives partial logits from the rank's D slice of the
    hidden, summed over the model group."""
    info = tp_info(w)
    if info is not None:
        n = w.shape[1 if w_is_vd else 0]
        hidden = tp_copy(hidden).narrow(-1, info.rank * n, n).contiguous()
    w = w.to(hidden.dtype)
    logits = hidden @ (w.T if w_is_vd else w)
    return logits if info is None else tp_sum(logits)


def embed_tokens(params: Params, input_ids: torch.Tensor) -> torch.Tensor:
    """The token embeddings [.., D]; a table sharded on D (tensor
    parallelism) is looked up in the rank's columns and gathered whole."""
    if "embed_q" in params:
        # int8 gather + per-row dequant; the output dtype rides on the scale
        s = params["embed_scale"][input_ids]
        return params["embed_q"][input_ids].to(s.dtype) * s[..., None]
    e = params["embed"][input_ids]
    return e if tp_info(params["embed"]) is None else tp_gather(e)
