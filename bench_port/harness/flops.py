"""The FLOPs the model needs, counted from the configuration file's sizes:
the ViT's linears and visible attention, the merger, the decoder's linears,
the sliding window's visible keys, the delta rule's and the SSD's chunked
products (triangles counted as triangles) and the head wherever it runs.
Recomputation is not counted. A multiply-add is two FLOPs."""

from __future__ import annotations

from typing import Any, Dict

CHUNK = 64  # the chunk of the delta rule and the SSD


def _sizes(spec: Dict[str, Any]):
    from reference.infinitevl import Sizes  # sizes only, no model code

    return Sizes(spec)


def delta_chunk_flops(T: int, H: int, K: int, V: int, C: int = CHUNK) -> float:
    """The chunked delta rule for T tokens of one row: per chunk and head the
    strict lower half of k k^T, the lower half of q k^T, the triangular
    solve on the right-hand sides, w S and q S, the masked product with the
    values and the state update (the count of kernel C's bound); a last
    partial chunk of r tokens counts its own r."""
    def per(r):
        return (r * (r - 1) * K + r * (r + 1) * K + r * (r - 1) * (K + V)
                + 6 * r * K * V + r * (r + 1) * V)
    return float(H * ((T // C) * per(C) + per(T % C)))


def ssd_chunk_flops(T: int, H: int, N: int, P: int, C: int = CHUNK) -> float:
    """Mamba2's chunked SSD: per chunk and head the lower half of C B^T and
    of its product with x, the state's output and its injection."""
    def per(r):
        return r * (r + 1) * N + r * (r + 1) * P + 4 * r * N * P
    return float(H * ((T // C) * per(C) + per(T % C)))


def decoder_linear_flops_per_token(spec: Dict[str, Any]) -> float:
    S = _sizes(spec)
    D, I = S.D, S.I
    total = 0.0
    for role in S.roles:
        if role in ("swa", "full"):
            total += 2 * D * (2 * S.Hq * S.Dh + 2 * S.Hkv * S.Dh)
        elif role == "delta":
            HK, HV = S.H * S.K, S.H * S.Vd
            KD = S.t["num_linear_key_value_heads"] * S.K
            total += 2 * D * (HK + KD + HV + 2 * S.H + HV) + 2 * HV * D
        else:  # mamba2
            HD = S.Hq * S.Dh
            total += 2 * D * (4 * HD + S.Hq) + 2 * HD * D
        total += 2 * 3 * D * I
    return total


def head_flops(spec: Dict[str, Any]) -> float:
    S = _sizes(spec)
    return 2.0 * S.D * S.V


def swa_attention_flops(spec: Dict[str, Any], visible_keys: float) -> float:
    """QK^T and PV of every sliding-window layer for `visible_keys` summed
    over the queries."""
    S = _sizes(spec)
    n = sum(1 for r in S.roles if r in ("swa", "full"))
    return 4.0 * S.Hq * S.Dh * visible_keys * n


def mixer_flops(spec: Dict[str, Any], T: int) -> float:
    """The recurrent layers' chunked products for one call of T tokens."""
    S = _sizes(spec)
    n_delta = sum(1 for r in S.roles if r == "delta")
    n_m2 = sum(1 for r in S.roles if r == "mamba2")
    return (n_delta * delta_chunk_flops(T, S.H, S.K, S.Vd)
            + n_m2 * ssd_chunk_flops(T, S.Hq, S.Dh, S.Dh))


def visible_keys(cum_len: int, T: int, window: int) -> float:
    """Keys seen by T queries at positions cum_len .. cum_len + T - 1."""
    k = max(0, min(T, window - cum_len))  # queries that see fewer than `window` keys
    part = k * (cum_len + 1) + k * (k - 1) // 2
    return float(part + (T - k) * window)


def vit_frame_flops(spec: Dict[str, Any], gh: int, gw: int) -> float:
    """One frame of gh x gw patches through the ViT and the merger."""
    S = _sizes(spec)
    D, I, H = S.vD, S.vI, S.vH
    n = gh * gw
    in_feat = 3 * S.tps * S.ps * S.ps
    wp = S.win_patches
    # visible pairs of a window block: windows of wp x wp patches (edge windows smaller)
    rows = [min(wp, gh - r) for r in range(0, gh, wp)]
    cols = [min(wp, gw - c) for c in range(0, gw, wp)]
    win_pairs = sum((r * c) ** 2 for r in rows for c in cols)
    total = 2.0 * n * in_feat * D
    for j in range(S.v["depth"]):
        pairs = n * n if j in S.full_blocks else win_pairs
        total += 2.0 * n * D * (3 * D + D) + 2.0 * n * 3 * D * I + 4.0 * (D // H) * H * pairs
    u = S.m * S.m
    merged = n // u
    total += 2.0 * merged * (u * D) * (u * D) + 2.0 * merged * (u * D) * S.v["out_hidden_size"]
    return total


def stream_frame_flops(spec: Dict[str, Any], gh: int, gw: int, cum_len: int) -> float:
    """One stream frame: the ViT, then <vision_start> + its tokens through
    the decoder as one call at cum_len (no head)."""
    S = _sizes(spec)
    T = 1 + (gh // S.m) * (gw // S.m)
    return (vit_frame_flops(spec, gh, gw) + T * decoder_linear_flops_per_token(spec)
            + swa_attention_flops(spec, visible_keys(cum_len, T, S.W)) + mixer_flops(spec, T))


def prefill_flops(spec: Dict[str, Any], T: int, chunk: int) -> float:
    """A text prompt of T tokens prefilled in `chunk`-token calls, the head
    on each call's last token."""
    S = _sizes(spec)
    total = 0.0
    for t0 in range(0, T, chunk):
        n = min(chunk, T - t0)
        total += (n * decoder_linear_flops_per_token(spec)
                  + swa_attention_flops(spec, visible_keys(t0, n, S.W))
                  + mixer_flops(spec, n) + head_flops(spec))
    return total

