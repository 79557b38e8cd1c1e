"""The torch port's plain ops against their JAX counterparts, on the CPU in
fp32: the same numpy inputs through both, err_ratio <= 1e-5 (fp32
summation order is the only difference)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import jax_compile_cache  # noqa: F401 (autouse)

import infinitevl_tpu.ops.delta_rule as jdr
import infinitevl_tpu.ops.norms as jnorms
import infinitevl_tpu.ops.rope as jrope
import infinitevl_tpu.ops.swa as jswa
import infinitevl_tpu_torch.ops.delta_rule as tdr
import infinitevl_tpu_torch.ops.norms as tnorms
import infinitevl_tpu_torch.ops.rope as trope
import infinitevl_tpu_torch.ops.short_conv as tconv
import infinitevl_tpu_torch.ops.swa as tswa
from infinitevl_tpu.config import TextConfig

# the JAX ops package re-exports a function under this module's name
jconv = importlib.import_module("infinitevl_tpu.ops.short_conv")

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = 1e-5


def err_ratio(x, ref):
    x = np.asarray(x, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.abs(x - ref).mean() / (np.abs(ref).mean() + 1e-12)


def both(*arrays):
    """numpy fp32 arrays -> (jax arrays, torch tensors)."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.array(a)) for a in arrays])


def rnd(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------- norms


@pytest.mark.parametrize("activation", ["silu", "sigmoid"])
def test_norms_match_jax(activation):
    rng = np.random.RandomState(0)
    x, gate, w = rnd(rng, 3, 5, 32), rnd(rng, 3, 5, 32), rnd(rng, 32)
    (jx, jg, jw), (tx, tg, tw) = both(x, gate, w)
    assert err_ratio(tnorms.rms_norm(tx, tw), jnorms.rms_norm(jx, jw)) < TOL
    assert err_ratio(
        tnorms.rms_norm_gated(tx, tg, tw, activation=activation),
        jnorms.rms_norm_gated(jx, jg, jw, activation=activation),
    ) < TOL
    assert err_ratio(tnorms.l2norm(tx), jnorms.l2norm(jx)) < TOL
    assert err_ratio(tnorms.silu(tx), jnorms.silu(jx)) < TOL


# ---------------------------------------------------------------- rope

ROPE_CASES = {
    "default": {},
    "linear": dict(rope_factor=4.0),
    "dynamic": dict(rope_factor=4.0, rope_original_max_position_embeddings=4096),
    "yarn": dict(rope_factor=4.0, rope_original_max_position_embeddings=4096),
    "llama3": dict(rope_factor=8.0, rope_original_max_position_embeddings=8192),
}


@pytest.mark.parametrize("rope_type", sorted(ROPE_CASES))
def test_rope_init_every_variant(rope_type):
    cfg = TextConfig(rope_type=rope_type, max_position_embeddings=32768,
                     **ROPE_CASES[rope_type])
    for seq_len in (None, 65536):
        inv_t, sc_t = trope.rope_init(cfg, seq_len)
        inv_j, sc_j = jrope.rope_init(cfg, seq_len)
        np.testing.assert_array_equal(inv_t, inv_j)
        assert sc_t == sc_j


def test_mrope_cos_sin_and_rotary_match_jax():
    rng = np.random.RandomState(1)
    B, T, H, Hkv, D = 2, 7, 4, 2, 16
    section = (4, 2, 2)
    np.testing.assert_array_equal(
        trope.mrope_axis_index(D, section), jrope.mrope_axis_index(D, section)
    )
    pos = rng.randint(0, 300, (3, B, T)).astype(np.int32)
    inv = jrope.default_inv_freq(D, 1e6).astype(np.float32)
    jc, js = jrope.mrope_cos_sin(jnp.asarray(pos), jnp.asarray(inv), section, 1.3)
    tc, ts = trope.mrope_cos_sin(torch.from_numpy(pos), torch.from_numpy(inv), section, 1.3)
    assert err_ratio(tc, jc) < TOL and err_ratio(ts, js) < TOL
    q, k = rnd(rng, B, T, H, D), rnd(rng, B, T, Hkv, D)
    jq, jk = jrope.apply_rotary(jnp.asarray(q), jnp.asarray(k), jc, js)
    tq, tk = trope.apply_rotary(torch.from_numpy(q), torch.from_numpy(k), tc, ts)
    assert err_ratio(tq, jq) < TOL and err_ratio(tk, jk) < TOL


# ---------------------------------------------------------------- short conv


@pytest.mark.parametrize("carry_history", [False, True])
@pytest.mark.parametrize("T", [2, 9])
def test_short_conv_with_history_matches_jax(carry_history, T):
    rng = np.random.RandomState(2)
    B, W, D = 2, 4, 24
    x, w, b, st = rnd(rng, B, T, D), rnd(rng, W, D), rnd(rng, D), rnd(rng, B, W, D)
    (jx, jw, jb, jst), (tx, tw, tb, tst) = both(x, w, b, st)
    jy, jns = jconv.short_conv(jx, jw, jb, jst, carry_history=carry_history)
    ty, tns = tconv.short_conv(tx, tw, tb, tst, carry_history=carry_history)
    assert err_ratio(ty, jy) < TOL
    np.testing.assert_array_equal(tns.numpy(), np.asarray(jns))


def test_short_conv_step_matches_jax():
    rng = np.random.RandomState(3)
    B, W, D = 2, 4, 24
    x, w, st = rnd(rng, B, D), rnd(rng, W, D), rnd(rng, B, W, D)
    (jx, jw, jst), (tx, tw, tst) = both(x, w, st)
    jy, jns = jconv.short_conv_step(jx, jw, None, jst)
    ty, tns = tconv.short_conv_step(tx, tw, None, tst)
    assert err_ratio(ty, jy) < TOL
    np.testing.assert_array_equal(tns.numpy(), np.asarray(jns))


# ---------------------------------------------------------------- delta rule


def _delta_inputs(seed, B=2, T=37, H=3, K=16, V=32):
    rng = np.random.RandomState(seed)
    q, k, v = rnd(rng, B, T, H, K), rnd(rng, B, T, H, K), rnd(rng, B, T, H, V)
    g = (-3 * rng.uniform(size=(B, T, H))).astype(np.float32)
    beta = (1 / (1 + np.exp(-rng.standard_normal((B, T, H))))).astype(np.float32)
    s0 = rnd(rng, B, H, K, V)
    return q, k, v, g, beta, s0


def test_delta_rule_recurrent_matches_jax():
    (jq, jk, jv, jg, jb, js0), (tq, tk, tv, tg, tb, ts0) = both(*_delta_inputs(4))
    jo, js = jdr.delta_rule_recurrent(jq, jk, jv, jg, jb, js0)
    to, ts = tdr.delta_rule_recurrent(tq, tk, tv, tg, tb, ts0)
    assert err_ratio(to, jo) < TOL and err_ratio(ts, js) < TOL


def test_delta_rule_step_matches_jax():
    q, k, v, g, beta, s0 = _delta_inputs(5, T=1)
    (jq, jk, jv, jg, jb, js0), (tq, tk, tv, tg, tb, ts0) = both(
        q[:, 0], k[:, 0], v[:, 0], g[:, 0], beta[:, 0], s0
    )
    jo, js = jdr.delta_rule_step(jq, jk, jv, jg, jb, js0)
    to, ts = tdr.delta_rule_step(tq, tk, tv, tg, tb, ts0)
    assert err_ratio(to, jo) < TOL and err_ratio(ts, js) < TOL


@pytest.mark.parametrize("chunk_size", [8, 16])
@pytest.mark.parametrize("with_state", [False, True])
def test_delta_rule_chunk_matches_jax(chunk_size, with_state):
    (jq, jk, jv, jg, jb, js0), (tq, tk, tv, tg, tb, ts0) = both(*_delta_inputs(6))
    jo, js = jdr.delta_rule_chunk(jq, jk, jv, jg, jb, js0 if with_state else None,
                                  chunk_size=chunk_size)
    to, ts = tdr.delta_rule_chunk(tq, tk, tv, tg, tb, ts0 if with_state else None,
                                  chunk_size=chunk_size)
    assert err_ratio(to, jo) < TOL and err_ratio(ts, js) < TOL


@pytest.mark.parametrize("T", [8, 9])  # threshold 8: recurrent at 8, chunk at 9
def test_gated_delta_rule_dispatch_matches_jax(T):
    (jq, jk, jv, jg, jb, js0), (tq, tk, tv, tg, tb, ts0) = both(*_delta_inputs(7, T=T))
    kw = dict(chunk_size=4, recurrent_threshold=8)
    jo, js = jdr.gated_delta_rule(jq, jk, jv, jg, jb, js0, **kw)
    to, ts = tdr.gated_delta_rule(tq, tk, tv, tg, tb, ts0, **kw)
    assert err_ratio(to, jo) < TOL and err_ratio(ts, js) < TOL


def _segments(B, T):
    seg = np.ones((B, T), np.int32)
    seg[:, T // 3: 2 * T // 3] = 2
    seg[:, 2 * T // 3:] = 3
    seg[1, T // 3 - 2: T // 3] = 5  # row 1: another boundary, inside a chunk
    seg[1, T - 2:] = 0
    return seg


def test_segment_ids_not_ported_yet():
    """The name dates from the serving slices, when packed `segment_ids`
    raised. They are ported now: the recurrence still refuses them (as in
    the JAX package: chunk mode only), the short conv and the dispatch take
    them and match JAX to 1e-5."""
    (jq, jk, jv, jg, jb, _), (tq, tk, tv, tg, tb, _) = both(*_delta_inputs(8, T=12))
    seg = _segments(2, 12)
    with pytest.raises(ValueError, match="chunk mode"):
        tdr.gated_delta_rule(tq, tk, tv, tg, tb, segment_ids=torch.from_numpy(seg),
                             recurrent_threshold=12)
    kw = dict(chunk_size=4, recurrent_threshold=4)
    jo, js = jdr.gated_delta_rule(jq, jk, jv, jg, jb, segment_ids=jnp.asarray(seg), **kw)
    to, ts = tdr.gated_delta_rule(tq, tk, tv, tg, tb, segment_ids=torch.from_numpy(seg), **kw)
    assert err_ratio(to, jo) < TOL and err_ratio(ts, js) < TOL
    x = tq.reshape(2, 12, -1)
    w = rnd(np.random.RandomState(0), 4, 48)
    jy, _ = jconv.short_conv(jnp.asarray(x.numpy()), jnp.asarray(w), None, None,
                             segment_ids=jnp.asarray(seg))
    ty, _ = tconv.short_conv(x, torch.from_numpy(w), None, None,
                             segment_ids=torch.from_numpy(seg))
    assert err_ratio(ty, jy) < TOL


@pytest.mark.parametrize("chunk_size", [8, 16])
@pytest.mark.parametrize("with_state", [False, True])
def test_delta_rule_chunk_segments_match_jax(chunk_size, with_state):
    """Packed sequences in the chunk rule: boundaries inside a chunk and
    (T = 48, thirds at 16 and 32) exactly at chunk edges, a ragged tail
    (T = 37) that pads with the last segment; outputs and final state
    <= 1e-5 of JAX's."""
    for T in (37, 48):
        (jq, jk, jv, jg, jb, js0), (tq, tk, tv, tg, tb, ts0) = both(*_delta_inputs(6, T=T))
        seg = _segments(2, T)
        jo, js = jdr.delta_rule_chunk(jq, jk, jv, jg, jb, js0 if with_state else None,
                                      chunk_size=chunk_size, segment_ids=jnp.asarray(seg))
        to, ts = tdr.delta_rule_chunk(tq, tk, tv, tg, tb, ts0 if with_state else None,
                                      chunk_size=chunk_size,
                                      segment_ids=torch.from_numpy(seg))
        assert err_ratio(to, jo) < TOL and err_ratio(ts, js) < TOL
        # a packed row equals its segments run alone: segment 2 of row 0
        lo, hi = T // 3, 2 * T // 3
        alone, _ = tdr.delta_rule_chunk(tq[:1, lo:hi], tk[:1, lo:hi], tv[:1, lo:hi],
                                        tg[:1, lo:hi], tb[:1, lo:hi], chunk_size=chunk_size)
        assert err_ratio(to[:1, lo:hi], alone) < 1e-4


@pytest.mark.parametrize("carry_history", [False, True])
def test_short_conv_segments_match_jax(carry_history):
    rng = np.random.RandomState(12)
    B, T, D, W = 2, 19, 6, 4
    x, w, bias, st = rnd(rng, B, T, D), rnd(rng, W, D), rnd(rng, D), rnd(rng, B, W, D)
    seg = _segments(B, T)
    (jx, jw, jbias, jst), (tx, tw, tbias, tst) = both(x, w, bias, st)
    for state_j, state_t in ((None, None), (jst, tst)):
        jy, jns = jconv.short_conv(jx, jw, jbias, state_j, carry_history=carry_history,
                                   segment_ids=jnp.asarray(seg))
        ty, tns = tconv.short_conv(tx, tw, tbias, state_t, carry_history=carry_history,
                                   segment_ids=torch.from_numpy(seg))
        assert err_ratio(ty, jy) < TOL
        if state_j is not None:
            np.testing.assert_array_equal(tns.numpy(), np.asarray(jns))


# ---------------------------------------------------------------- swa


@pytest.mark.parametrize("T", [5, 40])  # 40 > cap: only the last cap tokens land
@pytest.mark.parametrize("cum", [0, 13, 100])
def test_ring_write_matches_jax(T, cum):
    rng = np.random.RandomState(9)
    B, Hkv, cap, D = 2, 2, 16, 8
    rk, rv = rnd(rng, B, Hkv, cap, D), rnd(rng, B, Hkv, cap, D)
    nk, nv = rnd(rng, B, T, Hkv, D), rnd(rng, B, T, Hkv, D)
    jk, jv = jswa.ring_write(jnp.asarray(rk), jnp.asarray(rv), jnp.asarray(nk),
                             jnp.asarray(nv), jnp.int32(cum))
    tk, tv = torch.from_numpy(rk.copy()), torch.from_numpy(rv.copy())
    tswa.ring_write(tk, tv, torch.from_numpy(nk), torch.from_numpy(nv), cum)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(
        tswa.ring_slot_positions(cum + T, cap).numpy(),
        np.asarray(jswa.ring_slot_positions(jnp.int32(cum + T), cap)),
    )


@pytest.mark.parametrize("cum", [0, 7, 30])
def test_swa_cached_attention_matches_jax(cum):
    rng = np.random.RandomState(10)
    B, T, Hq, Hkv, D, W = 2, 20, 4, 2, 16, 16
    q, nk, nv = rnd(rng, B, T, Hq, D), rnd(rng, B, T, Hkv, D), rnd(rng, B, T, Hkv, D)
    rk, rv = rnd(rng, B, Hkv, W, D), rnd(rng, B, Hkv, W, D)
    jo, jrk, _ = jswa.swa_cached_attention(*map(jnp.asarray, (q, nk, nv, rk, rv)),
                                           jnp.int32(cum), W)
    tk, tv = torch.from_numpy(rk.copy()), torch.from_numpy(rv.copy())
    to = tswa.swa_cached_attention(torch.from_numpy(q), torch.from_numpy(nk),
                                   torch.from_numpy(nv), tk, tv, cum, W)
    assert err_ratio(to, jo) < TOL
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jrk))
    jd = jswa.swa_prefill_dense(*map(jnp.asarray, (q, nk, nv)), W)
    td = tswa.swa_prefill_dense(*map(torch.from_numpy, (q, nk, nv)), W)
    assert err_ratio(td, jd) < TOL


def test_delta_rule_chunk_bf16_matches_jax():
    """bf16 models: both sides round the matmul operands to bf16 at the
    same points and accumulate in fp32; tolerance 1e-3 (a bf16 ulp where
    the fp32 summation order flips a rounding)."""
    q, k, v, g, beta, _ = _delta_inputs(12, B=1, T=100, H=2, K=32, V=64)
    jo, js = jdr.delta_rule_chunk(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                                  jnp.asarray(g), jnp.asarray(beta), chunk_size=16)
    to, ts = tdr.delta_rule_chunk(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
                                  torch.from_numpy(g), torch.from_numpy(beta), chunk_size=16)
    assert to.dtype == torch.bfloat16
    assert err_ratio(to.float(), jnp.asarray(jo, jnp.float32)) < 1e-3
    assert err_ratio(ts, js) < 1e-3


def test_delta_rule_chunk_fp32_compute_dtype():
    """compute_dtype=torch.float32 is kernel C's arithmetic: for fp32 inputs
    it is today's delta_rule_chunk number for number; for bf16 inputs it
    widens first, so it differs from the bf16 precision model only by the
    rounding of intermediates (1e-2, a few bf16 ulps) and matches the fp32
    run on the same (bf16-representable) values up to o's final rounding."""
    q, k, v, g, beta, s0 = map(torch.from_numpy, _delta_inputs(13, B=1, T=50, H=2))
    base = tdr.delta_rule_chunk(q, k, v, g, beta, s0, chunk_size=16)
    forced = tdr.delta_rule_chunk(q, k, v, g, beta, s0, chunk_size=16,
                                  compute_dtype=torch.float32)
    for a, b in zip(forced, base):
        assert torch.equal(a, b)
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    o16, s16 = tdr.delta_rule_chunk(qb, kb, vb, g, beta, s0, chunk_size=16,
                                    compute_dtype=torch.float32)
    o32, s32 = tdr.delta_rule_chunk(qb.float(), kb.float(), vb.float(), g, beta, s0,
                                    chunk_size=16)
    assert o16.dtype == torch.bfloat16 and s16.dtype == torch.float32
    assert torch.equal(s16, s32) and torch.equal(o16, o32.bfloat16())
    ob, sb = tdr.delta_rule_chunk(qb, kb, vb, g, beta, s0, chunk_size=16)
    assert err_ratio(ob.float(), o32) < 1e-2 and err_ratio(sb, s32) < 1e-2
    with pytest.raises(ValueError, match="compute_dtype"):
        tdr.delta_rule_chunk(q, k, v, g, beta, s0, compute_dtype=torch.float16)


def test_gated_delta_rule_without_l2norm_matches_jax():
    (jq, jk, jv, jg, jb, js0), (tq, tk, tv, tg, tb, ts0) = both(*_delta_inputs(14, T=20))
    kw = dict(chunk_size=8, recurrent_threshold=8, use_qk_l2norm=False, scale=0.1)
    jo, js = jdr.gated_delta_rule(jq, jk, jv, jg, jb, js0, **kw)
    to, ts = tdr.gated_delta_rule(tq, tk, tv, tg, tb, ts0, **kw)
    assert err_ratio(to, jo) < TOL and err_ratio(ts, js) < TOL


@pytest.mark.parametrize("window", [5, 64])
def test_swa_prefill_dense_segments_match_jax(window):
    """The stateless banded attention with packed segment ids (on the CPU
    its dense path on both sides), window below and above T."""
    rng = np.random.RandomState(13)
    B, T, Hq, Hkv, D = 2, 21, 4, 2, 8
    q, k, v = rnd(rng, B, T, Hq, D), rnd(rng, B, T, Hkv, D), rnd(rng, B, T, Hkv, D)
    seg = _segments(B, T)
    for s in (None, seg):
        want = jswa.swa_prefill_dense(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window,
            segment_ids=None if s is None else jnp.asarray(s))
        got = tswa.swa_prefill_dense(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), window,
            segment_ids=None if s is None else torch.from_numpy(s))
        assert err_ratio(got, want) < TOL
