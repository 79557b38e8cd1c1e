"""The plain versions behind the port's five Hopper-kernel wrappers (A1
ring prefill, A2 stacked ring decode, B delta decode step, C chunked delta
rule, E ViT segment flash) against the JAX Pallas kernels they replace, run
in interpret mode on the CPU as tests/test_pallas_kernels.py runs them
(D = 128, cap = 512, block_k = 128; K = 128, V = 256, chunk 64).

On CPU tensors the wrappers take the plain version, so their launch
counters stay at 0; the CUDA kernels themselves are checked against the
same plain versions on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinitevl_tpu.ops.delta_pallas import delta_rule_chunk_fused as j_delta_chunk
from infinitevl_tpu.ops.delta_pallas import delta_step_fused_stacked as j_delta_step
from infinitevl_tpu.ops.vit_flash import attention_segment_chunked as j_segment_chunked
from infinitevl_tpu.ops.vit_flash import segment_flash_attention as j_segment_flash
from infinitevl_tpu.ops.swa_pallas import (
    swa_ring_flash_attention as j_ring_prefill,
    swa_ring_flash_decode_stacked as j_ring_decode,
)
from infinitevl_tpu_torch.ops import _build
from infinitevl_tpu_torch.ops.delta_kernels import (
    chunk_scratch_floats,
    delta_rule_chunk_fused,
    delta_step_fused_stacked,
)
from infinitevl_tpu_torch.ops.delta_rule import delta_rule_recurrent, gated_delta_rule
from infinitevl_tpu_torch.ops.vit_flash import attention_segment_chunked, vit_full_attention
from infinitevl_tpu_torch.ops.vit_kernels import segment_flash_attention
from infinitevl_tpu_torch.ops.swa_kernels import (
    swa_ring_flash_attention,
    swa_ring_flash_decode_stacked,
)

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = 1e-5  # fp32 on both sides: summation order only
WRAPPERS = (swa_ring_flash_attention, swa_ring_flash_decode_stacked,
            delta_step_fused_stacked, delta_rule_chunk_fused, segment_flash_attention)


def err_ratio(x, ref):
    x = np.asarray(x, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.abs(x - ref).mean() / (np.abs(ref).mean() + 1e-12)


def rnd(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture(autouse=True)
def no_launches():
    """Every test here runs on the CPU: no kernel may count a launch."""
    for w in WRAPPERS:
        w.launches = 0
    yield
    assert [w.launches for w in WRAPPERS] == [0] * len(WRAPPERS)


@pytest.mark.parametrize("cum", [0, 100, 511, 5000])
def test_ring_prefill_plain_matches_pallas(cum):
    rng = np.random.RandomState(cum)
    B, T, Hq, Hkv, D, W = 1, 37, 4, 2, 128, 512
    q, nk, nv = rnd(rng, B, T, Hq, D), rnd(rng, B, T, Hkv, D), rnd(rng, B, T, Hkv, D)
    rk, rv = rnd(rng, B, Hkv, W, D), rnd(rng, B, Hkv, W, D)
    ref = j_ring_prefill(*map(jnp.asarray, (q, nk, nv, rk, rv)), jnp.int32(cum), W,
                         block_k=128, interpret=True)
    trk, trv = torch.from_numpy(rk), torch.from_numpy(rv)
    out = swa_ring_flash_attention(torch.from_numpy(q), torch.from_numpy(nk),
                                   torch.from_numpy(nv), trk, trv, cum, W)
    assert err_ratio(out, ref) < TOL
    # the prefill kernel reads the ring and leaves it as it was
    np.testing.assert_array_equal(trk.numpy(), rk)


@pytest.mark.parametrize("cum", [0, 511, 512, 9001])
def test_ring_decode_plain_matches_pallas_per_layer(cum):
    rng = np.random.RandomState(cum + 1)
    S, B, Hq, Hkv, D, W = 3, 2, 4, 2, 128, 512
    q, nk, nv = rnd(rng, B, 1, Hq, D), rnd(rng, B, 1, Hkv, D), rnd(rng, B, 1, Hkv, D)
    rks, rvs = rnd(rng, S, B, Hkv, W, D), rnd(rng, S, B, Hkv, W, D)
    slot = cum % W
    for layer in range(S):
        ref, jrks, jrvs = j_ring_decode(*map(jnp.asarray, (q, nk, nv, rks, rvs)),
                                        layer, jnp.int32(cum), W, block_k=128,
                                        interpret=True)
        trks, trvs = torch.from_numpy(rks.copy()), torch.from_numpy(rvs.copy())
        out = swa_ring_flash_decode_stacked(torch.from_numpy(q), torch.from_numpy(nk),
                                            torch.from_numpy(nv), trks, trvs, layer,
                                            cum, W)
        assert err_ratio(out, ref) < TOL, layer
        # the written slot equals the Pallas write; everything else is untouched
        np.testing.assert_array_equal(trks.numpy(), np.asarray(jrks))
        np.testing.assert_array_equal(trvs.numpy(), np.asarray(jrvs))
        np.testing.assert_array_equal(trks[layer, :, :, slot].numpy(), nk[:, 0])
        keep = np.ones(trks.shape, bool)
        keep[layer, :, :, slot] = False
        np.testing.assert_array_equal(trks.numpy()[keep], rks[keep])


def test_delta_step_plain_matches_pallas_per_layer():
    rng = np.random.RandomState(11)
    L, B, H, K, V = 3, 2, 4, 16, 32
    q, k, v = rnd(rng, B, H, K), rnd(rng, B, H, K), rnd(rng, B, H, V)
    g = (-np.abs(rng.standard_normal((B, H))) * 0.2).astype(np.float32)
    beta = (1 / (1 + np.exp(-rng.standard_normal((B, H))))).astype(np.float32)
    stack = rnd(rng, L, B, H, K, V)
    for layer in range(L):
        o_ref, h_ref = j_delta_step(*map(jnp.asarray, (q, k, v, g, beta, stack)),
                                    layer, interpret=True)
        th = torch.from_numpy(stack.copy())
        o = delta_step_fused_stacked(*map(torch.from_numpy, (q, k, v, g, beta)), th, layer)
        assert err_ratio(o, o_ref) < TOL, layer
        assert err_ratio(th[layer], np.asarray(h_ref)[layer]) < TOL, layer
        others = [i for i in range(L) if i != layer]
        np.testing.assert_array_equal(th.numpy()[others], stack[others])


@pytest.mark.parametrize("T, with_state", [(100, True), (64, False), (130, True)])
def test_delta_chunk_plain_matches_pallas_and_recurrence(T, with_state):
    """Kernel C's plain version (the wrapper on CPU tensors) against the
    Pallas kernel in interpret mode and against the recurrence, at the
    kernel's K = 128, V = 256, chunk 64: ragged T, with and without an
    initial state."""
    rng = np.random.RandomState(T)
    B, H, K, V = 1, 2, 128, 256
    q, k, v = rnd(rng, B, T, H, K), rnd(rng, B, T, H, K), rnd(rng, B, T, H, V)
    g = (-3 * rng.uniform(size=(B, T, H))).astype(np.float32)
    beta = (1 / (1 + np.exp(-rng.standard_normal((B, T, H))))).astype(np.float32)
    s0 = rnd(rng, B, H, K, V) if with_state else None
    js0 = None if s0 is None else jnp.asarray(s0)
    ts0 = None if s0 is None else torch.from_numpy(s0)
    o_ref, s_ref = j_delta_chunk(*map(jnp.asarray, (q, k, v, g, beta)), js0,
                                 chunk_size=64, interpret=True)
    targs = tuple(map(torch.from_numpy, (q, k, v, g, beta)))
    o, s = delta_rule_chunk_fused(*targs, ts0)
    assert o.shape == (B, T, H, V) and s.shape == (B, H, K, V) and s.dtype == torch.float32
    assert err_ratio(o, o_ref) < TOL and err_ratio(s, s_ref) < TOL
    o_rec, s_rec = delta_rule_recurrent(*targs, ts0)
    assert err_ratio(o, o_rec) < TOL and err_ratio(s, s_rec) < TOL
    if ts0 is not None:  # the initial state is read, not written
        np.testing.assert_array_equal(ts0.numpy(), s0)
        # the model's call: the final state written over the initial one
        slab = ts0.clone()
        o2, s2 = delta_rule_chunk_fused(*targs, slab, out_state=slab)
        assert s2 is slab and torch.equal(slab, s) and torch.equal(o2, o)


def test_delta_chunk_wrapper_bf16_and_scratch_size():
    """bf16 inputs: fp32 arithmetic on the widened values, o back in bf16."""
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rnd(rng, 1, 70, 2, 128)).bfloat16() for _ in range(3))
    g = torch.from_numpy((-rng.uniform(size=(1, 70, 2))).astype(np.float32))
    beta = torch.from_numpy(rng.uniform(size=(1, 70, 2)).astype(np.float32))
    o, s = delta_rule_chunk_fused(q, k, v, g, beta)
    o32, s32 = delta_rule_chunk_fused(q.float(), k.float(), v.float(), g, beta)
    assert o.dtype == torch.bfloat16 and torch.equal(o, o32.bfloat16())
    assert torch.equal(s, s32)
    # per (b, h, chunk): three [128, 64] tiles, one [64, 64], u [64, V], one scalar
    assert chunk_scratch_floats(1, 257, 16, 256) == 16 * 5 * (3 * 8192 + 4096 + 64 * 256 + 1)


@pytest.mark.parametrize("S", [300, 512])
def test_segment_flash_plain_matches_pallas(S):
    """Kernel E's plain version against the Pallas kernel in interpret mode
    and the JAX chunked twin: three segments with pads (-1) scattered over
    them, ragged S, head dim 80."""
    rng = np.random.RandomState(S)
    H, D = 2, 80
    q, k, v = rnd(rng, S, H, D), rnd(rng, S, H, D), rnd(rng, S, H, D)
    seg = np.zeros(S, np.int32)
    seg[S * 2 // 5: S * 3 // 4] = 1
    seg[S * 3 // 4:] = 2
    seg[rng.permutation(S)[: S // 20]] = -1
    jargs = tuple(map(jnp.asarray, (q, k, v, seg)))
    ref = j_segment_flash(*jargs, block_q=128, block_k=128, interpret=True)
    targs = tuple(map(torch.from_numpy, (q, k, v, seg)))
    out = segment_flash_attention(*targs)
    assert out.shape == (S, H, D) and bool(torch.isfinite(out).all())
    # the Pallas wrapper pads a ragged S with zero keys of segment -1, which
    # the pad rows then see: real rows are compared with it, every row with
    # the JAX chunked twin (pad rows are dropped by the caller either way)
    real = seg >= 0
    assert err_ratio(out.numpy()[real], np.asarray(ref)[real]) < TOL
    if S % 128 == 0:
        assert err_ratio(out, ref) < TOL
    assert err_ratio(out, j_segment_chunked(*jargs)) < TOL
    # query chunking changes nothing, and the model's entry is the wrapper
    assert err_ratio(attention_segment_chunked(*targs, block_q=77), out) < 1e-6
    assert torch.equal(vit_full_attention(*targs), out)
    # a real token never sees a pad or another segment: moving those keys
    # leaves segment 1's rows as they were
    k2 = torch.from_numpy(k).clone()
    k2[torch.from_numpy(seg != 1)] += 5.0
    out2 = segment_flash_attention(targs[0], k2, targs[2], targs[3])
    assert torch.equal(out2[torch.from_numpy(seg == 1)], out[torch.from_numpy(seg == 1)])


def test_wrappers_refuse_devices_other_than_cpu_and_cuda():
    """No silent fallback: a tensor that is neither on the CPU nor on a CUDA
    card raises instead of taking the plain version."""
    q = torch.empty((1, 2, 4, 128), device="meta")
    kv = torch.empty((1, 2, 2, 128), device="meta")
    ring = torch.empty((1, 2, 512, 128), device="meta")
    with pytest.raises(ValueError, match="neither cpu nor cuda"):
        swa_ring_flash_attention(q, kv, kv, ring, ring, 0, 512)
    with pytest.raises(ValueError, match="neither cpu nor cuda"):
        swa_ring_flash_decode_stacked(q[:, :1], kv[:, :1], kv[:, :1], ring[None],
                                      ring[None], 0, 0, 512)
    h = torch.empty((1, 1, 4, 16, 32), device="meta")
    x = torch.empty((1, 4, 16), device="meta")
    with pytest.raises(ValueError, match="neither cpu nor cuda"):
        delta_step_fused_stacked(x, x, torch.empty((1, 4, 32), device="meta"),
                                 x[..., 0], x[..., 0], h, 0)
    qc = torch.empty((1, 70, 2, 128), device="meta")
    with pytest.raises(ValueError, match="neither cpu nor cuda"):
        delta_rule_chunk_fused(qc, qc, torch.empty((1, 70, 2, 256), device="meta"),
                               qc[..., 0], qc[..., 0])
    # off the CPU the chunk form is the kernel, which normalizes q and k inside
    with pytest.raises(NotImplementedError, match="use_qk_l2norm=False"):
        gated_delta_rule(qc, qc, torch.empty((1, 70, 2, 256), device="meta"),
                         qc[..., 0], qc[..., 0], use_qk_l2norm=False)
    qe = torch.empty((300, 2, 80), device="meta")
    with pytest.raises(ValueError, match="neither cpu nor cuda"):
        segment_flash_attention(qe, qe, qe, torch.empty((300,), dtype=torch.int32,
                                                        device="meta"))


def test_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the kernels cannot be built, and loading says so."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    # the library name follows the sources: stable across calls
    assert _build.library_path() == _build.library_path()
    assert _build.library_path().parent == _build.BUILD_DIR
