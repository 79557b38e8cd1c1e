"""The plain versions behind the port's seven Hopper-kernel wrappers (A1
ring prefill, A2 stacked ring decode, D ring decode on one unstacked ring, B
delta decode step, C chunked delta rule, E ViT segment flash, G fused int4
unpack-matmul) against the JAX Pallas kernels they replace, run in
interpret mode on the CPU as tests/test_pallas_kernels.py runs them
(D = 128, cap = 512, block_k = 128; K = 128, V = 256, chunk 64; int4 widths
that are multiples of 128).

On CPU tensors the wrappers take the plain version, so their launch
counters stay at 0; the CUDA kernels themselves are checked against the
same plain versions on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import jax_compile_cache  # noqa: F401 (autouse)

from infinitevl_tpu.models.quant import int4_matmul as j_int4_matmul
from infinitevl_tpu.models.quant import quantize_kernel_int4 as j_quantize_int4
from infinitevl_tpu.ops.delta_pallas import delta_rule_chunk_fused as j_delta_chunk
from infinitevl_tpu.ops.delta_pallas import delta_step_fused_stacked as j_delta_step
from infinitevl_tpu.ops.vit_flash import attention_segment_chunked as j_segment_chunked
from infinitevl_tpu.ops.vit_flash import segment_flash_attention as j_segment_flash
from infinitevl_tpu.ops.int4_pallas import int4_matmul_fused as j_int4_fused
from infinitevl_tpu.ops.swa_pallas import (
    swa_ring_flash_attention as j_ring_prefill,
    swa_ring_flash_decode as j_ring_decode_one,
    swa_ring_flash_decode_stacked as j_ring_decode,
)
from infinitevl_tpu_torch.models.quant import int4_matmul
from infinitevl_tpu_torch.ops import _build
from infinitevl_tpu_torch.ops.delta_kernels import (
    chunk_scratch_bytes,
    delta_chunk_passes,
    delta_rule_chunk_fused,
    delta_step_fused_stacked,
)
from infinitevl_tpu_torch.ops.delta_rule import delta_rule_recurrent, gated_delta_rule
from infinitevl_tpu_torch.ops.int4_kernels import (
    int4_matmul_fused,
    int4_matmul_plain,
    launch_plan,
)
from infinitevl_tpu_torch.ops.vit_flash import attention_segment_chunked, vit_full_attention
from infinitevl_tpu_torch.ops.vit_kernels import segment_flash_attention
from infinitevl_tpu_torch.ops.swa_kernels import (
    swa_ring_decode_plain,
    swa_ring_flash_attention,
    swa_ring_flash_decode,
    swa_ring_flash_decode_stacked,
)

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = 1e-5  # fp32 on both sides: summation order only
WRAPPERS = (swa_ring_flash_attention, swa_ring_flash_decode_stacked,
            delta_step_fused_stacked, delta_rule_chunk_fused, segment_flash_attention,
            int4_matmul_fused, swa_ring_flash_decode)


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


@pytest.mark.parametrize("cum", [0, 511, 512, 9001])
def test_ring_decode_unstacked_plain_matches_pallas(cum):
    """Kernel D's plain version (the wrapper on CPU tensors) against the
    Pallas kernel on one unstacked ring in interpret mode: output and the
    ring after the write."""
    rng = np.random.RandomState(cum + 7)
    B, Hq, Hkv, D, W = 2, 4, 2, 128, 512
    q, nk, nv = rnd(rng, B, 1, Hq, D), rnd(rng, B, 1, Hkv, D), rnd(rng, B, 1, Hkv, D)
    rk, rv = rnd(rng, B, Hkv, W, D), rnd(rng, B, Hkv, W, D)
    ref, jrk, jrv = j_ring_decode_one(*map(jnp.asarray, (q, nk, nv, rk, rv)),
                                      jnp.int32(cum), W, block_k=128, interpret=True)
    trk, trv = torch.from_numpy(rk.copy()), torch.from_numpy(rv.copy())
    targs = tuple(map(torch.from_numpy, (q, nk, nv)))
    out = swa_ring_flash_decode(*targs, trk, trv, cum, W)
    assert err_ratio(out, ref) < TOL
    np.testing.assert_array_equal(trk.numpy(), np.asarray(jrk))
    np.testing.assert_array_equal(trv.numpy(), np.asarray(jrv))
    # the named plain version is what the wrapper took, and the stacked
    # wrapper on a stack of one layer gives the same
    prk, prv = torch.from_numpy(rk.copy()), torch.from_numpy(rv.copy())
    assert torch.equal(swa_ring_decode_plain(*targs, prk, prv, cum, W), out)
    assert torch.equal(prk, trk)
    srk, srv = torch.from_numpy(rk.copy())[None], torch.from_numpy(rv.copy())[None]
    assert torch.equal(swa_ring_flash_decode_stacked(*targs, srk, srv, 0, cum, W), out)
    assert torch.equal(srk[0], trk) and torch.equal(srv[0], trv)


@pytest.mark.parametrize("d_in, d_out, group, lead", [
    (256, 128, 64, (5,)),       # grouped, G = 4
    (256, 256, 128, (1,)),      # grouped, G = 2, M = 1 (decode)
    (512, 128, 1 << 20, (3,)),  # per-column scales, G = 1
    (256, 128, 32, (2, 3)),     # leading dims, G = 8
])
def test_int4_matmul_plain_matches_pallas_and_dual_plane(d_in, d_out, group, lead):
    """Kernel G's plain version (the wrapper on CPU tensors) against the
    Pallas kernel in interpret mode and against both packages' dual-plane
    int4_matmul, on weights quantised by the JAX package (fp32 <= 1e-5)."""
    rng = np.random.RandomState(d_in + d_out + len(lead))
    w, x = rnd(rng, d_in, d_out, scale=0.05), rnd(rng, *lead, d_in)
    jnode = j_quantize_int4(jnp.asarray(w), group)
    tnode = {k: torch.from_numpy(np.asarray(v)) for k, v in jnode.items()}
    assert tnode["scale4"].shape[0] == (1 if group > d_in else d_in // group)
    ref = j_int4_fused(jnp.asarray(x), jnode, interpret=True)
    out = int4_matmul_fused(torch.from_numpy(x), tnode)
    assert out.shape == (*lead, d_out) and out.dtype == torch.float32
    assert err_ratio(out, ref) < TOL
    assert torch.equal(int4_matmul_plain(torch.from_numpy(x), tnode), out)
    assert err_ratio(out, j_int4_matmul(jnp.asarray(x), jnode)) < TOL
    assert err_ratio(int4_matmul(torch.from_numpy(x), tnode), out) < TOL
    # the rekeyed storage of prefer_fused_int4 is the same node
    fnode = {"kernel_q4f": tnode["kernel_q4"], "scale4": tnode["scale4"]}
    assert torch.equal(int4_matmul_fused(torch.from_numpy(x), fnode), out)


def test_int4_matmul_ragged_widths_bf16_and_checks():
    """Widths the Pallas kernel refuses (no multiple of 128: the ViT MLP's
    3420 at a small size) against the dual-plane form; bf16 inputs: fp32
    arithmetic on the widened values and one cast; the wrapper's checks."""
    from infinitevl_tpu_torch.models.quant import quantize_kernel_int4

    rng = np.random.RandomState(5)
    w = torch.from_numpy(rnd(rng, 60, 36, scale=0.05))  # half 30: one group
    x = torch.from_numpy(rnd(rng, 4, 60))
    node = quantize_kernel_int4(w, 16)
    assert node["scale4"].shape == (1, 36) and node["kernel_q4"].shape == (30, 36)
    assert err_ratio(int4_matmul_fused(x, node), int4_matmul(x, node)) < TOL
    xb = x.bfloat16()
    ob = int4_matmul_fused(xb, node)
    assert ob.dtype == torch.bfloat16
    assert torch.equal(ob, int4_matmul_fused(xb.float(), node).bfloat16())
    # a strided view (columns of a wider projection) is read where it lies
    wide = torch.from_numpy(rnd(rng, 4, 100))
    assert torch.equal(int4_matmul_fused(wide[:, 20:80], node),
                       int4_matmul_fused(wide[:, 20:80].contiguous(), node))
    with pytest.raises(ValueError, match="d_in"):
        int4_matmul_fused(x[:, :58], node)
    with pytest.raises(ValueError, match="kernel_q4"):
        int4_matmul_fused(x, {"kernel_q": node["kernel_q4"], "scale4": node["scale4"]})
    with pytest.raises(TypeError, match="uint8"):
        int4_matmul_fused(x, {"kernel_q4": node["kernel_q4"].to(torch.int8),
                              "scale4": node["scale4"]})
    with pytest.raises(ValueError, match="neither cpu nor cuda"):
        int4_matmul_fused(torch.empty((4, 60), device="meta"), node)
    # the launch plan: (tile_m, rows per block, row splits) covers all rows
    for M, half, cols in ((1, 1024, 2048), (8, 5504, 2048), (257, 1024, 11008),
                          (32, 1024, 2048), (1, 1710, 1280), (1, 16, 8)):
        for dtype in (torch.bfloat16, torch.float32):
            tile_m, rpb, ks = launch_plan(M, half, cols, dtype)
            assert (tile_m == 0) == (M <= 8) and rpb % 32 == 0
            assert ks * rpb >= half > (ks - 1) * rpb
            assert tile_m or rpb <= 512


def _plan_before_wgmma(M, half, d_out):
    """The fp32 / small-M plan as it was before the bf16 wgmma path: the
    fp32 path keeps it."""
    small = M <= 8
    if small:
        blocks, lo, hi = -(-d_out // 128), 64, 512
    else:
        blocks, lo, hi = -(-d_out // 64) * -(-M // 64), 128, half
    ks = max(1, min(-(-264 // blocks), -(-half // lo)))
    rpb = min(max(-(-half // ks), lo), max(hi, lo))
    rpb = -(-rpb // 32) * 32
    return (0 if small else 64), rpb, -(-half // rpb)


@pytest.mark.parametrize("M", [1, 8, 9, 64, 65, 128, 257, 1024, 2048])
def test_int4_launch_plan_per_dtype(M):
    """Kernel G's plan at the 3B widths: bf16 takes 64-row wgmma tiles up
    to M 64 and 128-row tiles above, in whole 64-row stages, and splits the
    packed rows only where its 128-column tiles leave the 132 SMs short;
    fp32 and M <= 8 keep the earlier plan; every packed row is covered once."""
    for d_in, d_out in ((2048, 11008), (11008, 2048), (2048, 256), (2048, 12320),
                        (1280, 3420), (3420, 1280)):
        half = d_in // 2
        f32 = launch_plan(M, half, d_out, torch.float32)
        assert f32 == _plan_before_wgmma(M, half, d_out)
        tile_m, rpb, ks = launch_plan(M, half, d_out, torch.bfloat16)
        assert ks * rpb >= half > (ks - 1) * rpb
        if M <= 8:
            assert (tile_m, rpb, ks) == f32
            continue
        assert tile_m == (64 if M <= 64 else 128) and rpb % 64 == 0
        blocks = -(-d_out // 128) * -(-M // tile_m)
        if blocks >= 132:
            assert ks == 1
        else:  # split, in ranges of at least two stages
            assert ks > 1 or half < 2 * 128
            assert rpb >= 128


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_delta_step_plain_matches_pallas_per_layer(dtype):
    """Kernel B's plain version against the Pallas kernel in interpret mode,
    layer by layer of the stack, with q, k, v in the layer's dtype (g and
    beta fp32, as the model computes them). bf16: both sides round
    l2norm(q) and l2norm(k) to bf16 and o at the end; o is held to 1e-3 (a
    bf16 ulp where the fp32 summation order flips a rounding), the fp32
    state to TOL."""
    rng = np.random.RandomState(11)
    L, B, H, K, V = 3, 2, 4, 16, 32
    q, k, v = rnd(rng, B, H, K), rnd(rng, B, H, K), rnd(rng, B, H, V)
    g = (-np.abs(rng.standard_normal((B, H))) * 0.2).astype(np.float32)
    beta = (1 / (1 + np.exp(-rng.standard_normal((B, H))))).astype(np.float32)
    stack = rnd(rng, L, B, H, K, V)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    o_tol = TOL if dtype == "float32" else 1e-3
    for layer in range(L):
        o_ref, h_ref = j_delta_step(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                    *map(jnp.asarray, (g, beta, stack)), layer, interpret=True)
        th = torch.from_numpy(stack.copy())
        o = delta_step_fused_stacked(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                                     *map(torch.from_numpy, (g, beta)), th, layer)
        assert o.dtype == tdt and o_ref.dtype == jdt
        assert err_ratio(o.float(), jnp.asarray(o_ref, jnp.float32)) < o_tol, layer
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
    """bf16 inputs: the JAX model path's precision (the twin of the kernel's
    bf16 passes), o in bf16 and the final state fp32, within bf16 rounding
    of the fp32 arithmetic on the widened values; the initial state is read,
    and written only where out_state says."""
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rnd(rng, 1, 70, 2, 128)).bfloat16() for _ in range(3))
    g = torch.from_numpy((-rng.uniform(size=(1, 70, 2))).astype(np.float32))
    beta = torch.from_numpy(rng.uniform(size=(1, 70, 2)).astype(np.float32))
    s0 = torch.from_numpy(rnd(rng, 1, 2, 128, 128, scale=0.1))
    o, s = delta_rule_chunk_fused(q, k, v, g, beta, s0)
    o_tw, s_tw = delta_chunk_passes(q, k, v, g, beta, s0)
    assert o.dtype == torch.bfloat16 and s.dtype == torch.float32
    assert torch.equal(o, o_tw) and torch.equal(s, s_tw)
    o32, s32 = delta_rule_chunk_fused(q.float(), k.float(), v.float(), g, beta, s0)
    assert err_ratio(o.float(), o32) < 1e-2 and err_ratio(s, s32) < 1e-2
    slab = s0.clone()
    o2, s2 = delta_rule_chunk_fused(q, k, v, g, beta, slab, out_state=slab)
    assert s2 is slab and torch.equal(slab, s) and torch.equal(o2, o)
    # per (b, h, chunk): three [64, 128] tiles, one [64, 64], u [64, V], two
    # fp32 scalars (the carry e^{g_C} and the flag of a segment starting at
    # the edge); fp32 throughout for fp32 inputs, the tiles in bf16 for bf16
    tiles = 3 * 8192 + 4096 + 64 * 256
    assert chunk_scratch_bytes(1, 257, 16, 256, torch.float32) == 4 * 16 * 5 * (tiles + 2)
    assert chunk_scratch_bytes(1, 257, 16, 256, torch.bfloat16) == 16 * 5 * (2 * tiles + 8)


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
    with pytest.raises(ValueError, match="neither cpu nor cuda"):
        swa_ring_flash_decode(q[:, :1], kv[:, :1], kv[:, :1], ring, ring, 0, 512)


def test_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the kernels cannot be built, and loading says so."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    # the library name follows the sources: stable across calls
    assert _build.library_path() == _build.library_path()
    assert _build.library_path().parent == _build.BUILD_DIR
