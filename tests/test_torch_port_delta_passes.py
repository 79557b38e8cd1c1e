"""The plain twin of kernel C's passes (ops/delta_kernels.delta_chunk_passes:
pass 1 with (I + A)^-1 formed in fp32 and w, u from it rounded, the scan
reading the state rounded, the output pass over the stored per-chunk states)
against the JAX package's chunk form, and the scan's value-tile plan.

bf16 inputs: against the JAX model path's delta_rule_chunk on bf16 inputs
(bf16 operands, fp32 accumulation) to 1e-3, as
test_delta_rule_chunk_bf16_matches_jax holds the port's plain chunk form:
the two differ only in (I + A)^-1 (JAX's Newton-Schulz in bf16, the
twin's exact inverse rounded) and in fp32 summation order. fp32 inputs:
against delta_rule_chunk and the Pallas kernel in interpret mode (which has
no segment ids) to 1e-5. Shapes: the kernel's K 128, V 256, chunk 64; T
ragged, one chunk and several chunks; packed ids with a boundary inside a
chunk and one on a chunk edge."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import infinitevl_tpu.ops.delta_rule as jdr
from infinitevl_tpu.ops.delta_pallas import delta_rule_chunk_fused as j_delta_chunk
from infinitevl_tpu_torch.ops import delta_kernels as dk
from infinitevl_tpu_torch.ops.delta_rule import delta_rule_chunk
from torch_port_helpers import err_ratio
from torch_port_helpers import jax_compile_cache  # noqa: F401 (autouse)

torch.set_num_threads(2)

TOL = 1e-5  # fp32 on both sides: summation order only
BF16_TOL = 1e-3  # a bf16 ulp where the fp32 summation order flips a rounding
B, H, K, V = 2, 2, 128, 256


def _inputs(T, with_state, packed, seed):
    rng = np.random.RandomState(seed)
    q, k = (rng.standard_normal((B, T, H, K)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((B, T, H, V)).astype(np.float32)
    g = (-3 * rng.uniform(size=(B, T, H))).astype(np.float32)
    beta = (1 / (1 + np.exp(-rng.standard_normal((B, T, H))))).astype(np.float32)
    s0 = (rng.standard_normal((B, H, K, V)) * 0.5).astype(np.float32) if with_state else None
    seg = None
    if packed:
        # row 0: a boundary inside the first chunk and one on the chunk edge
        # 128; row 1: one sequence, then a pad tail starting inside a chunk
        seg = np.ones((B, T), np.int32)
        for t, sid in ((T // 3, 2), (128, 3)):
            if t < T:
                seg[0, t:] = sid
        seg[1, T - T // 5:] = 0
    return q, k, v, g, beta, s0, seg


def _jax(q, k, v, g, beta, s0, seg, dtype):
    cast = (lambda x: jnp.asarray(x, jnp.bfloat16)) if dtype == torch.bfloat16 else jnp.asarray
    return jdr.delta_rule_chunk(*map(cast, (q, k, v)), jnp.asarray(g), jnp.asarray(beta),
                                None if s0 is None else jnp.asarray(s0),
                                segment_ids=None if seg is None else jnp.asarray(seg))


def _torch(x, dtype=torch.float32):
    return None if x is None else torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("T", [100, 64, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_delta_chunk_passes_match_jax(dtype, T, with_state, packed):
    q, k, v, g, beta, s0, seg = _inputs(T, with_state, packed, seed=T + 7 * with_state)
    args = (*(_torch(x, dtype) for x in (q, k, v)), _torch(g), _torch(beta), _torch(s0))
    tseg = None if seg is None else torch.from_numpy(seg)
    o, s = dk.delta_chunk_passes(*args, segment_ids=tseg)
    assert o.shape == (B, T, H, V) and o.dtype == dtype
    assert s.shape == (B, H, K, V) and s.dtype == torch.float32
    jo, js = _jax(q, k, v, g, beta, s0, seg, dtype)
    tol = BF16_TOL if dtype == torch.bfloat16 else TOL
    assert err_ratio(o.float(), np.asarray(jo, np.float32)) < tol
    assert err_ratio(s, js) < tol
    if dtype == torch.float32:
        if seg is None:  # the Pallas kernel, in interpret mode
            po, ps = j_delta_chunk(*map(jnp.asarray, (q, k, v, g, beta)),
                                   None if s0 is None else jnp.asarray(s0),
                                   chunk_size=64, interpret=True)
            assert err_ratio(o, po) < TOL and err_ratio(s, ps) < TOL
        ro, rs = delta_rule_chunk(*args, segment_ids=tseg, compute_dtype=torch.float32)
        assert err_ratio(o, ro) < TOL and err_ratio(s, rs) < TOL
    # the wrapper's CPU path is the twin for bf16 inputs
    wo, ws = dk.delta_rule_chunk_fused(*args, segment_ids=tseg)
    if dtype == torch.bfloat16:
        assert torch.equal(wo, o) and torch.equal(ws, s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_delta_chunk_passes_rounding_points(dtype):
    """The scan's state reads are the fp32 state rounded (the first is the
    initial state's), y is rounded, and o is the output pass over the
    stored states and y: q e^g S_n + tril(q k^T) y_n."""
    T = 130
    q, k, v, g, beta, s0, _ = _inputs(T, True, False, seed=5)
    qt, kt, vt = (_torch(x, dtype) for x in (q, k, v))
    s0t = _torch(s0)
    rnd = ((lambda x: x) if dtype == torch.float32
           else (lambda x: x.to(dtype).float()))
    kn = dk.l2norm(kt).float()
    qn = rnd(dk.l2norm(qt).float() * K**-0.5)
    N = -(-T // 64)

    def chunked(x):
        x = dk._pad_chunks(x, N * 64 - T)
        return x.reshape(B, N, 64, H, *x.shape[3:]).movedim(3, 1)

    parts = dk._chunk_prep(*map(chunked, (qn, kn, vt.float(), _torch(g), _torch(beta))),
                           None, rnd)
    for x in parts[:5]:  # every stored operand is representable in the dtype
        assert torch.equal(rnd(x), x)
    w, u, qb, attn, k_out, bend = parts
    assert torch.equal(attn, torch.tril(attn))
    states, ys, final = dk._chunk_scan(w, u, k_out, bend, None, s0t, rnd)
    assert torch.equal(states[:, :, 0], rnd(s0t))
    assert torch.equal(rnd(ys), ys)
    o = (qb @ states + attn @ ys).reshape(B, H, N * 64, V)[:, :, :T].transpose(1, 2)
    want_o, want_s = dk.delta_chunk_passes(qt, kt, vt, _torch(g), _torch(beta), s0t)
    assert torch.equal(o.to(dtype), want_o) and torch.equal(final, want_s)


def test_delta_chunk_cpu_gradient_is_the_plain_fp32_backward():
    """bf16 on the CPU with a gradient: the forward is the twin, the
    backward the plain fp32 chunk form's, as on the card."""
    T = 80
    q, k, v, g, beta, _, _ = _inputs(T, False, False, seed=9)
    leaves = [_torch(x, torch.bfloat16).requires_grad_(True) for x in (q, k, v)]
    leaves += [_torch(x).requires_grad_(True) for x in (g, beta)]
    o, _ = dk.delta_rule_chunk_fused(*leaves)
    assert torch.equal(o.detach(), dk.delta_chunk_passes(*(x.detach() for x in leaves))[0])
    cot = torch.from_numpy(np.random.RandomState(1).standard_normal(o.shape)
                           .astype(np.float32)).to(torch.bfloat16)
    got = torch.autograd.grad(o, leaves, cot)
    plain = [x.detach().requires_grad_(True) for x in leaves]
    ref_o, _ = delta_rule_chunk(*plain, compute_dtype=torch.float32)
    want = torch.autograd.grad(ref_o, plain, cot)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B_, H_, V_, sms, want", [
    (1, 16, 256, 132, 32),   # the 3B DeltaNet layer at B 1: 128 blocks
    (2, 16, 256, 132, 64),   # 128 blocks of the widest tile
    (4, 16, 256, 132, 64),
    (1, 4, 256, 132, 16),    # nothing fills the card: the narrowest tile
    (4, 16, 96, 132, 32),    # 64 does not divide V
    (1, 16, 256, 78, 64),    # a smaller card: 64 blocks fill 3/4 of it
])
def test_scan_v_tile(B_, H_, V_, sms, want):
    """The widest tile whose blocks still fill SCAN_FILL of the SMs, among
    the tiles that divide V; the narrowest dividing tile where none does."""
    bv = dk.scan_v_tile(B_, H_, V_, sms)
    assert bv == want and V_ % bv == 0
    wider = [t for t in dk.SCAN_V_TILES if t > bv and V_ % t == 0]
    assert all(B_ * H_ * (V_ // t) < dk.SCAN_FILL * sms for t in wider)


def test_scan_v_tile_refuses_a_value_dim_it_cannot_tile():
    with pytest.raises(ValueError, match="no multiple"):
        dk.scan_v_tile(1, 16, 40, 132)
