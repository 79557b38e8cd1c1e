"""The port's repairs of its own faults, on the CPU against the JAX package:
packed rows through kernel C's wrapper (values and gradients of its autograd
function against jax.grad through the JAX chunk rule with segment ids), F's
backward through the checkpointed chunked twin (gradients against jax.grad
of the JAX window attention in interpret mode; no [nW, H, L, L] score tensor
kept), and int4 scale groups below a 64-row stage (the plain version of G
against JAX's dual-plane int4_matmul; the route the wrapper takes on a card).

Tolerances: values <= 1e-5, gradients <= 1e-4 (fp32, summation order)."""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import err_ratio
from torch_port_helpers import jax_compile_cache  # noqa: F401 (autouse)

import infinitevl_tpu.ops.delta_rule as jdr
import infinitevl_tpu.ops.vit_flash as jvit
import infinitevl_tpu_torch.ops.delta_kernels as tdk
import infinitevl_tpu_torch.ops.vit_kernels as tvk
from infinitevl_tpu.models.quant import int4_matmul as j_int4_matmul
from infinitevl_tpu.models.quant import quantize_kernel_int4 as j_quantize_int4
from infinitevl_tpu_torch.models.quant import quantize_kernel_int4
from infinitevl_tpu_torch.ops.delta_rule import delta_rule_chunk, gated_delta_rule
from infinitevl_tpu_torch.ops.int4_kernels import (
    ROUTES,
    _check_shapes,
    int4_matmul_fused,
    launch_plan,
    tile_kernel,
)
from infinitevl_tpu_torch.ops.vit_flash import (
    window_attention_chunked,
    window_attention_reference,
)

torch.set_num_threads(2)


def rnd(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _torch_grads(fn, arrays, cot):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = fn(*leaves)
    return out, torch.autograd.grad(out, leaves, torch.from_numpy(cot))


def _jax_grads(fn, arrays, cot):
    out, vjp = jax.vjp(fn, *map(jnp.asarray, arrays))
    return out, vjp(jnp.asarray(cot))


# ---------------------------------------------------------------- C, packed rows

# segment starts of one row of T = 70 under chunks of 32: a boundary inside a
# chunk, one exactly at a chunk edge (32: invisible to the masks within the
# chunk, so the incoming state is severed per chunk), three inside one chunk
SEGMENTS = {"mid_chunk": (20,), "chunk_edge": (32,), "several_in_chunk": (35, 40, 50)}


def _seg(starts, B=2, T=70):
    seg = np.ones((B, T), np.int32)
    for i, t in enumerate(starts):
        seg[:, t:] = i + 2
    seg[1, T - 3:] = 0  # row 1 ends in pads
    return seg


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("where", list(SEGMENTS))
def test_delta_chunk_packed_autograd_matches_jax_grad(where, with_state, monkeypatch):
    """C's autograd.Function on packed rows, the launch replaced by the plain
    fp32 chunk form with the same segment ids (no card here): output and the
    gradients of q, k, v, g, beta (and the initial state, which seeds the
    first segment only) equal jax.grad through the JAX chunk rule."""
    rng = np.random.RandomState(len(where) + with_state)
    B, T, H, K, V = 2, 70, 2, 16, 32
    q, k, v = rnd(rng, B, T, H, K), rnd(rng, B, T, H, K), rnd(rng, B, T, H, V)
    g = (-2 * rng.uniform(size=(B, T, H))).astype(np.float32)
    beta = rng.uniform(size=(B, T, H)).astype(np.float32)
    s0 = rnd(rng, B, H, K, V, scale=0.3)
    cot = rnd(rng, B, T, H, V)
    seg = _seg(SEGMENTS[where])
    tseg, jseg = torch.from_numpy(seg), jnp.asarray(seg)
    seen = []

    def fake_launch(q_, k_, v_, g_, b_, s_, scale, chunk, out_state, segment_ids=None):
        assert out_state is None
        seen.append(segment_ids)
        return delta_rule_chunk(q_, k_, v_, g_, b_, s_, scale, True, chunk,
                                segment_ids=segment_ids, compute_dtype=torch.float32)

    monkeypatch.setattr(tdk, "_launch_chunk", fake_launch)
    arrays = (q, k, v, g, beta) + ((s0,) if with_state else ())
    if with_state:
        tfn = lambda *a: tdk._DeltaChunkFn.apply(*a, None, 32, tseg)[0]
        jfn = lambda *a: jdr.delta_rule_chunk(*a, chunk_size=32, segment_ids=jseg)[0]
    else:
        tfn = lambda *a: tdk._DeltaChunkFn.apply(*a, None, None, 32, tseg)[0]
        jfn = lambda *a: jdr.delta_rule_chunk(*a, None, chunk_size=32, segment_ids=jseg)[0]
    got, ggot = _torch_grads(tfn, arrays, cot)
    want, gwant = _jax_grads(jfn, arrays, cot)
    assert len(seen) == 1 and torch.equal(seen[0], tseg)
    assert err_ratio(got, want) < 1e-5
    for name, a, b in zip(("q", "k", "v", "g", "beta", "s0"), ggot, gwant):
        assert err_ratio(a, b) < 1e-4, name


@pytest.mark.parametrize("where", list(SEGMENTS))
def test_delta_chunk_packed_wrapper_and_dispatch_match_jax(where):
    """On CPU tensors the wrapper and the dispatch take the plain packed
    chunk form (no launch): output and final state equal JAX's, and the
    first segment alone equals the row's start run with the initial state."""
    rng = np.random.RandomState(40 + len(where))
    B, T, H, K, V = 2, 70, 2, 128, 64
    q, k, v = rnd(rng, B, T, H, K), rnd(rng, B, T, H, K), rnd(rng, B, T, H, V)
    g = (-rng.uniform(size=(B, T, H))).astype(np.float32)
    beta = rng.uniform(size=(B, T, H)).astype(np.float32)
    s0 = rnd(rng, B, H, K, V, scale=0.3)
    seg = _seg(SEGMENTS[where])
    jo, js = jdr.delta_rule_chunk(*map(jnp.asarray, (q, k, v, g, beta, s0)),
                                  segment_ids=jnp.asarray(seg))
    t = tuple(map(torch.from_numpy, (q, k, v, g, beta, s0)))
    tseg = torch.from_numpy(seg)
    before = tdk.delta_rule_chunk_fused.launches
    o, s = tdk.delta_rule_chunk_fused(*t, segment_ids=tseg)
    o2, s2 = gated_delta_rule(*t, segment_ids=tseg)
    assert tdk.delta_rule_chunk_fused.launches == before
    assert err_ratio(o, jo) < 1e-5 and err_ratio(s, js) < 1e-5
    assert torch.equal(o, o2) and torch.equal(s, s2)
    first = SEGMENTS[where][0]
    alone, _ = delta_rule_chunk(*(x[:, :first] for x in t[:5]), t[5],
                                compute_dtype=torch.float32)
    assert err_ratio(o[:, :first], alone) < 1e-5


# ---------------------------------------------------------------- F's backward


def _window_case(seed, S, L, H=2, D=80):
    rng = np.random.RandomState(seed)
    q, k, v = rnd(rng, S, H, D), rnd(rng, S, H, D), rnd(rng, S, H, D)
    wi = np.repeat(np.arange(S // L, dtype=np.int32), L)
    pad = np.zeros(S, bool)
    pad[rng.permutation(S)[: S // 10]] = True
    return q, k, v, np.where(pad, -2 - wi, wi).astype(np.int32)


# budgets (fp32 score values of one checkpointed group) for S 256, L 32, H 2:
# two windows per group; less than one window (its queries chunked)
BUDGETS = {"groups_of_two_windows": 2 * 2 * 32 * 32, "query_chunks": 2 * 32 * 32 // 3}


@pytest.mark.parametrize("budget", list(BUDGETS))
def test_window_backward_through_chunked_twin_matches_jax_grad(budget, monkeypatch):
    """F's autograd.Function, the launch replaced by the plain version (no
    card here): its backward recomputes through window_attention_chunked,
    here with a budget that makes groups of two windows or chunks one
    window's queries; gradients equal jax.grad of the JAX window attention
    in interpret mode, values equal the batched-dense plain version."""
    S, L = 256, 32
    q, k, v, seg = _window_case(11, S, L)
    cot = rnd(np.random.RandomState(2), S, 2, 80)
    tseg, jseg = torch.from_numpy(seg), jnp.asarray(seg)
    calls = []

    def twin(*a, **kw):
        calls.append(a[4])
        return window_attention_chunked(*a, **kw, budget=BUDGETS[budget])

    monkeypatch.setattr(tvk, "window_attention_chunked", twin)
    monkeypatch.setattr(tvk, "_launch", lambda name, q_, k_, v_, s_, scale, win_len:
                        window_attention_reference(q_, k_, v_, s_, win_len, scale))
    before = tvk.window_flash_attention.launches
    got, ggot = _torch_grads(
        lambda a, b, c: tvk._VitFlashFn.apply(a, b, c, tseg, None, L,
                                              tvk.window_flash_attention), (q, k, v), cot)
    tvk.window_flash_attention.launches = before
    assert calls == [L]  # the backward went through the chunked twin
    want, gwant = _jax_grads(lambda a, b, c: jvit.vit_window_attention(
        a, b, c, jseg, L, interpret=True, block=2 * L), (q, k, v), cot)
    assert err_ratio(got, want) < 1e-5
    for name, a, b in zip("qkv", ggot, gwant):
        assert err_ratio(a, b) < 1e-4, f"d{name}"
    targs = tuple(map(torch.from_numpy, (q, k, v))) + (tseg,)
    assert err_ratio(window_attention_chunked(*targs, L, budget=BUDGETS[budget]),
                     window_attention_reference(*targs, L)) < 1e-5


@pytest.mark.parametrize("budget", list(BUDGETS))
def test_window_chunked_twin_keeps_no_window_scores(budget):
    """Under autograd the chunked twin checkpoints each group (and each
    query chunk), so the forward saves no [nW, H, L, L] score tensor (the
    batched-dense plain version saves its probabilities, nW H L L values);
    its gradients equal the plain version's."""
    S, L, H = 256, 32, 2
    q, k, v, seg = _window_case(12, S, L, D=16)
    cot = rnd(np.random.RandomState(3), S, H, 16)
    tseg = torch.from_numpy(seg)
    kept = {}
    for name, fn in (("chunked", functools.partial(window_attention_chunked,
                                                   budget=BUDGETS[budget])),
                     ("dense", window_attention_reference)):
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t.numel()) or t, lambda t: t):
            _, grads = _torch_grads(lambda a, b, c: fn(a, b, c, tseg, L), (q, k, v), cot)
        kept[name] = (max(saved), grads)
    scores = (S // L) * H * L * L
    assert kept["dense"][0] >= scores
    assert kept["chunked"][0] < scores // 4  # a group's inputs at most
    for a, b in zip(kept["chunked"][1], kept["dense"][1]):
        assert err_ratio(a, b) < 1e-5


# ---------------------------------------------------------------- G, groups


@pytest.mark.parametrize("group", [32, 64])
def test_int4_groups_below_a_stage_match_jax(group):
    """Scale groups of 32 and 64 input rows (16 / 32 / 64 rows per plane
    are what a bf16 64-row stage cuts into): the quantised integers and
    scales equal JAX's, G's plain version equals JAX's dual-plane int4
    matmul, and the route the wrapper takes on a card serves them (the bf16
    tile kernel folds per k-step below a stage, per stage at 64 rows)."""
    rng = np.random.RandomState(group)
    d_in, d_out = 256, 96
    w = rnd(rng, d_in, d_out, scale=0.05)
    jnode = j_quantize_int4(jnp.asarray(w), group)
    node = quantize_kernel_int4(torch.from_numpy(w), group)
    np.testing.assert_array_equal(node["kernel_q4"].numpy(), np.asarray(jnode["kernel_q4"]))
    np.testing.assert_array_equal(node["scale4"].numpy(), np.asarray(jnode["scale4"]))
    half, G = d_in // 2, d_in // group
    for M in (1, 9, 65):
        x = rnd(rng, M, d_in)
        want = j_int4_matmul(jnp.asarray(x), jnode)
        got = int4_matmul_fused(torch.from_numpy(x), node)
        assert err_ratio(got, want) < 1e-5, M
        # the wrapper's checks take the node, and a tile kernel serves it
        assert _check_shapes("int4_matmul_fused", torch.from_numpy(x), node["kernel_q4"],
                             node["scale4"]) == (half, d_out, G)
    assert tile_kernel(half, G, torch.bfloat16) == ("wgmma_kstep" if group < 64 else "wgmma")
    assert tile_kernel(half, G, torch.float32) == "fma"
    for M in (9, 257, 2048):
        tile_m, rpb, ks = launch_plan(M, half, d_out, torch.bfloat16)
        assert tile_m in (64, 128) and rpb % 64 == 0 and ks * rpb >= half


@pytest.mark.parametrize("d_in, group, route", [
    (2048, 32, "wgmma_kstep"), (2048, 64, "wgmma"), (2048, 128, "wgmma"),
    (3072, 48, "wgmma_kstep"), (2048, 8, "fma"), (3420, 90, "fma"), (3420, 128, "wgmma"),
])
def test_int4_tile_kernel_serves_every_group_quant_accepts(d_in, group, route):
    """Every group that models/quant.py accepts has a bf16 tile kernel: a
    multiple of 16 rows per plane folds on wgmma (per stage when it covers
    whole 64-row stages, else per 16-row k-step), anything else takes the
    FMA tiles; a group that does not divide d_in / 2 is one group (G = 1)."""
    node = quantize_kernel_int4(torch.zeros((d_in, 16)), group)
    G = node["scale4"].shape[0]
    assert G == (d_in // group if (d_in // 2) % group == 0 else 1)
    assert tile_kernel(d_in // 2, G, torch.bfloat16) == route


def test_int4_route_codes_match_the_c_entry():
    """The wrapper alone picks G's tile kernel and passes its code to the C
    entry: every route tile_kernel names has a code, and the codes are the
    ROUTE_* values csrc/int4_matmul.cu launches by."""
    import infinitevl_tpu_torch

    src = (Path(infinitevl_tpu_torch.__file__).parent / "csrc" / "int4_matmul.cu").read_text()
    m = re.search(r"enum \{ ROUTE_FMA = (\d+), ROUTE_WGMMA_STAGE = (\d+), "
                  r"ROUTE_WGMMA_KSTEP = (\d+) \}", src)
    assert m is not None
    assert tuple(map(int, m.groups())) == (ROUTES["fma"], ROUTES["wgmma"], ROUTES["wgmma_kstep"])
    named = {tile_kernel(half, G, dtype) for half, G in ((1024, 1), (1024, 64), (1024, 32),
                                                         (1024, 256))
             for dtype in (torch.float32, torch.bfloat16)}
    assert named == set(ROUTES)
