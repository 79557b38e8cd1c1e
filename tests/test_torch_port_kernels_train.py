"""The plain versions and the gradients behind the training slice's kernel
wrappers, on the CPU in fp32 against the JAX package: H (stateless
sliding-window attention, values and gradients), F (ViT window attention,
against the Pallas kernel in interpret mode and its dense twin), and the
autograd wrappers of C, E and F, whose forward is the kernel and whose
backward differentiates the plain version. The CUDA kernels themselves are
held against the same plain versions on the card by chip_smoke.py.

Tolerances: values <= 1e-5, gradients <= 1e-4 (fp32, summation order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import err_ratio
from torch_port_helpers import jax_compile_cache  # noqa: F401 (autouse)

import infinitevl_tpu.ops.delta_rule as jdr
import infinitevl_tpu.ops.swa as jswa
import infinitevl_tpu.ops.vit_flash as jvit
import infinitevl_tpu_torch.ops.delta_kernels as tdk
import infinitevl_tpu_torch.ops.vit_kernels as tvk
from infinitevl_tpu_torch.ops.delta_rule import delta_rule_chunk
from infinitevl_tpu_torch.ops.swa import swa_prefill_reference
from infinitevl_tpu_torch.ops.swa_kernels import bwd_split_plan, swa_train_flash_attention
from infinitevl_tpu_torch.ops.vit_flash import (
    attention_segment_chunked,
    vit_window_attention,
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


@pytest.mark.parametrize("window,packed", [(7, False), (7, True), (64, True)])
def test_swa_train_plain_matches_jax_values_and_gradients(window, packed):
    """Kernel H's wrapper on CPU tensors (its plain version) against the JAX
    dense path: GQA 4/2, window below and above T, packed segments with a
    pad tail; dq, dk, dv against jax.grad."""
    rng = np.random.RandomState(window + packed)
    B, T, Hq, Hkv, D = 2, 29, 4, 2, 16
    q, k, v = rnd(rng, B, T, Hq, D), rnd(rng, B, T, Hkv, D), rnd(rng, B, T, Hkv, D)
    cot = rnd(rng, B, T, Hq, D)
    seg = None
    if packed:
        seg = np.ones((B, T), np.int32)
        seg[:, 11:20] = 2
        seg[:, 20:] = 3
        seg[1, 26:] = 0
    want, gwant = _jax_grads(
        lambda a, b, c: jswa.swa_prefill_dense(
            a, b, c, window, segment_ids=None if seg is None else jnp.asarray(seg)),
        (q, k, v), cot)
    got, ggot = _torch_grads(
        lambda a, b, c: swa_train_flash_attention(
            a, b, c, window, None, None if seg is None else torch.from_numpy(seg)),
        (q, k, v), cot)
    assert swa_train_flash_attention.launches == 0
    assert err_ratio(got, want) < 1e-5
    for name, a, b in zip("qkv", ggot, gwant):
        assert err_ratio(a, b) < 1e-4, f"d{name}"


@pytest.mark.parametrize("T, split", [(257, 8), (2048, 8), (4096, 4), (8192, 2)])
def test_swa_bwd_split_plan_at_3b(T, split):
    """H's bf16 dK/dV split at the 3B shape (GQA 16/2, D 128, B 1): the
    smallest split of the 8 query heads that gives two blocks per SM, and
    the fp32 partials [2 (dK, dV), split, B, T, Hkv, D]: 33.5 MB at T 2,048
    (8 splits) and at T 8,192 (2 splits)."""
    plan = bwd_split_plan(1, T, 16, 2)
    assert plan.split == split
    assert plan.partial_shape == (2, split, 1, T, 2, 128)
    assert plan.scratch_bytes == 4 * int(np.prod(plan.partial_shape))
    assert plan.scratch_bytes == (33554432 if T >= 2048 else 4210688)
    assert -(-T // 64) * 2 * split >= 2 * 132 or split == 8
    assert bwd_split_plan(4, 8192, 16, 2) == (1, (), 0)  # enough blocks without a split
    assert bwd_split_plan(1, 2048, 16, 2, target=0) == (1, (), 0)
    assert bwd_split_plan(1, 2048, 16, 2, target=10 ** 6).split == 8  # at most one head each


def test_swa_bwd_head_split_partials_add_up():
    """What the split dK/dV blocks compute: the gradient of K and V from
    the query heads of one group at a time. Added in the reduce pass's
    order (group 0, 1, ...), the partials give the full gradients."""
    rng = np.random.RandomState(3)
    B, T, Hq, Hkv, D, W = 1, 37, 8, 2, 16, 20
    q, k, v, cot = (torch.from_numpy(rnd(rng, B, T, h, D)) for h in (Hq, Hkv, Hkv, Hq))
    seg = torch.from_numpy(np.repeat(np.array([[1] * 20 + [2] * 15 + [0] * 2]), B, 0))

    def grads(c):
        kl, vl = k.clone().requires_grad_(True), v.clone().requires_grad_(True)
        out = swa_prefill_reference(q, kl, vl, W, 0, None, seg)
        return torch.autograd.grad(out, (kl, vl), c)

    full = grads(cot)
    G = Hq // Hkv
    for split in (2, 4):
        per = G // split
        acc = [torch.zeros_like(k), torch.zeros_like(v)]
        for s in range(split):
            keep = torch.zeros(Hq, dtype=torch.bool)
            for hk in range(Hkv):
                keep[hk * G + s * per: hk * G + (s + 1) * per] = True
            part = grads(cot * keep[None, None, :, None])
            acc = [a + p for a, p in zip(acc, part)]
        for a, f in zip(acc, full):
            assert err_ratio(a, f) < 1e-6


def _window_case(seed, S, L, H=2, D=80):
    rng = np.random.RandomState(seed)
    q, k, v = rnd(rng, S, H, D), rnd(rng, S, H, D), rnd(rng, S, H, D)
    wi = np.repeat(np.arange(S // L, dtype=np.int32), L)
    pad = np.zeros(S, bool)
    pad[rng.permutation(S)[: S // 10]] = True
    return q, k, v, np.where(pad, -2 - wi, wi).astype(np.int32)


@pytest.mark.parametrize("S,L", [(256, 64), (192, 32)])
def test_window_flash_plain_matches_pallas_and_reference(S, L):
    """Kernel F's plain version against the Pallas window kernel in
    interpret mode and the JAX batched-dense twin, pads (-2 - w) included."""
    q, k, v, seg = _window_case(S, S, L)
    jargs = tuple(map(jnp.asarray, (q, k, v, seg)))
    ref = jvit.window_attention_reference(*jargs, L)
    pallas = jvit.window_flash_attention(*jargs, L, block=2 * L, interpret=True)
    targs = tuple(map(torch.from_numpy, (q, k, v, seg)))
    out = tvk.window_flash_attention(*targs, L)
    assert tvk.window_flash_attention.launches == 0
    assert out.shape == (S, 2, 80) and bool(torch.isfinite(out).all())
    assert err_ratio(out, ref) < 1e-5 and err_ratio(out, pallas) < 1e-5
    assert torch.equal(vit_window_attention(*targs, L), out)
    # window attention is segment attention whose segments are the windows
    assert err_ratio(out, attention_segment_chunked(*targs)) < 1e-5
    with pytest.raises(ValueError, match="multiple of win_len"):
        tvk.window_flash_attention(*targs, L + 1)


def test_chunked_attention_checkpoints_each_chunk():
    """The differentiable twin of E: gradients equal the unchunked ones
    while only one chunk's scores are saved for the backward."""
    q, k, v, seg = _window_case(3, 96, 32, D=16)
    cot = rnd(np.random.RandomState(0), 96, 2, 16)
    tseg = torch.from_numpy(seg)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.numel()) or t,
                                                  lambda t: t):
        out, grads = _torch_grads(
            lambda a, b, c: attention_segment_chunked(a, b, c, tseg, block_q=24),
            (q, k, v), cot)
    _, whole = _torch_grads(
        lambda a, b, c: attention_segment_chunked(a, b, c, tseg, block_q=96), (q, k, v), cot)
    for a, b in zip(grads, whole):
        assert err_ratio(a, b) < 1e-5
    # no [H, block_q, S] score tensor (2 * 24 * 96 values) was kept by the forward
    assert max(saved) < 2 * 24 * 96


@pytest.mark.parametrize("kernel", ["E", "F"])
def test_vit_flash_autograd_matches_jax_grad(kernel, monkeypatch):
    """The autograd.Function of E and F with the launch replaced by the
    plain version (no card here): its backward equals jax.grad through the
    JAX dispatchers."""
    S, L = 128, 32
    q, k, v, seg = _window_case(5, S, L, D=80)
    cot = rnd(np.random.RandomState(1), S, 2, 80)
    if kernel == "E":
        seg = np.where(seg < 0, -1, seg // 2).astype(np.int32)
    tseg, jseg = torch.from_numpy(seg), jnp.asarray(seg)
    launched = []

    def fake_launch(name, q_, k_, v_, s_, scale, win_len):
        launched.append((name, win_len))
        if win_len:
            return window_attention_reference(q_, k_, v_, s_, win_len, scale)
        return attention_segment_chunked(q_, k_, v_, s_, scale)

    monkeypatch.setattr(tvk, "_launch", fake_launch)
    wrapper = tvk.window_flash_attention if kernel == "F" else tvk.segment_flash_attention
    before = wrapper.launches
    win = L if kernel == "F" else 0
    got, ggot = _torch_grads(
        lambda a, b, c: tvk._VitFlashFn.apply(a, b, c, tseg, None, win, wrapper),
        (q, k, v), cot)
    assert launched == [(wrapper.__name__, win)] and wrapper.launches == before + 1
    wrapper.launches = before
    if kernel == "F":
        jf = lambda a, b, c: jvit.vit_window_attention(a, b, c, jseg, L, interpret=True,
                                                       block=2 * L)
    else:
        jf = lambda a, b, c: jvit.vit_full_attention(a, b, c, jseg, use_pallas=False)
    want, gwant = _jax_grads(jf, (q, k, v), cot)
    assert err_ratio(got, want) < 1e-5
    for name, a, b in zip("qkv", ggot, gwant):
        assert err_ratio(a, b) < 1e-4, f"d{name}"


def test_delta_chunk_autograd_matches_jax_grad(monkeypatch):
    """C's autograd.Function with the launch replaced by the plain fp32
    chunk form: gradients of q, k, v, g, beta and the initial state equal
    jax.grad through the JAX chunk rule."""
    rng = np.random.RandomState(7)
    B, T, H, K, V = 1, 70, 2, 16, 32
    q, k, v = rnd(rng, B, T, H, K), rnd(rng, B, T, H, K), rnd(rng, B, T, H, V)
    g = (-2 * rng.uniform(size=(B, T, H))).astype(np.float32)
    beta = rng.uniform(size=(B, T, H)).astype(np.float32)
    s0 = rnd(rng, B, H, K, V, scale=0.3)
    cot = rnd(rng, B, T, H, V)

    def fake_launch(q_, k_, v_, g_, b_, s_, scale, chunk, out_state, segment_ids=None):
        assert out_state is None and segment_ids is None
        return delta_rule_chunk(q_, k_, v_, g_, b_, s_, scale, True, chunk,
                                compute_dtype=torch.float32)

    monkeypatch.setattr(tdk, "_launch_chunk", fake_launch)
    got, ggot = _torch_grads(
        lambda *a: tdk._DeltaChunkFn.apply(*a, None, 32)[0], (q, k, v, g, beta, s0), cot)
    want, gwant = _jax_grads(
        lambda *a: jdr.delta_rule_chunk(*a, chunk_size=32)[0], (q, k, v, g, beta, s0), cot)
    assert err_ratio(got, want) < 1e-5
    for name, a, b in zip(("q", "k", "v", "g", "beta", "s0"), ggot, gwant):
        assert err_ratio(a, b) < 1e-4, name
    # the final state carries a gradient too
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, g, beta, s0)]
    _, final = tdk._DeltaChunkFn.apply(*leaves, None, 32)
    (ds0,) = torch.autograd.grad(final.sum(), leaves[5])
    jds0 = jax.grad(lambda s: jdr.delta_rule_chunk(
        *map(jnp.asarray, (q, k, v, g, beta)), s, chunk_size=32)[1].sum())(jnp.asarray(s0))
    assert err_ratio(ds0, jds0) < 1e-4


def test_serving_paths_keep_out_of_autograd():
    """Under no_grad, and for tensors that need no gradient, the wrappers
    build no graph: what serving did before is unchanged."""
    q, k, v, seg = _window_case(9, 64, 32)
    targs = tuple(map(torch.from_numpy, (q, k, v, seg)))
    for out in (tvk.window_flash_attention(*targs, 32), tvk.segment_flash_attention(*targs)):
        assert not out.requires_grad and out.grad_fn is None
    ql = targs[0].clone().requires_grad_(True)
    with torch.no_grad():
        assert tvk.segment_flash_attention(ql, *targs[1:]).grad_fn is None
