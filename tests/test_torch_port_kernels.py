"""The plain versions behind the port's three Hopper-kernel wrappers (A1
ring prefill, A2 stacked ring decode, B delta decode step) against the JAX
Pallas kernels they replace, run in interpret mode on the CPU as
tests/test_pallas_kernels.py runs them (D = 128, cap = 512, block_k = 128).

On CPU tensors the wrappers take the plain version, so their launch
counters stay at 0; the CUDA kernels themselves are checked against the
same plain versions on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinitevl_tpu.ops.delta_pallas import delta_step_fused_stacked as j_delta_step
from infinitevl_tpu.ops.swa_pallas import (
    swa_ring_flash_attention as j_ring_prefill,
    swa_ring_flash_decode_stacked as j_ring_decode,
)
from infinitevl_tpu_torch.ops import _build
from infinitevl_tpu_torch.ops.delta_kernels import delta_step_fused_stacked
from infinitevl_tpu_torch.ops.swa_kernels import (
    swa_ring_flash_attention,
    swa_ring_flash_decode_stacked,
)

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = 1e-5  # fp32 on both sides: summation order only
WRAPPERS = (swa_ring_flash_attention, swa_ring_flash_decode_stacked,
            delta_step_fused_stacked)


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
    assert [w.launches for w in WRAPPERS] == [0, 0, 0]


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


def test_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the kernels cannot be built, and loading says so."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    # the library name follows the sources: stable across calls
    assert _build.library_path() == _build.library_path()
    assert _build.library_path().parent == _build.BUILD_DIR
