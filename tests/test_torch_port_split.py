"""Split-KV of kernel A1's bf16 path, on the CPU: the plan that splits the
key tiles over blocks (prefill_split_plan) at the 3B shapes, and the split-
and-combine written in plain torch exactly as the kernel combines its
partials, against the JAX Pallas kernel in interpret mode (D = 128, cap 512,
block_k 128, as tests/test_torch_port_kernels.py runs it).

Tolerance: values <= 1e-5 (fp32, summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import err_ratio
from torch_port_helpers import jax_compile_cache  # noqa: F401 (autouse)

from infinitevl_tpu.ops.swa_pallas import swa_ring_flash_attention as j_ring_prefill
from infinitevl_tpu_torch.ops.swa import swa_cached_attention_split
from infinitevl_tpu_torch.ops.swa_kernels import (
    KEY_TILE,
    PREFILL_ROWS,
    PREFILL_TARGET_BLOCKS,
    prefill_split_plan,
    swa_ring_flash_attention,
)

torch.set_num_threads(2)

SMS = 132  # streaming multiprocessors of an H100


@pytest.mark.parametrize("B, T", [(1, 257), (2, 257), (1, 100), (1, 2048), (1, 1000),
                                  (1, 1), (1, 8192)])
def test_prefill_split_plan_at_3b(B, T):
    """At the 3B shape (GQA 16/2, D 128, ring of 8,192): the smallest split
    that gives two blocks per SM, no more splits than key tiles, whole key
    tiles per split, and split 1 (no scratch) where the query tiles fill the
    card: a prefill chunk of 2,048. A frame of 257 tokens (66 query tiles
    of 64 rows) splits 4 ways."""
    Hq, Hkv, cap = 16, 2, 8192
    plan = prefill_split_plan(B, T, Hq, Hkv, cap)
    base = -(-T * (Hq // Hkv) // 64) * B * Hkv
    n_tiles = -(-cap // KEY_TILE) + -(-T // KEY_TILE)
    assert PREFILL_TARGET_BLOCKS == 2 * SMS and PREFILL_ROWS == 64
    assert 1 <= plan.split <= n_tiles
    assert base * plan.split >= 2 * SMS or plan.split == n_tiles
    assert plan.split == 1 or base * (plan.split - 1) < 2 * SMS  # the smallest
    assert plan.tiles_per_split * plan.split >= n_tiles
    assert plan.tiles_per_split * (plan.split - 1) < n_tiles
    if plan.split == 1:
        assert plan.partial_shape == () and plan.scratch_bytes == 0
    else:
        assert plan.partial_shape == (plan.split, B * Hkv * T * (Hq // Hkv), 128 + 4)
        assert plan.scratch_bytes == 4 * int(np.prod(plan.partial_shape))
    if (B, T) == (1, 2048):
        assert plan.split == 1
    if (B, T) == (1, 257):
        assert base == 66 and plan.split == 4


@pytest.fixture
def one_thread():
    """Runs the test on one intra-op thread. In some processes torch's CPU
    exp, split over two threads, returned the second thread's share at up
    to 1.5e-4 relative error (the first share, and one thread, at 6e-8),
    above the fp32 tolerance here, which is meant for summation order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cum", [0, 100, 511, 5000])
@pytest.mark.parametrize("split", [1, 2, 3, 4])
def test_split_and_combine_matches_pallas(split, cum, one_thread):
    """The plain split-and-combine of A1 (split s takes key tiles s, s +
    split, ...; fp32 partials m, l, acc; combined in the order s = 0, 1,
    ...) equals the JAX Pallas kernel in interpret mode for 1 to 4 splits.
    At cum_len 0 the ring is unwritten and the new keys are tile 8 (after
    the ring's 8): every split but split 8 % split holds ring tiles only, sees
    no key at all and must add nothing."""
    rng = np.random.RandomState(10 * cum + split)
    B, T, Hq, Hkv, D, W = 1, 37, 4, 2, 128, 512
    q = rng.standard_normal((B, T, Hq, D)).astype(np.float32)
    nk, nv = (rng.standard_normal((B, T, Hkv, D)).astype(np.float32) for _ in range(2))
    rk, rv = (rng.standard_normal((B, Hkv, W, D)).astype(np.float32) for _ in range(2))
    want = j_ring_prefill(*map(jnp.asarray, (q, nk, nv, rk, rv)), jnp.int32(cum), W,
                          block_k=128, interpret=True)
    t = tuple(map(torch.from_numpy, (q, nk, nv, rk, rv)))
    got = swa_cached_attention_split(*t, cum, W, split)
    assert err_ratio(got, want) < 1e-5
    assert torch.equal(t[3], torch.from_numpy(rk))  # the ring is read, not written
    # the wrapper on CPU tensors is the unsplit plain version: the same numbers
    assert err_ratio(swa_ring_flash_attention(*t, cum, W), got) < 1e-5
