"""The training losses' pieces against the JAX package on the CPU in fp32:
the cross entropy and the fused linear cross entropy (values and
gradients), the segment layouts the collators' ids give, and the
learning-rate schedules' values against optax's."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_port_helpers import err_ratio
from torch_port_helpers import jax_compile_cache  # noqa: F401 (autouse)

import infinitevl_tpu.train.step as jstep
import infinitevl_tpu_torch.train.step as tstep

torch.set_num_threads(2)


def test_cross_entropy_loss_matches_jax():
    rng = np.random.RandomState(0)
    logits = rng.standard_normal((2, 7, 50)).astype(np.float32)
    labels = rng.randint(0, 50, (2, 7))
    labels[0, :3] = -100
    want, gwant = jax.value_and_grad(jstep.cross_entropy_loss)(
        jnp.asarray(logits), jnp.asarray(labels))
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = tstep.cross_entropy_loss(lt, torch.from_numpy(labels))
    (ggot,) = torch.autograd.grad(got, lt)
    assert abs(float(got) - float(want)) < 1e-6
    assert err_ratio(ggot, gwant) < 1e-5
    # no supervised position: zero, not NaN
    none = tstep.cross_entropy_loss(lt, torch.full((2, 7), -100))
    assert float(none) == 0.0


@pytest.mark.parametrize("tied", [False, True])
def test_fused_linear_cross_entropy_matches_jax(tied):
    """T = 21 is no multiple of the chunk of 8; the tied layout is [V, D]."""
    rng = np.random.RandomState(1)
    B, Tn, D, V = 2, 21, 12, 40
    h = rng.standard_normal((B, Tn, D)).astype(np.float32)
    w = (rng.standard_normal((V, D) if tied else (D, V)) * 0.3).astype(np.float32)
    labels = rng.randint(0, V, (B, Tn))
    labels[1, 5:11] = -100
    jf = lambda hh, ww: jstep.fused_linear_cross_entropy(
        hh, ww, jnp.asarray(labels), chunk=8, w_is_vd=tied)
    want, (gh, gw) = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    ht, wt = (torch.from_numpy(x).requires_grad_(True) for x in (h, w))
    got = tstep.fused_linear_cross_entropy(ht, wt, torch.from_numpy(labels), chunk=8,
                                           w_is_vd=tied)
    th, tw = torch.autograd.grad(got, (ht, wt))
    assert abs(float(got) - float(want)) < 1e-6
    assert err_ratio(th, gh) < 1e-5 and err_ratio(tw, gw) < 1e-5
    # equal to the unchunked loss
    logits = ht @ (wt.T if tied else wt)
    assert abs(float(tstep.cross_entropy_loss(logits, torch.from_numpy(labels)))
               - float(got)) < 1e-6


@pytest.mark.parametrize("rows,want", [
    ([[1, 1, 1, 1], [1, 1, 1, 1]], "single"),
    ([[1, 1, 1, 1], [0, 0, 0, 0]], "single"),  # a batch short of rows: one id per row
    ([[1, 1, 1, 0], [1, 1, 1, 1]], "tail_pad"),
    ([[1, 0, 0, 0], [0, 0, 0, 0]], "tail_pad"),
    ([[3, 3, 0, 0], [1, 1, 1, 0]], "tail_pad"),
    ([[1, 1, 2, 2], [1, 1, 1, 1]], "packed"),
    ([[1, 2, 0, 0], [1, 1, 0, 0]], "packed"),
    ([[1, 0, 1, 1], [1, 1, 1, 1]], "packed"),  # a pad inside the row
    ([[0, 0, 1, 1], [1, 1, 1, 1]], "packed"),  # pads in front
])
def test_read_segment_layout(rows, want):
    seg = np.asarray(rows, np.int32)
    assert tstep.read_segment_layout(seg) == want
    assert tstep.read_segment_layout(torch.from_numpy(seg)) == want
    # the steps read it from the host batch, before the ids go to the device
    out = tstep.batch_to_device({"segment_ids": seg, "_n_tokens": np.int64(3)}, "cpu")
    assert out["segment_layout"] == want and torch.equal(
        out["segment_ids"], torch.from_numpy(seg))


def test_schedule_values_match_optax():
    for schedule, warm, total in (("cosine", 3, 11), ("cosine", 0, 7), ("linear", 2, 9),
                                  ("linear", 0, 5)):
        lr = tstep.make_schedule(2e-3, warm, total, schedule)
        if schedule == "cosine":
            ref = optax.warmup_cosine_decay_schedule(0.0, 2e-3, warm, total)
        else:
            ref = optax.join_schedules(
                [optax.linear_schedule(0.0, 2e-3, max(warm, 1)),
                 optax.linear_schedule(2e-3, 0.0, max(total - warm, 1))], [warm])
        for count in range(total + 3):
            assert abs(lr(count) - float(ref(count))) < 1e-9, (schedule, warm, count)
    assert tstep.make_schedule(1e-3, 4, None, "cosine")(2) == 1e-3
