"""The port's training step against the JAX package on the CPU in fp32:
the distillation losses, the SFT loss with and without remat and its
gradients, and the optimizer (the cross entropies, segment layouts and
schedules are in test_torch_port_train_losses.py). Same numpy inputs on both sides; weights carried across by
from_jax_numpy (tests/torch_port_helpers.carry_train_state).

Tolerances: loss values and remat-against-plain <= 1e-6 (the same
arithmetic in another order of evaluation); against JAX <= 1e-4 (fp32
through 8 layers, summation order only); gradients <= 1e-4; optimizer
parameters and moments <= 1e-6 after five steps."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_port_helpers import (
    carry_train_state,
    err_ratio,
    jax_adam_state,
    to_port_config,
    tree_err,
)
from torch_port_helpers import jax_compile_cache  # noqa: F401 (autouse)

import infinitevl_tpu.train.step as jstep
import infinitevl_tpu_torch.train.step as tstep
from infinitevl_tpu.config import tiny_config
from infinitevl_tpu.models.infinitevl import get_rope_index as jrope_index
from infinitevl_tpu.models.params import init_params
from infinitevl_tpu_torch.train.step import tree_leaves_with_path

torch.set_num_threads(2)

CFG = tiny_config()
TCFG = to_port_config(CFG)
T = 24  # > recurrent_threshold 8: the chunk path, which takes segment ids


@pytest.fixture(scope="module")
def weights():
    jp = init_params(jax.random.PRNGKey(0), CFG, jnp.float32)
    tp, _ = carry_train_state(jp)
    return jp, tp


def _text_batch(seed=0, B=2, packed=True):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, CFG.text.vocab_size - 8, (B, T))
    labels = np.where(rng.uniform(size=(B, T)) < 0.6, ids, -100)
    seg = np.ones((B, T), np.int32)
    if packed == "tail":  # unpacked rows of unequal length, padded to T
        seg[0, 20:] = 0
        seg[1, 13:] = 0
        labels[seg == 0] = -100
    elif packed:
        seg[:, 9:17] = 2
        seg[:, 17:] = 3
        seg[1, 21:] = 0
    pos = np.zeros((B, T), np.int64)
    for r in range(B):
        start = 0
        for t in range(T):
            if t and seg[r, t] != seg[r, t - 1]:
                start = t
            pos[r, t] = t - start
    return dict(input_ids=ids, labels=labels,
                position_ids=np.broadcast_to(pos[None], (3, B, T)).copy(), segment_ids=seg)


# ---------------------------------------------------------------- losses


def test_distillation_losses_match_jax():
    rng = np.random.RandomState(2)
    s, t = (rng.standard_normal((2, 5, 30)).astype(np.float32) for _ in range(2))
    mask = rng.uniform(size=(2, 5)) < 0.7
    for m in (None, mask):
        want = jstep.kl_distill_loss(jnp.asarray(s), jnp.asarray(t), 2.0,
                                     None if m is None else jnp.asarray(m))
        got = tstep.kl_distill_loss(torch.from_numpy(s), torch.from_numpy(t), 2.0,
                                    None if m is None else torch.from_numpy(m))
        assert abs(float(got) - float(want)) < 1e-6
    want = jstep.layerwise_mse_loss([(jnp.asarray(s), jnp.asarray(t))] * 2)
    got = tstep.layerwise_mse_loss([(torch.from_numpy(s), torch.from_numpy(t))] * 2)
    assert abs(float(got) - float(want)) < 1e-6


# ---------------------------------------------------------------- SFT loss


def _torch_loss_and_grads(tp, batch, remat, remat_group=1):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = tstep.sft_loss_fn(tp["text"], TCFG.text, tb["input_ids"], tb["labels"],
                             tb["position_ids"], tb["segment_ids"], remat=remat,
                             remat_group=remat_group)
    named = list(tree_leaves_with_path(tp["text"]))
    grads = torch.autograd.grad(loss, [t for _, t in named], allow_unused=True)
    return float(loss), {p: g for (p, _), g in zip(named, grads)}


@pytest.mark.parametrize("packed", [True, False, "tail"])
def test_sft_loss_and_gradients_match_jax(weights, packed, monkeypatch):
    """Every leaf's gradient against jax.grad, with packed segment ids
    (short conv, chunk rule and SWA mask all masked), without, and with
    rows of unequal length padded at their tail (the DeltaNet rule then
    runs without the ids, JAX's with them); remat (per layer, and in groups
    of 3) changes nothing."""
    import infinitevl_tpu_torch.models.text as ttext

    jp, tp = weights
    batch = _text_batch(packed=packed)
    assert tstep.read_segment_layout(batch["segment_ids"]) == {
        True: "packed", False: "single", "tail": "tail_pad"}[packed]
    rule_saw_ids = []
    rule = ttext.gated_delta_rule
    monkeypatch.setattr(ttext, "gated_delta_rule", lambda *a, **kw: (
        rule_saw_ids.append(kw["segment_ids"] is not None), rule(*a, **kw))[1])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss = jax.jit(jax.value_and_grad(lambda p: jstep.sft_loss_fn(
        p, CFG.text, jb["input_ids"], jb["labels"], jb["position_ids"], jb["segment_ids"])))
    want, gwant = jloss(jp["text"])
    got, ggot = _torch_loss_and_grads(tp, batch, remat=False)
    assert rule_saw_ids and all(saw == (packed is True) for saw in rule_saw_ids)
    assert abs(got - float(want)) / float(want) < 1e-4
    gw = {p: np.asarray(g) for p, g in _jax_paths(gwant)}
    assert set(gw) == set(ggot)
    for path, g in ggot.items():
        if path == "inv_freq":  # not a weight: no gradient on either side
            continue
        assert err_ratio(g, gw[path]) < 1e-4, path
    if packed == "tail":  # id-0 positions are never supervised: a label there is ignored
        noisy = dict(batch, labels=np.where(batch["segment_ids"] == 0, 7, batch["labels"]))
        assert abs(_torch_loss_and_grads(tp, noisy, remat=False)[0] - got) < 1e-6
    for kw in (dict(remat=True), dict(remat=True, remat_group=3)):
        again, gagain = _torch_loss_and_grads(tp, batch, **kw)
        assert abs(again - got) < 1e-6, kw
        for path, g in ggot.items():
            if g is not None:
                assert err_ratio(gagain[path], g) < 1e-5, (kw, path)
    want_remat = jax.jit(lambda p: jstep.sft_loss_fn(
        p, CFG.text, jb["input_ids"], jb["labels"], jb["position_ids"], jb["segment_ids"],
        remat=True))(jp["text"])
    assert abs(again - float(want_remat)) / float(want_remat) < 1e-4


def _jax_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _jax_paths(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _jax_paths(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def test_mm_sft_loss_and_gradients_match_jax(weights):
    """One 1x4x4-patch image scattered into the prompt: the loss and the
    gradients of the ViT and the decoder leaves against jax.grad."""
    jp, tp = weights
    rng = np.random.RandomState(3)
    ids = np.concatenate([
        rng.randint(0, 400, 5), [CFG.vision_start_token_id], [CFG.image_token_id] * 4,
        [CFG.vision_end_token_id], rng.randint(0, 400, T - 11)])[None]
    labels = np.where(np.arange(T)[None] >= 12, ids, -100)
    grid = ((1, 4, 4),)
    px = rng.standard_normal((16, 3 * 2 * 14 * 14)).astype(np.float32)
    pos, _ = jrope_index(CFG, ids, np.asarray(grid))
    pos = np.asarray(pos)
    seg = np.ones((1, T), np.int32)
    seg[:, T - 3:] = 0  # three pads, as the multimodal collator marks them:
    labels[seg == 0] = -100  # id 0 and no label (the port never supervises a tail pad)
    want, gwant = jax.jit(jax.value_and_grad(lambda p: jstep.mm_sft_loss_fn(
        p, CFG, jnp.asarray(ids), jnp.asarray(labels), jnp.asarray(pos),
        pixel_values=jnp.asarray(px), grid_thw=grid, segment_ids=jnp.asarray(seg))))(jp)
    named = list(tree_leaves_with_path(tp))
    for remat in (False, True):
        loss = tstep.mm_sft_loss_fn(
            tp, TCFG, torch.from_numpy(ids), torch.from_numpy(labels),
            torch.from_numpy(pos), pixel_values=torch.from_numpy(px), grid_thw=grid,
            segment_ids=torch.from_numpy(seg), remat=remat)
        assert abs(float(loss) - float(want)) / float(want) < 1e-4
        grads = torch.autograd.grad(loss, [t for _, t in named], allow_unused=True)
        gw = {p: np.asarray(g) for p, g in _jax_paths(gwant)}
        for (path, _), g in zip(named, grads):
            if path.endswith("inv_freq"):
                continue
            assert err_ratio(g, gw[path]) < 1e-4, (remat, path)


# ---------------------------------------------------------------- optimizer


def _opt_tree(rng):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"text": {
        "embed": f(10, 4),
        "final_norm": f(4),
        "layers": [
            {"q_proj": {"kernel": f(4, 6), "bias": f(6)}, "input_norm": f(4),
             "A_log": f(3), "dt_bias": f(3), "conv_q_w": f(4, 6)},
            {"mlp": {"up": {"kernel": f(4, 8)}}, "o_norm": f(2, 2)},
        ],
    }}


@pytest.mark.parametrize("schedule,accumulate", [("cosine", 1), ("cosine", 2),
                                                 ("linear", 1), ("constant", 2)])
def test_make_optimizer_matches_optax(schedule, accumulate):
    """Five optimizer steps from carried-over params over a fixed gradient
    sequence: warm-up of 2 steps, the clip active on the large gradients
    and idle on the small ones, the no-decay mask (1-D leaves, norms,
    A_log, dt_bias), accumulation of k micro-batches as optax.MultiSteps."""
    rng = np.random.RandomState(4)
    params_np = _opt_tree(rng)
    steps = 5
    kw = dict(weight_decay=0.1, grad_clip=1.0, warmup_steps=2, total_steps=steps,
              schedule=schedule)
    jtx = jstep.make_optimizer(3e-2, **kw)
    if accumulate > 1:
        jtx = optax.MultiSteps(jtx, every_k_schedule=accumulate)
    jparams = jax.tree.map(jnp.asarray, params_np)
    jstate = jtx.init(jparams)
    tparams, _ = carry_train_state(jparams)
    ttx = tstep.make_optimizer(3e-2, accumulation_steps=accumulate, **kw)
    tstate = ttx.init(tparams)
    for i in range(steps * accumulate):
        scale = 5.0 if i % 3 == 0 else 0.02  # clip active / idle
        grads_np = jax.tree.map(
            lambda x: (rng.standard_normal(x.shape) * scale).astype(np.float32), params_np)
        updates, jstate = jtx.update(jax.tree.map(jnp.asarray, grads_np), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        gtree, _ = carry_train_state(grads_np, trainable=False)
        ttx.update([g for _, g in tree_leaves_with_path(gtree)], tstate, tparams)
    adam = jax_adam_state(jstate)
    assert tstate["count"] == int(adam.count) == steps
    assert tree_err(tparams, jparams) < 1e-6
    named = [p for p, _ in tree_leaves_with_path(tparams)]
    mu = dict(_jax_paths(adam.mu))
    nu = dict(_jax_paths(adam.nu))
    for path, m, n in zip(named, tstate["mu"], tstate["nu"]):
        assert err_ratio(m, mu[path]) < 1e-6 and err_ratio(n, nu[path]) < 1e-6, path


def test_frozen_leaves_stay_bit_equal_and_stateless_forward_writes_nothing(weights):
    """`freeze` semantics: only trainable leaves move; the training forward
    updates no tensor in place."""
    _, tp0 = weights
    tp = jax.tree.map(lambda t: t.detach().clone(), tp0)
    first = TCFG.text.num_hidden_layers - 2
    n = tstep.set_trainable(tp, lambda path, leaf: path.startswith("text/layers/")
                            and int(path.split("/")[2]) >= first)
    assert 0 < n < len(list(tree_leaves_with_path(tp)))
    before = {p: t.detach().clone() for p, t in tree_leaves_with_path(tp)}
    tx = tstep.make_optimizer(1e-2)
    state = tx.init(tp)
    step = tstep.make_sft_train_step(TCFG.text, tx)
    batch = _text_batch(seed=5)
    _, _, loss = step(tp, state, dict(batch))
    assert np.isfinite(float(loss)) and state["count"] == 1
    moved = {p for p, t in tree_leaves_with_path(tp) if not torch.equal(t, before[p])}
    trainable = {p for p, _ in tstep.trainable_leaves(tp)}
    assert moved and moved <= trainable
    assert all(int(p.split("/")[2]) >= first for p in moved)


@pytest.mark.parametrize("clip", [1e9, 0.05], ids=["clip-idle", "clip-active"])
def test_freeze_steps_against_jax(weights, clip):
    """Three `freeze` steps (last two layers trainable) against the JAX
    package's (`apply_trainable_mask` over the same optimizer). Frozen
    leaves get no gradient in the port, so its clip norm is taken over the
    trainable leaves; JAX differentiates every leaf and clips by the norm of
    all of them. With the clip idle the two agree (<= 2e-4 on the worst leaf
    after three Adam steps, which turn gradients equal to 1e-4 into updates
    of the learning rate's size). With the clip active the port equals JAX
    with the frozen leaves' gradients zeroed BEFORE the clip (<= 2e-4): that
    is the whole departure, and the unmodified JAX steps, which scale the
    gradients by another norm, end measurably elsewhere (> 1e-3)."""
    from infinitevl_tpu.train.distill import apply_trainable_mask

    jp, tp0 = weights
    jp = {"text": jp["text"]}
    n = CFG.text.num_hidden_layers
    first = n - 2
    mask = jax.tree.map(lambda _: False, jp)
    mask["text"]["layers"] = [jax.tree.map(lambda _, i=i: i >= first, lp)
                              for i, lp in enumerate(jp["text"]["layers"])]
    jtx = apply_trainable_mask(jstep.make_optimizer(1e-2, grad_clip=clip), mask)
    batches = [_text_batch(seed=10 + i, packed=False) for i in range(3)]

    # the gradients are the same in every variant: computed once, compiled once
    grad_fn = jax.jit(jax.value_and_grad(lambda p, jb: jstep.sft_loss_fn(
        p["text"], CFG.text, jb["input_ids"], jb["labels"], jb["position_ids"],
        jb["segment_ids"])))

    def jax_steps(zero_frozen_first):
        params, state, losses = jp, jtx.init(jp), []
        for b in batches:
            loss, grads = grad_fn(params, {k: jnp.asarray(v) for k, v in b.items()})
            if zero_frozen_first:
                grads = jax.tree.map(lambda g, m: g if m else jnp.zeros_like(g), grads, mask)
            updates, state = jtx.update(grads, state, params)
            params = optax.apply_updates(params, updates)
            losses.append(float(loss))
        return params, losses

    tp = {"text": jax.tree.map(lambda t: t.detach().clone(), tp0["text"])}
    tstep.set_trainable(tp, lambda path, leaf: path.startswith("text/layers/")
                        and int(path.split("/")[2]) >= first)
    ttx = tstep.make_optimizer(1e-2, grad_clip=clip)
    tstate = ttx.init(tp)
    tstep_fn = tstep.make_sft_train_step(TCFG.text, ttx)
    got = [float(tstep_fn(tp, tstate, dict(b))[2]) for b in batches]

    as_jax, jlosses = jax_steps(zero_frozen_first=False)
    if clip > 1:
        assert tree_err(tp, as_jax) < 2e-4
        assert np.allclose(got, jlosses, rtol=1e-4)
        return
    zeroed, zlosses = jax_steps(zero_frozen_first=True)
    assert tree_err(tp, zeroed) < 2e-4
    assert np.allclose(got, zlosses, rtol=1e-4)
    assert tree_err(tp, as_jax) > 1e-3  # the departure is real (3e-2 here), and it is this one
