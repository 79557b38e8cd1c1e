"""The preference stages rm, dpo and kto of the port against the JAX
package on the CPU in fp32 (the losses on numpy log-probs, the encoders
and collators and the refusals are in test_torch_port_pref_losses.py):
sequence log-probs (<= 1e-5; the chunked gather equal to the
unchunked one), one step of each stage from the same weights carried
across (loss and every trainable leaf <= 1e-4, JAX's optimizer with rope's
inv_freq masked out as the port leaves it frozen; the reference
bit-unchanged), the encoders and collators (arrays equal), and `run_exp`
on the tiny recipes."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_port_helpers import carry_train_state, err_ratio, jax_adam_state, to_port_config
from torch_port_helpers import jax_compile_cache  # noqa: F401 (autouse)

import infinitevl_tpu.train.dpo as jdpo
import infinitevl_tpu.train.step as jstep
import infinitevl_tpu_torch.hparams as thparams
import infinitevl_tpu_torch.train.dpo as tdpo
import infinitevl_tpu_torch.train.trainer as ttrainer
from infinitevl_tpu import tiny_config
from infinitevl_tpu.models.params import init_text_params
from infinitevl_tpu_torch.train.step import (
    full_finetune_leaf,
    make_optimizer,
    set_trainable,
    trainable_leaves,
    tree_leaves_with_path,
)
from infinitevl_tpu_torch.utils.checkpoint import latest_step

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = tiny_config(num_hidden_layers=4)  # SWA, then three DeltaNet layers
TCFG = to_port_config(JCFG)
B, T = 2, 24


def _args(mod, name, tmp_path=None, **over):
    args = mod.load_yaml_args(os.path.join(REPO, "examples", name))
    args.data.dataset_dir = os.path.join(REPO, "data")
    if tmp_path is not None:
        args.train.output_dir = str(tmp_path)
    for key, val in over.items():
        group = next(g for g in (args.model, args.data, args.train, args.finetune, args.gen)
                     if hasattr(g, key))
        setattr(group, key, val)
    return args


# ---------------------------------------------------------------- losses


# ---------------------------------------------------------------- model parts


@pytest.fixture(scope="module")
def weights():
    """The JAX text tree with a value head, and the port's copy."""
    jp = dict(init_text_params(jax.random.PRNGKey(0), JCFG.text, jnp.float32))
    jp["value_head"] = {"kernel": 0.02 * jax.random.normal(
        jax.random.PRNGKey(2), (JCFG.text.hidden_size, 1))}
    return jp


def _pairwise_batch(seed=0):
    """Right-padded chosen / rejected rows of unequal lengths, prompt masked."""
    rng = np.random.RandomState(seed)
    batch = {"position_ids": np.broadcast_to(np.arange(T)[None, None], (3, B, T)).copy()}
    for side, lengths in (("chosen", (24, 17)), ("rejected", (20, 22))):
        ids = np.zeros((B, T), np.int64)
        labels = np.full((B, T), -100, np.int64)
        for r, n in enumerate(lengths):
            ids[r, :n] = rng.randint(1, JCFG.text.vocab_size, n)
            labels[r, 6 : n - 1] = ids[r, 7:n]  # next-token targets after a prompt of 6
        batch[f"{side}_ids"], batch[f"{side}_labels"] = ids, labels
    return batch


def _kto_batch(seed=1):
    b = _pairwise_batch(seed)
    return {"input_ids": b["chosen_ids"], "labels": b["chosen_labels"],
            "position_ids": b["position_ids"], "is_desirable": np.array([True, False])}


def test_sequence_logprobs_match_jax_and_chunks(weights):
    b = _pairwise_batch()
    want = jdpo.sequence_logprobs(weights, JCFG.text, jnp.asarray(b["chosen_ids"]),
                                  jnp.asarray(b["chosen_labels"]),
                                  jnp.asarray(b["position_ids"]))
    tp, _ = carry_train_state(weights, trainable=False)
    args = [torch.from_numpy(b[k]) for k in ("chosen_ids", "chosen_labels", "position_ids")]
    whole = tdpo.sequence_logprobs(tp, TCFG.text, *args, chunk=T)
    assert err_ratio(whole, np.asarray(want)) <= 1e-5
    for chunk in (5, 8):  # a ragged last chunk, and chunks that divide T
        part = tdpo.sequence_logprobs(tp, TCFG.text, *args, chunk=chunk)
        torch.testing.assert_close(part, whole, rtol=1e-6, atol=0)
    # the gradients through the checkpointed chunks equal the unchunked ones
    tt, _ = carry_train_state(weights)
    leaves = [t for _, t in trainable_leaves(tt)]
    g_whole = torch.autograd.grad(tdpo.sequence_logprobs(tt, TCFG.text, *args, chunk=T).sum(),
                                  leaves, allow_unused=True)
    g_part = torch.autograd.grad(tdpo.sequence_logprobs(tt, TCFG.text, *args, chunk=5).sum(),
                                 leaves, allow_unused=True)
    for a, c in zip(g_part, g_whole):
        if c is not None:
            assert err_ratio(a, c) <= 1e-6


def _masked_tx(tree, lr):
    """JAX's optimizer with rope's inv_freq left out, as the port trains."""
    labels = jax.tree_util.tree_map_with_path(
        lambda path, _: "frozen" if jax.tree_util.keystr(path).endswith("['inv_freq']")
        else "train", tree)
    return optax.multi_transform(
        {"train": jstep.make_optimizer(lr), "frozen": optax.set_to_zero()}, labels)


def _jleaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _jleaves(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _jleaves(v, f"{prefix}/{i}" if prefix else str(i))
    elif tree is not None and not isinstance(tree, optax.MaskedNode):
        yield prefix, np.asarray(tree)


STEPS = {
    "rm": (lambda c, tx, **kw: jdpo.make_rm_step(c, tx),
           lambda c, tx, **kw: tdpo.make_rm_step(c, tx, **kw), _pairwise_batch),
    "dpo-sigmoid": (lambda c, tx, **kw: jdpo.make_dpo_step(c, tx, 0.1, "sigmoid"),
                    lambda c, tx, **kw: tdpo.make_dpo_step(c, tx, 0.1, "sigmoid", **kw),
                    _pairwise_batch),
    "dpo-simpo": (lambda c, tx, **kw: jdpo.make_dpo_step(c, tx, 0.1, "simpo"),
                  lambda c, tx, **kw: tdpo.make_dpo_step(c, tx, 0.1, "simpo", **kw),
                  _pairwise_batch),
    "kto": (lambda c, tx, **kw: jdpo.make_kto_step(c, tx, 0.1),
            lambda c, tx, **kw: tdpo.make_kto_step(c, tx, 0.1, **kw), _kto_batch),
}


def _step_weights(weights, kind):
    """(reference, policy) JAX trees of a stage: the policy moved away from
    the reference (inv_freq aside), so the log-ratios count."""
    jp = weights if kind == "rm" else {k: v for k, v in weights.items() if k != "value_head"}
    jpol = jp if kind == "rm" else jax.tree_util.tree_map_with_path(
        lambda path, x: x if jax.tree_util.keystr(path).endswith("['inv_freq']")
        else x * 1.01, jp)
    return jp, jpol


_JAX_STEPS = {}


def _jax_step(weights, kind):
    """JAX's step of a stage, once per stage: (loss, leaves after the step,
    Adam's first moments)."""
    if kind not in _JAX_STEPS:
        jmake, _, make_batch = STEPS[kind]
        jp, jpol = _step_weights(weights, kind)
        jtx = _masked_tx(jpol, 1e-3)
        jb = {k: jnp.asarray(v) for k, v in make_batch().items()}
        extra = () if kind == "rm" else (jp,)
        jnew, jstate, jloss = jax.jit(jmake(JCFG.text, jtx))(jpol, jtx.init(jpol), *extra, jb)
        _JAX_STEPS[kind] = (float(jloss), dict(_jleaves(jnew)),
                            dict(_jleaves(jax_adam_state(jstate).mu)))
    return _JAX_STEPS[kind]


@pytest.mark.parametrize("kind,remat", [
    ("rm", False), ("dpo-sigmoid", False), ("dpo-sigmoid", True), ("dpo-simpo", False),
    ("kto", False)])
def test_one_step_matches_jax(weights, kind, remat):
    """One optimizer step from the same weights and batch: the loss, each
    trainable leaf after the step and its first moment (the clipped
    gradient) within 1e-4; rope's inv_freq and the reference unchanged. A
    leaf that is zero before the step (a bias) holds the AdamW update alone,
    lr x g / (|g| + eps), which maps rounding noise in a vanishing gradient
    element to +-lr: it is held by its moment, not by its value."""
    _, tmake, make_batch = STEPS[kind]
    jp, jpol = _step_weights(weights, kind)
    batch = make_batch()
    jloss, want, mu = _jax_step(weights, kind)

    pol, _ = carry_train_state(jpol, trainable=False)
    set_trainable(pol, full_finetune_leaf)
    ref, _ = carry_train_state(jp, trainable=False)
    ref0 = {k: v.clone() for k, v in tree_leaves_with_path(ref)}
    before = {k: v.detach().clone() for k, v in tree_leaves_with_path(pol)}
    tx = make_optimizer(1e-3)
    state = tx.init(pol)
    step = tmake(TCFG.text, tx, remat=remat)
    if kind == "rm":
        _, _, loss = step(pol, state, dict(batch))
    else:
        _, _, loss = step(pol, state, ref, dict(batch))
    assert abs(float(loss) - jloss) <= 1e-4 * abs(jloss)
    assert all(torch.equal(v, ref0[k]) for k, v in tree_leaves_with_path(ref))
    assert torch.equal(pol["inv_freq"], before["inv_freq"])
    named = trainable_leaves(pol)
    assert len(named) == len(want) - 1 and "inv_freq" not in dict(named)
    for (path, v), m in zip(named, state["mu"]):
        assert err_ratio(m, mu[path]) <= 1e-4, path
        if before[path].abs().sum() > 0:
            assert err_ratio(v, want[path]) <= 1e-4, path
        assert not torch.equal(v, before[path]), path


# ---------------------------------------------------------------- data


# ---------------------------------------------------------------- workflows


@pytest.mark.parametrize("name,over", [
    ("rm_tiny.yaml", {}),
    ("dpo_tiny.yaml", {}),
    ("dpo_tiny.yaml", dict(pref_loss="orpo", remat=True)),
    ("kto_tiny.yaml", {}),
], ids=["rm", "dpo", "dpo-orpo-remat", "kto"])
def test_run_exp_preference_stage(tmp_path, name, over):
    """run_exp on the tiny recipes: finite losses in the log, a checkpoint,
    finite weights; rm's tree has its value head."""
    args = _args(thparams, name, tmp_path, **over)
    final = ttrainer.run_exp(args, device="cpu")
    recs = [json.loads(line) for line in open(tmp_path / "trainer_log.jsonl")]
    losses = [r["loss"] for r in recs if "loss" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))  # 4 rows, 2 a batch, 1 epoch
    assert latest_step(str(tmp_path / "checkpoints")) == 2
    assert ("value_head" in final) == (name == "rm_tiny.yaml")
    assert not final["inv_freq"].requires_grad
    assert all(torch.isfinite(t).all() for _, t in tree_leaves_with_path(final)
               if t.is_floating_point())


@pytest.mark.parametrize("loss_type,copies", [("sigmoid", 1), ("ipo", 1), ("simpo", 0),
                                              ("orpo", 0)])
def test_reference_is_a_frozen_copy_built_only_when_needed(tmp_path, monkeypatch, loss_type,
                                                           copies):
    made = []
    real = ttrainer.frozen_copy
    monkeypatch.setattr(ttrainer, "frozen_copy", lambda tree: made.append(real(tree)) or made[-1])
    args = _args(thparams, "dpo_tiny.yaml", tmp_path, pref_loss=loss_type, max_steps=1)
    policy = ttrainer.run_exp(args, device="cpu")
    assert len(made) == copies
    if copies:
        ref, pol = dict(tree_leaves_with_path(made[0])), dict(tree_leaves_with_path(policy))
        assert not any(t.requires_grad for t in ref.values())
        assert not (set(t.untyped_storage().data_ptr() for t in ref.values())
                    & set(t.untyped_storage().data_ptr() for t in pol.values()))
        moved = [k for k in pol if not torch.equal(pol[k], ref[k])]
        assert moved and "inv_freq" not in moved


