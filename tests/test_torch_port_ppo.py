"""The PPO stage of the port against the JAX package on the CPU in fp32:
`response_mask` and `gae_advantages` on the same numpy inputs (<= 1e-6),
`token_logprobs_and_values` and the reward model's reward (<= 1e-5), and
two iterations of `ppo_train` at temperature 0 from the same weights with a
toy reward: the greedy rollout tokens identical, `PPOStats` and every
trainable leaf within 1e-4 (JAX's optimizer with rope's inv_freq masked
out, as the port leaves it frozen). JAX samples with its own random bits,
so at temperature 1 the port is held to itself: one seed, one set of
tokens, each of non-zero probability. Then `run_exp` and `cli train` on
examples/ppo_tiny.yaml with the rm stage's checkpoint."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from torch_port_helpers import carry_train_state, err_ratio, to_port_config
from torch_port_helpers import jax_compile_cache  # noqa: F401 (autouse)

import infinitevl_tpu.train.ppo as jppo
import infinitevl_tpu.train.step as jstep
import infinitevl_tpu_torch.cli as tcli
import infinitevl_tpu_torch.hparams as thparams
import infinitevl_tpu_torch.train.ppo as tppo
import infinitevl_tpu_torch.train.trainer as ttrainer
from infinitevl_tpu import tiny_config
from infinitevl_tpu.models.params import init_text_params
from infinitevl_tpu.models.text import embed_tokens as jembed
from infinitevl_tpu.models.text import text_forward as jtext_forward
from infinitevl_tpu_torch.train.step import full_finetune_leaf, set_trainable
from infinitevl_tpu_torch.train.step import tree_leaves_with_path
from infinitevl_tpu_torch.utils.checkpoint import latest_step

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = tiny_config(num_hidden_layers=4)  # SWA, then three DeltaNet layers
TCFG = to_port_config(JCFG)
B, T_P, R = 2, 12, 6  # a prompt longer than the recurrence's threshold: the chunked prefill


def _gae_inputs(seed):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, 8, (4, 10))
    toks[0, 3] = toks[1, 0] = toks[2, 9] = 7  # EOS early, first, last; row 3 never
    toks[0, 6] = 7  # a second EOS after the first
    rewards, values = (rng.standard_normal((4, 10)).astype(np.float32) for _ in range(2))
    return toks, rewards, values


@pytest.mark.parametrize("gamma,lam", [(1.0, 0.95), (0.9, 0.8)])
def test_response_mask_and_gae_match_jax(gamma, lam):
    toks, rewards, values = _gae_inputs(int(gamma * 10))
    jmask = jppo.response_mask(jnp.asarray(toks), 7)
    tmask = tppo.response_mask(torch.from_numpy(toks), 7)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert tmask[0].tolist() == [1, 1, 1, 1, 0, 0, 0, 0, 0, 0] and tmask[3].sum() == 10
    jadv, jret = jppo.gae_advantages(jnp.asarray(rewards), jnp.asarray(values), jmask,
                                     gamma, lam)
    tadv, tret = tppo.gae_advantages(torch.from_numpy(rewards), torch.from_numpy(values),
                                     tmask, gamma, lam)
    np.testing.assert_allclose(tadv.numpy(), np.asarray(jadv), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tret.numpy(), np.asarray(jret), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def weights():
    """A JAX policy (text tree + a random value head) and its prompts."""
    jp = dict(init_text_params(jax.random.PRNGKey(0), JCFG.text, jnp.float32))
    head = 0.02 * jax.random.normal(jax.random.PRNGKey(3), (JCFG.text.hidden_size, 1))
    prompts = np.random.RandomState(0).randint(0, JCFG.text.vocab_size - 8, (2, B, T_P))
    return jp, {"kernel": head}, prompts


def test_token_logprobs_values_and_reward_match_jax(weights):
    jp, head, prompts = weights
    full = np.concatenate([prompts[0], prompts[1][:, :R]], axis=1)
    jpol = dict(jp, value_head=head)
    jlogp, jval = jppo.token_logprobs_and_values(jpol, JCFG.text, jnp.asarray(full), T_P)
    tpol, _ = carry_train_state(jpol, trainable=False)
    tlogp, tval = tppo.token_logprobs_and_values(tpol, TCFG.text, torch.from_numpy(full), T_P)
    assert tlogp.shape == tval.shape == (B, R)
    assert err_ratio(tlogp, np.asarray(jlogp)) <= 1e-5
    assert err_ratio(tval, np.asarray(jval)) <= 1e-5
    _, none = tppo.token_logprobs_and_values(tpol, TCFG.text, torch.from_numpy(full), T_P,
                                             with_values=False)
    assert none is None
    # the reward model's reward: its value at the response's last real token
    mask = np.ones((B, R), np.float32)
    mask[1, 3:] = 0
    pos = jnp.broadcast_to(jnp.arange(full.shape[1])[None, None], (3,) + full.shape)
    hidden, _, _ = jtext_forward(jpol, JCFG.text, jembed(jpol, jnp.asarray(full)), pos, None)
    jvalues = np.asarray((hidden @ head["kernel"])[..., 0])
    want = jvalues[np.arange(B), [T_P + R - 1, T_P + 2]]
    got = tppo.rm_reward_fn(tpol, TCFG.text)(full, mask)
    assert err_ratio(got, want) <= 1e-5


def test_trainable_policy_and_frozen_copy_give_bit_equal_logprobs():
    """torch.matmul folds [B, R, D] @ [D, V] into one GEMM or runs it
    batched depending on the layout and on whether the weight requires grad,
    and the two round differently at this width; the head's operands are
    made contiguous so the two trees agree bit for bit (the first KL of PPO
    is 0, DPO's first loss is ln 2)."""
    import infinitevl_tpu_torch.train.dpo as tdpo
    from infinitevl_tpu_torch.models.params import init_text_params as tinit

    cfg = to_port_config(tiny_config(num_hidden_layers=2, hidden_size=256,
                                     vocab_size=1024)).text
    policy = tinit(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    set_trainable(policy, full_finetune_leaf)
    frozen = ttrainer.frozen_copy(policy)
    full = torch.from_numpy(np.random.RandomState(1).randint(0, 1000, (2, 40)))
    labels = torch.where(torch.arange(40) >= 4, full, -100)
    pos = torch.arange(40)[None, None].expand(3, 2, -1)
    with torch.no_grad():
        a, _ = tppo.token_logprobs_and_values(policy, cfg, full, 30)
        b, _ = tppo.token_logprobs_and_values(frozen, cfg, full, 30)
        assert torch.equal(a, b)
        a = tdpo.sequence_logprobs(policy, cfg, full, labels, pos, chunk=7)
        b = tdpo.sequence_logprobs(frozen, cfg, full, labels, pos, chunk=7)
        assert torch.equal(a, b)


def _toy_reward(full_ids, resp_mask):
    """Fraction of even token ids in the response."""
    resp = full_ids[:, full_ids.shape[1] - resp_mask.shape[1]:]
    return ((resp % 2 == 0) * resp_mask).sum(axis=1) / np.maximum(resp_mask.sum(axis=1), 1)


PPO_KW = dict(rollout_len=R, ppo_epochs=2, kl_coef=0.1, learning_rate=1e-3, max_steps=2,
              seed=0)


def test_ppo_train_at_temperature_0_matches_jax(weights, monkeypatch):
    jp, _, prompts = weights
    jpol = dict(jp, value_head={"kernel": jnp.zeros((JCFG.text.hidden_size, 1), jnp.float32)})
    # JAX's optimizer with rope's inv_freq left out (ppo_train builds it
    # from train/step.make_optimizer), and its rollout tokens recorded
    make_opt = jstep.make_optimizer
    labels = lambda tree: {k: "frozen" if k == "inv_freq" else "train" for k in tree}
    monkeypatch.setattr(jstep, "make_optimizer", lambda **kw: optax.multi_transform(
        {"train": make_opt(**kw), "frozen": optax.set_to_zero()}, labels))
    jtoks = []
    make_rollout = jppo.make_rollout

    def recording(*a, **kw):
        rollout = make_rollout(*a, **kw)
        return lambda *args: (lambda out: jtoks.append(np.asarray(out[0])) or out)(
            rollout(*args))

    monkeypatch.setattr(jppo, "make_rollout", recording)
    jnew, jstats = jppo.ppo_train(JCFG, jpol, jp, list(prompts), _toy_reward, temperature=0.0,
                                  **PPO_KW)

    ttoks = []
    rollout = tppo.make_rollout
    monkeypatch.setattr(tppo, "make_rollout", lambda *a, **kw: (
        lambda f: lambda *args: (lambda out: ttoks.append(out[0].numpy()) or out)(f(*args)))(
            rollout(*a, **kw)))
    policy, _ = carry_train_state(jpol, trainable=False)
    set_trainable(policy, full_finetune_leaf)
    ref, _ = carry_train_state(jp, trainable=False)
    ref0 = {k: v.clone() for k, v in tree_leaves_with_path(ref)}
    inv0 = policy["inv_freq"].clone()
    new, stats = tppo.ppo_train(TCFG, policy, ref, list(prompts), _toy_reward, temperature=0.0,
                                **PPO_KW)
    assert len(ttoks) == len(jtoks) == 2
    for a, b in zip(ttoks, jtoks):
        np.testing.assert_array_equal(a, b)
    # the policy starts as its reference: bit-equal log-probs, a KL of 0
    assert [s.step for s in stats] == [1, 2] and stats[0].kl == 0.0 and stats[1].kl != 0.0
    for s, w in zip(stats, jstats):
        assert s.mean_reward == pytest.approx(w.mean_reward, abs=1e-6)
        assert abs(s.loss - w.loss) <= 1e-4 * abs(w.loss)
        # the KL is a mean of differences of log-probs near -log(vocab) = -6.2,
        # whose fp32 rounding (~5e-7 each) sets its error's scale, not its size
        assert abs(s.kl - w.kl) <= 1e-5
    assert all(torch.equal(v, ref0[k]) for k, v in tree_leaves_with_path(ref))
    assert torch.equal(new["inv_freq"], inv0)
    want = dict(tree_leaves_with_path(carry_train_state(jnew, trainable=False)[0]))
    start = dict(tree_leaves_with_path(carry_train_state(jpol, trainable=False)[0]))
    for path, v in tree_leaves_with_path(new):
        if path != "inv_freq" and start[path].abs().sum() > 0:
            assert err_ratio(v, want[path]) <= 1e-4, path


def test_sampled_rollout_is_deterministic_and_every_token_possible(weights):
    jp, head, prompts = weights
    policy, _ = carry_train_state(dict(jp, value_head=head), trainable=False)
    rollout = tppo.make_rollout(TCFG, 16, temperature=1.0)
    ids = torch.from_numpy(prompts[0])

    def sample(seed):
        state = tppo.init_decoder_state(TCFG.text, B, dtype=torch.float32, device="cpu")
        toks, after = rollout({"text": policy}, ids, state, torch.Generator().manual_seed(seed))
        assert after["cum_len"] == T_P + 16
        return toks

    a, b, c = sample(5), sample(5), sample(6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    logp, _ = tppo.token_logprobs_and_values(policy, TCFG.text, torch.cat([ids, a], 1), T_P)
    assert torch.isfinite(logp).all()


def _yaml(tmp_path, name, **conf):
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(conf))
    return str(path)


def test_run_exp_and_cli_train_ppo_from_the_rm_checkpoint(tmp_path):
    def conf(name, **over):
        c = yaml.safe_load(open(os.path.join(REPO, "examples", name)))
        c.update(dataset_dir=os.path.join(REPO, "data"), **over)
        return c

    rm_out = tmp_path / "rm"
    ttrainer.run_exp(thparams.parse_args(conf("rm_tiny.yaml", output_dir=str(rm_out))),
                     device="cpu")
    assert latest_step(str(rm_out / "checkpoints")) == 2
    ppo = conf("ppo_tiny.yaml", output_dir=str(tmp_path / "ppo"), max_steps=2,
               reward_model_path=str(rm_out / "checkpoints"))
    policy, stats = ttrainer.run_exp(thparams.parse_args(ppo), device="cpu")
    assert len(stats) == 2 and stats[0].kl == 0.0
    assert all(np.isfinite([s.loss, s.kl, s.mean_reward]).all() for s in stats)
    assert "value_head" in policy and not policy["inv_freq"].requires_grad
    recs = [json.loads(line) for line in open(tmp_path / "ppo" / "trainer_log.jsonl")]
    assert [r["current_steps"] for r in recs] == [1, 2]
    assert all(np.isfinite([r["loss"], r["reward"], r["kl"]]).all() for r in recs)
    # the same recipe through the command line
    ppo["output_dir"] = str(tmp_path / "cli")
    _, again = tcli.cmd_train(_yaml(tmp_path, "ppo", **ppo), device="cpu")
    assert len(again) == 2 and again[0].kl == 0.0
    assert all(np.isfinite([s.loss, s.kl, s.mean_reward]).all() for s in again)


def test_ppo_without_a_reward_model_raises(tmp_path):
    args = thparams.parse_args(dict(config_preset="tiny", stage="ppo", dataset="demo",
                                    dataset_dir=os.path.join(REPO, "data"),
                                    output_dir=str(tmp_path), bf16=False))
    with pytest.raises(ValueError, match="reward"):
        ttrainer.run_exp(args, device="cpu")
