"""PPO stage: rollout, GAE, clipped policy + value losses, KL penalty
(torch port of infinitevl_tpu/train/ppo.py).

Functional re-design of the reference's TRL-based PPO trainer
(src/llamafactory/train/ppo/trainer.py: get_inputs/get_rewards rollout,
KL-penalized rewards, clipped surrogate + value losses):
- the rollout prefills the prompt batch into a fresh fp32 decoder state,
  then takes `rollout_len` decode steps, sampling on the device from an
  explicit `torch.Generator` (temperature 0: greedy argmax). It runs under
  no_grad on a state of its own and never writes the policy's tensors.
- prompts are bucketed by exact token length, so a batch has no pads.
- the scoring pass recomputes the policy's and the reference's log-probs
  and the values over prompt + response in one stateless forward each;
  GAE and the clipped update run on the frozen rollout stats for
  `ppo_epochs` gradient steps, which update the policy IN PLACE.

PPO runs in fp32 whatever `bf16` says, as the JAX package does. The
reference is a frozen copy of the initial policy (train/trainer.frozen_copy),
and rope's inv_freq stays frozen (train/step.full_finetune_leaf): both
departures from JAX, whose trees are immutable and which trains every leaf."""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import TextConfig
from ..device import Device, resolve_device
from ..generation import decode_step, prefill, sample_token
from ..models.state import init_decoder_state
from ..models.text import embed_tokens, lm_head, text_forward
from .step import AdamW, apply_gradients, make_optimizer, tree_device

Params = Dict[str, Any]


# ---------------------------------------------------------------- prompts


def encode_prompts(
    examples,
    tokenizer,
    template="qwen2_vl",
    cutoff_len: int = 1024,
) -> List[np.ndarray]:
    """Prompt-only encoding: drop trailing assistant turns, render with the
    generation prompt (the reference PPO workflow reuses the SFT dataset's
    prompt half, train/ppo/workflow.py)."""
    from ..data.template import get_template

    if isinstance(template, str):
        template = get_template(template)
    out = []
    for ex in examples:
        msgs = list(ex["messages"])
        while msgs and msgs[-1]["role"] == "assistant":
            msgs.pop()
        text = template.render_prompt(msgs, add_generation_prompt=True)
        ids = tokenizer.encode(text, add_special_tokens=False)
        out.append(np.asarray(ids[:cutoff_len], np.int64))
    return out


def bucket_prompts(prompts: List[np.ndarray], batch_size: int) -> List[np.ndarray]:
    """Group prompts of identical length into [B, T] batches (no pads: the
    answer to the reference's left-padding + attention_mask)."""
    by_len: Dict[int, List[np.ndarray]] = {}
    for p in prompts:
        by_len.setdefault(len(p), []).append(p)
    batches = []
    for L, group in sorted(by_len.items()):
        for i in range(0, len(group), batch_size):
            chunk = group[i : i + batch_size]
            if len(chunk) < batch_size:  # repeat to fill the batch
                chunk = (chunk * batch_size)[:batch_size]
            batches.append(np.stack(chunk))
    return batches


# ---------------------------------------------------------------- rollout


def make_rollout(cfg, rollout_len: int, temperature: float = 1.0):
    """(params, input_ids [B, T], state, generator) -> (tokens [B, R], state).
    cfg: the full InfiniteVLConfig (decode_step contract); params: a
    {"text": ...} tree. The state is updated in place."""

    @torch.no_grad()
    def rollout(params, input_ids, state, generator):
        B, T = input_ids.shape
        pos = torch.arange(T, device=input_ids.device)[None, None].expand(3, B, T).contiguous()
        logits, state = prefill(params, cfg, input_ids, pos, state)
        rope_delta = torch.zeros((B, 1), dtype=torch.long, device=input_ids.device)
        toks = []
        for _ in range(rollout_len):
            tok = sample_token(logits, generator, temperature)
            logits, state = decode_step(params, cfg, tok[:, None], rope_delta, state)
            toks.append(tok)
        return torch.stack(toks, dim=1), state

    return rollout


# ------------------------------------------------------------------ score


def token_logprobs_and_values(
    params: Params,
    cfg: TextConfig,
    full_ids: torch.Tensor,  # [B, T_p + R]
    prompt_len: int,
    with_values: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Log-probs of each response token and the value estimates at the
    positions that predict them. Returns (logp [B, R], values [B, R])."""
    B, T = full_ids.shape
    pos = torch.arange(T, device=full_ids.device)[None, None].expand(3, B, T).contiguous()
    hidden, _ = text_forward(params, cfg, embed_tokens(params, full_ids), pos, None)
    # logits at t predict token t+1: response tokens sit at [T_p, T). The
    # slice is made contiguous, so the head is one GEMM whether or not its
    # weight requires grad (train/step.chunked_logprobs says why): the
    # policy and its frozen reference give bit-equal log-probs
    h = hidden[:, prompt_len - 1 : -1].contiguous()  # [B, R, D]
    logits = lm_head(params, cfg, h)
    targets = full_ids[:, prompt_len:]
    tok_logp = torch.gather(F.log_softmax(logits, dim=-1), -1, targets[..., None])[..., 0]
    values = None
    if with_values and "value_head" in params:
        values = (h.float() @ params["value_head"]["kernel"].float())[..., 0]
    return tok_logp, values


def response_mask(tokens: torch.Tensor, eos_token_id: int) -> torch.Tensor:
    """1.0 up to and including the first EOS, 0.0 after. [B, R]."""
    is_eos = (tokens == eos_token_id).to(torch.int32)
    after = torch.cumsum(torch.cumsum(is_eos, dim=1), dim=1) > 1
    return (~after).float()


def gae_advantages(
    rewards: torch.Tensor,  # [B, R] per-token (KL penalty + terminal reward)
    values: torch.Tensor,  # [B, R]
    mask: torch.Tensor,  # [B, R]
    gamma: float = 1.0,
    lam: float = 0.95,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked generalized advantage estimation (ppo/trainer.py GAE; episode
    terminates at the last real token, bootstrap value 0)."""
    R = rewards.shape[1]
    next_values = torch.cat([values[:, 1:], torch.zeros_like(values[:, :1])], dim=1)
    # next_nonterminal gates the bootstrap: the episode's LAST real token
    # must bootstrap 0, not the value of a post-EOS garbage position
    next_mask = torch.cat([mask[:, 1:], torch.zeros_like(mask[:, :1])], dim=1)
    deltas = (rewards + gamma * next_values * next_mask - values) * mask
    # A_t = delta_t + gamma*lam*next_nonterminal_t*A_{t+1}, from the last t back
    carry = torch.zeros_like(rewards[:, 0])
    adv = torch.empty_like(rewards)
    for t in range(R - 1, -1, -1):
        carry = deltas[:, t] + gamma * lam * next_mask[:, t] * carry
        adv[:, t] = carry
    adv = adv * mask
    returns = adv + values * mask
    # normalize advantages over real tokens
    n = torch.clamp(mask.sum(), min=1.0)
    mean = (adv * mask).sum() / n
    var = (((adv - mean) * mask) ** 2).sum() / n
    adv = (adv - mean) / torch.sqrt(var + 1e-8) * mask
    return adv, returns


# ----------------------------------------------------------------- update


def make_ppo_update(
    cfg: TextConfig,
    tx: AdamW,
    clip_range: float = 0.2,
    vf_coef: float = 0.1,
):
    """One clipped-PPO gradient step on frozen rollout stats: (params,
    opt_state, full_ids, prompt_len, old_logp, old_values, advantages,
    returns, mask) -> (params, opt_state, loss), updating in place."""

    def update(params, opt_state, full_ids, prompt_len, old_logp, old_values,
               advantages, returns, mask):
        logp, values = token_logprobs_and_values(params, cfg, full_ids, prompt_len)
        ratio = torch.exp(logp - old_logp)
        pg1 = -advantages * ratio
        pg2 = -advantages * torch.clamp(ratio, 1 - clip_range, 1 + clip_range)
        n = torch.clamp(mask.sum(), min=1.0)
        pg_loss = (torch.maximum(pg1, pg2) * mask).sum() / n
        v_clipped = old_values + torch.clamp(values - old_values, -clip_range, clip_range)
        v_loss = 0.5 * (
            torch.maximum((values - returns) ** 2, (v_clipped - returns) ** 2) * mask
        ).sum() / n
        loss = pg_loss + vf_coef * v_loss
        apply_gradients(loss, params, tx, opt_state)
        return params, opt_state, loss.detach()

    return update


# --------------------------------------------------------------- workflow


@dataclasses.dataclass
class PPOStats:
    step: int
    mean_reward: float
    loss: float
    kl: float


def ppo_train(
    cfg,  # InfiniteVLConfig
    policy: Params,  # text tree + value_head, trainable leaves marked
    ref_params: Params,  # frozen text tree of its own
    prompt_batches: List[np.ndarray],
    reward_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
    *,
    rollout_len: int = 32,
    ppo_epochs: int = 1,
    clip_range: float = 0.2,
    kl_coef: float = 0.05,
    vf_coef: float = 0.1,
    gamma: float = 1.0,
    lam: float = 0.95,
    temperature: float = 1.0,
    learning_rate: float = 1e-5,
    max_steps: Optional[int] = None,
    seed: int = 0,
    log=None,
) -> Tuple[Params, List[PPOStats]]:
    """Drive PPO over prompt batches on the policy's device. reward_fn(
    full_ids [B, T_p+R] numpy, resp_mask [B, R]) -> terminal rewards [B]
    (the reference scores with a reward model; run_ppo wires one in, tests
    may inject a toy). The policy is updated in place and returned."""
    tcfg = cfg.text
    dev = tree_device(policy)
    tx = make_optimizer(learning_rate=learning_rate, warmup_steps=0)
    opt_state = tx.init(policy)
    update = make_ppo_update(tcfg, tx, clip_range, vf_coef)
    rollout = make_rollout(cfg, rollout_len, temperature)
    generator = torch.Generator(device=dev).manual_seed(seed)
    stats: List[PPOStats] = []

    step_i = 0
    for batch in prompt_batches:
        if max_steps is not None and step_i >= max_steps:
            break
        B, T_p = batch.shape
        ids = torch.as_tensor(np.asarray(batch, np.int64), device=dev)
        state = init_decoder_state(tcfg, B, dtype=torch.float32, device=dev)
        toks, _ = rollout({"text": policy}, ids, state, generator)
        full_ids = torch.cat([ids, toks.long()], dim=1)
        mask = response_mask(toks, cfg.eos_token_id)
        with torch.no_grad():
            logp_old, values_old = token_logprobs_and_values(policy, tcfg, full_ids, T_p)
            ref_logp, _ = token_logprobs_and_values(ref_params, tcfg, full_ids, T_p,
                                                    with_values=False)
        # terminal reward at the last real token + per-token KL penalty
        # (ppo/trainer.py compute_rewards semantics)
        r_term = np.asarray(
            reward_fn(full_ids.cpu().numpy(), mask.cpu().numpy())).astype(np.float32)
        kl = (logp_old - ref_logp) * mask
        last_idx = torch.clamp(mask.sum(dim=1) - 1, min=0).long()
        rewards = -kl_coef * kl
        rewards.index_put_((torch.arange(B, device=dev), last_idx),
                           torch.as_tensor(r_term, device=dev), accumulate=True)
        adv, returns = gae_advantages(rewards, values_old, mask, gamma, lam)
        loss = torch.zeros(())
        for _ in range(ppo_epochs):
            policy, opt_state, loss = update(policy, opt_state, full_ids, T_p, logp_old,
                                             values_old, adv, returns, mask)
        step_i += 1
        s = PPOStats(
            step=step_i,
            mean_reward=float(r_term.mean()),
            loss=float(loss),
            kl=float(kl.sum() / torch.clamp(mask.sum(), min=1.0)),
        )
        stats.append(s)
        if log is not None:
            log.log(step_i, loss=s.loss, reward=s.mean_reward, kl=s.kl)
    return policy, stats


def rm_reward_fn(rm_params: Params, tcfg: TextConfig):
    """reward_fn of a trained reward model (run_rm's text tree with its
    value_head): its value at the response's last real token."""
    from .dpo import rm_values

    dev = tree_device(rm_params)

    @torch.no_grad()
    def reward_fn(full_ids, resp_mask):
        ids = torch.as_tensor(full_ids, device=dev)
        B, T = ids.shape
        pos = torch.arange(T, device=dev)[None, None].expand(3, B, T).contiguous()
        values = rm_values(rm_params, tcfg, ids, pos).float().cpu().numpy()
        T_p = full_ids.shape[1] - resp_mask.shape[1]
        last = T_p + np.maximum(resp_mask.sum(axis=1) - 1, 0).astype(int)
        return values[np.arange(B), last]

    return reward_fn


def run_ppo(args, tokenizer=None, reward_fn=None, device: Optional[Device] = None):
    """PPO workflow (reference train/ppo/workflow.py): prompts from the SFT
    dataset, rewards from a trained reward model (reward_model_path, a
    checkpoint directory of the rm stage) or an injected reward_fn. Runs on
    the CUDA card unless `device="cpu"`. Returns (policy, stats)."""
    from ..data.loader import load_dataset_info, load_examples, resolve_tokenizer
    from ..utils.checkpoint import restore_train_state, tree_map
    from ..utils.logging import TrainerLog
    from .trainer import (
        _policy_params,
        _refuse_multi_rank,
        build_config,
        frozen_copy,
    )

    _refuse_multi_rank("ppo")
    if reward_fn is None and not args.finetune.reward_model_path:
        raise ValueError(
            "ppo needs reward_model_path (a checkpoint from the rm stage) "
            "or an injected reward_fn"
        )
    device = resolve_device(device)
    cfg = build_config(args)
    tcfg = cfg.text
    dtype = torch.float32  # PPO ratios want fp32 accuracy
    tokenizer = resolve_tokenizer(args, None, tokenizer)
    info = load_dataset_info(os.path.join(args.data.dataset_dir, "dataset_info.json"))
    examples = load_examples(info[args.data.dataset], args.data.dataset_dir)
    if args.data.max_samples:
        examples = examples[: args.data.max_samples]
    prompts = encode_prompts(examples, tokenizer, args.data.template, args.data.cutoff_len)
    batches = bucket_prompts(prompts, args.train.per_device_train_batch_size)

    policy = _policy_params(args, cfg, dtype, device)
    ref_params = frozen_copy(policy)
    policy["value_head"] = {
        "kernel": torch.zeros((tcfg.hidden_size, 1), dtype=torch.float32, device=device,
                              requires_grad=True)}

    if reward_fn is None:
        _, rm_state = restore_train_state(args.finetune.reward_model_path)
        if rm_state is None:
            raise ValueError(f"no reward-model checkpoint under "
                             f"{args.finetune.reward_model_path}")
        reward_fn = rm_reward_fn(tree_map(lambda t: t.to(device), rm_state["params"]), tcfg)
        del rm_state

    log = TrainerLog(args.train.output_dir)
    return ppo_train(
        cfg,
        policy,
        ref_params,
        batches,
        reward_fn,
        rollout_len=args.finetune.ppo_rollout_len,
        ppo_epochs=args.finetune.ppo_epochs,
        clip_range=args.finetune.ppo_clip_range,
        kl_coef=args.finetune.ppo_kl_coef,
        vf_coef=args.finetune.ppo_vf_coef,
        gamma=args.finetune.ppo_gamma,
        lam=args.finetune.ppo_lam,
        temperature=args.gen.temperature,
        learning_rate=args.train.learning_rate,
        max_steps=args.train.max_steps,
        seed=args.train.seed,
        log=log,
    )
