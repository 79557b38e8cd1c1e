"""Preference-optimization stages: DPO (+ IPO / SimPO / ORPO losses), KTO
and a pairwise reward-model loss (torch port of infinitevl_tpu/train/dpo.py).

Reference: src/llamafactory/train/dpo/ (TRL-based trainer with pref_loss
variants), train/kto/ and train/rm/. A step takes the policy (updated IN
PLACE, like every step of the port: train/step.py), the optimizer state and,
for DPO and KTO, the frozen reference, and a batch of chosen / rejected (or
tagged) sequences. The reference runs under no_grad and is never written:
it must be a tree of its own, not the policy's tensors (run_dpo / run_kto
clone it), since the optimizer's in-place updates would move a shared one.

Sequence log-probs gather each row's target log-probs chunk by chunk from
the final hidden states (train/step.chunked_logprobs, which the SFT loss
with remat uses too), so the [B, T, vocab] fp32 log-softmax is never held;
the per-row sums are the JAX package's up to summation order."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..config import TextConfig
from ..models.text import embed_tokens, text_forward
from .step import (
    IGNORE_INDEX,
    AdamW,
    apply_gradients,
    batch_to_device,
    chunked_logprobs,
    head_weight,
    tree_device,
)

Params = Dict[str, Any]

LOGPROB_CHUNK = 1024  # positions of one chunk of the head: 1,024 x vocab x 4 bytes a row


def sequence_logprobs(
    params: Params,
    cfg: TextConfig,
    input_ids: torch.Tensor,  # [B, T]
    labels: torch.Tensor,  # [B, T] (-100 on prompt/pad)
    position_ids: torch.Tensor,  # [3, B, T]
    remat: bool = False,
    remat_group: int = 1,
    chunk: int = LOGPROB_CHUNK,
) -> torch.Tensor:
    """Sum of per-token log-probs over supervised positions. [B] fp32.
    `remat` checkpoints the decoder layers (text_forward); no number changes."""
    hidden, _ = text_forward(params, cfg, embed_tokens(params, input_ids), position_ids,
                             None, remat=remat, remat_group=remat_group)
    w, w_is_vd = head_weight(params)
    return chunked_logprobs(hidden, w, labels, chunk, w_is_vd)


def dpo_loss(
    policy_chosen: torch.Tensor,
    policy_rejected: torch.Tensor,
    ref_chosen: Optional[torch.Tensor],
    ref_rejected: Optional[torch.Tensor],
    beta: float = 0.1,
    loss_type: str = "sigmoid",
    label_smoothing: float = 0.0,
    simpo_gamma: float = 0.5,
) -> torch.Tensor:
    """DPO family losses (dpo/trainer.py variants: sigmoid/IPO/SimPO/ORPO)."""
    if loss_type == "simpo":
        # length-normalization is the caller's job; reference-free
        logits = beta * (policy_chosen - policy_rejected) - simpo_gamma
        return -F.logsigmoid(logits).mean()
    if loss_type == "orpo":
        # odds-ratio penalty on top of NLL; here just the OR term
        log_odds = (policy_chosen - policy_rejected) - (
            torch.log1p(-torch.exp(torch.clamp(policy_chosen, max=-1e-6)))
            - torch.log1p(-torch.exp(torch.clamp(policy_rejected, max=-1e-6)))
        )
        return -F.logsigmoid(beta * log_odds).mean()
    if ref_chosen is None or ref_rejected is None:
        raise ValueError(f"pref_loss {loss_type!r} needs the reference's log-probs")
    logits = beta * ((policy_chosen - ref_chosen) - (policy_rejected - ref_rejected))
    if loss_type == "ipo":
        return ((logits - 1.0 / (2 * beta)) ** 2).mean()
    # sigmoid (standard DPO) with optional label smoothing
    return (
        -F.logsigmoid(logits) * (1 - label_smoothing)
        - F.logsigmoid(-logits) * label_smoothing
    ).mean()


def needs_reference(loss_type: str) -> bool:
    """simpo and orpo are reference-free: no reference model is built."""
    return loss_type in ("sigmoid", "ipo")


def make_dpo_step(
    cfg: TextConfig,
    tx: AdamW,
    beta: float = 0.1,
    loss_type: str = "sigmoid",
    remat: bool = False,
    remat_group: int = 1,
):
    """(policy, opt_state, ref_params, batch) -> (policy, opt_state, loss).
    batch: chosen_ids/chosen_labels/rejected_ids/rejected_labels/position_ids.
    `ref_params` may be None for the reference-free losses."""

    def step(policy, opt_state, ref_params, batch):
        batch = batch_to_device(batch, tree_device(policy))
        pos = batch["position_ids"]
        ref_c = ref_r = None
        if needs_reference(loss_type):
            with torch.no_grad():
                ref_c = sequence_logprobs(ref_params, cfg, batch["chosen_ids"],
                                          batch["chosen_labels"], pos)
                ref_r = sequence_logprobs(ref_params, cfg, batch["rejected_ids"],
                                          batch["rejected_labels"], pos)
        pc = sequence_logprobs(policy, cfg, batch["chosen_ids"], batch["chosen_labels"], pos,
                               remat, remat_group)
        pr = sequence_logprobs(policy, cfg, batch["rejected_ids"], batch["rejected_labels"],
                               pos, remat, remat_group)
        loss = dpo_loss(pc, pr, ref_c, ref_r, beta, loss_type)
        apply_gradients(loss, policy, tx, opt_state)
        return policy, opt_state, loss.detach()

    return step


def kto_loss(
    policy_logps: torch.Tensor,  # [B] sequence log-probs
    ref_logps: torch.Tensor,  # [B]
    is_desirable: torch.Tensor,  # [B] bool
    kl_baseline: torch.Tensor,  # scalar: batch KL estimate E[policy - ref]
    beta: float = 0.1,
    desirable_weight: float = 1.0,
    undesirable_weight: float = 1.0,
) -> torch.Tensor:
    """Kahneman-Tversky optimization loss (train/kto): unpaired feedback;
    desirable examples push log-ratio above the KL baseline, undesirable
    below."""
    ratio = policy_logps - ref_logps
    d = torch.sigmoid(beta * (ratio - kl_baseline))
    u = torch.sigmoid(beta * (kl_baseline - ratio))
    loss = torch.where(
        is_desirable,
        desirable_weight * (1.0 - d),
        undesirable_weight * (1.0 - u),
    )
    return loss.mean()


def make_kto_step(cfg: TextConfig, tx: AdamW, beta: float = 0.1, remat: bool = False,
                  remat_group: int = 1):
    """(policy, opt_state, ref_params, batch) -> (policy, opt_state, loss).
    batch: input_ids/labels/position_ids/is_desirable [B]."""

    def step(policy, opt_state, ref_params, batch):
        batch = batch_to_device(batch, tree_device(policy))
        pos = batch["position_ids"]
        with torch.no_grad():
            ref_lp = sequence_logprobs(ref_params, cfg, batch["input_ids"], batch["labels"],
                                       pos)
        lp = sequence_logprobs(policy, cfg, batch["input_ids"], batch["labels"], pos, remat,
                               remat_group)
        kl = torch.clamp((lp - ref_lp).mean(), min=0.0).detach()
        loss = kto_loss(lp, ref_lp, batch["is_desirable"], kl, beta)
        apply_gradients(loss, policy, tx, opt_state)
        return policy, opt_state, loss.detach()

    return step


def rm_pairwise_loss(chosen_rewards: torch.Tensor,
                     rejected_rewards: torch.Tensor) -> torch.Tensor:
    """Bradley-Terry pairwise reward loss (train/rm)."""
    return -F.logsigmoid(chosen_rewards - rejected_rewards).mean()


def rm_values(params: Params, cfg: TextConfig, ids: torch.Tensor, pos: torch.Tensor,
              remat: bool = False, remat_group: int = 1) -> torch.Tensor:
    """The value head over every position of the decoder's final hidden
    states. [B, T] in the weights' dtype."""
    hidden, _ = text_forward(params, cfg, embed_tokens(params, ids), pos, None,
                             remat=remat, remat_group=remat_group)
    return (hidden @ params["value_head"]["kernel"])[..., 0]


def rm_reward(params: Params, cfg: TextConfig, ids: torch.Tensor, labels: torch.Tensor,
              pos: torch.Tensor, remat: bool = False, remat_group: int = 1) -> torch.Tensor:
    """Reward = value at the last supervised position. [B]."""
    values = rm_values(params, cfg, ids, pos, remat, remat_group)
    mask = (labels != IGNORE_INDEX).to(values.dtype)
    last = torch.argmax(mask * torch.arange(values.shape[1], device=values.device)[None, :],
                        dim=1)
    return torch.gather(values, 1, last[:, None])[:, 0]


def make_rm_step(cfg: TextConfig, tx: AdamW, remat: bool = False, remat_group: int = 1):
    """Reward model = decoder + scalar value head ('value_head' in params:
    {'kernel': [D, 1]}). (params, opt_state, batch) -> (params, opt_state,
    loss)."""

    def step(params, opt_state, batch):
        batch = batch_to_device(batch, tree_device(params))
        pos = batch["position_ids"]
        rc = rm_reward(params, cfg, batch["chosen_ids"], batch["chosen_labels"], pos, remat,
                       remat_group)
        rr = rm_reward(params, cfg, batch["rejected_ids"], batch["rejected_labels"], pos,
                       remat, remat_group)
        loss = rm_pairwise_loss(rc, rr)
        apply_gradients(loss, params, tx, opt_state)
        return params, opt_state, loss.detach()

    return step
