"""The port's LoRA path against the JAX package on the CPU in fp32: the
adapter tree, the attached side path, rsLoRA, the int8 (QLoRA) base, three
optimizer steps and the merged export. Adapters and optimizer state are
carried across as numpy (tests/torch_port_helpers.carry_train_state).

Tolerances: forward logits and losses <= 1e-4 of JAX's (fp32 through 8
layers), attach against apply <= 1e-5 (the low-rank product is associated
differently), adapters after three steps <= 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import carry_train_state, err_ratio, to_port_config, tree_err

import infinitevl_tpu.models.quant as jquant
import infinitevl_tpu.train.lora as jlora
import infinitevl_tpu.train.step as jstep
import infinitevl_tpu_torch.models.quant as tquant
import infinitevl_tpu_torch.train.lora as tlora
import infinitevl_tpu_torch.train.step as tstep
from infinitevl_tpu.config import tiny_config
from infinitevl_tpu.models.params import init_text_params
from infinitevl_tpu.models.text import lm_head as jlm_head
from infinitevl_tpu.models.text import text_forward as jtext_forward
from infinitevl_tpu_torch.models.text import lm_head, text_forward
from infinitevl_tpu_torch.train.step import tree_leaves_with_path

torch.set_num_threads(2)

CFG = tiny_config()
TCFG = to_port_config(CFG)
T = 24
RANK, ALPHA = 4, 8.0


@pytest.fixture(scope="module")
def weights():
    jp = {"text": init_text_params(jax.random.PRNGKey(0), CFG.text, jnp.float32)}
    tp, _ = carry_train_state(jp, trainable=False)
    return jp, tp


def _adapter(jp, seed=0, target=("q_proj", "k_proj", "v_proj", "o_proj")):
    """A JAX adapter with b != 0 (numpy noise), and the port's copy."""
    jl = jlora.init_lora(jp, jax.random.PRNGKey(seed + 1), rank=RANK, target=target)
    rng = np.random.RandomState(seed)
    jl = jax.tree.map(
        lambda x: x if x.any() else jnp.asarray(
            0.05 * rng.standard_normal(x.shape).astype(np.float32)), jl)
    tl, _ = carry_train_state(jl)
    return jl, tl


def _batch(seed=0, B=2):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, CFG.text.vocab_size - 8, (B, T))
    labels = np.where(rng.uniform(size=(B, T)) < 0.6, ids, -100)
    pos = np.broadcast_to(np.arange(T)[None, None], (3, B, T)).copy()
    return dict(input_ids=ids, labels=labels, position_ids=pos)


def _logits_t(p, ids, pos):
    h, _ = text_forward(p["text"], TCFG.text, p["text"]["embed"][torch.from_numpy(ids)],
                        torch.from_numpy(pos))
    return lm_head(p["text"], TCFG.text, h)


def _logits_j(p, ids, pos):
    h, _, _ = jtext_forward(p["text"], CFG.text, p["text"]["embed"][jnp.asarray(ids)],
                            jnp.asarray(pos))
    return jlm_head(p["text"], CFG.text, h)


def test_lora_scale_and_zero_init_identity(weights):
    _, tp = weights
    assert tlora.lora_scale(16, 8) == jlora.lora_scale(16, 8) == 2.0
    assert tlora.lora_scale(16, 4, True) == jlora.lora_scale(16, 4, True) == 8.0
    lora = tlora.init_lora(tp, torch.Generator().manual_seed(0), rank=RANK)
    leaves = list(tree_leaves_with_path(lora))
    assert all(t.requires_grad for _, t in leaves)
    assert all(not t.any() for p, t in leaves if p.endswith("/b"))
    a = [t for p, t in leaves if p.endswith("/a")]
    # a ~ N(0, 1/r): std within 10% over all entries
    std = float(torch.cat([x.flatten() for x in a]).std())
    assert abs(std - RANK**-0.5) < 0.1 * RANK**-0.5
    b = _batch()
    with torch.no_grad():
        base = _logits_t(tp, b["input_ids"], b["position_ids"])
        attached = _logits_t(tlora.attach_lora(tp, lora, ALPHA, RANK), b["input_ids"],
                             b["position_ids"])
    assert torch.equal(base, attached)  # b = 0: the side path adds exact zeros


@pytest.mark.parametrize("target", [("q_proj", "k_proj", "v_proj", "o_proj"),
                                    ("q_proj", "up", "down", "g_proj")])
def test_init_lora_targets_match_jax_structure(weights, target):
    jp, tp = weights
    jl = jlora.init_lora(jp, jax.random.PRNGKey(1), rank=RANK, target=target)
    tl = tlora.init_lora(tp, torch.Generator().manual_seed(1), rank=RANK, target=target)
    shapes = lambda tree: {p: tuple(t.shape) for p, t in tree_leaves_with_path(tree)}
    want, _ = carry_train_state(jl)
    assert shapes(tl) == shapes(want) and len(shapes(tl)) > 0
    # layers without a target keep an empty dict at their index
    assert len(tl["text"]["layers"]) == CFG.text.num_hidden_layers


@pytest.mark.parametrize("use_rslora", [False, True])
def test_attach_equals_apply_and_jax(weights, use_rslora):
    jp, tp = weights
    jl, tl = _adapter(jp)
    b = _batch(1)
    kw = dict(alpha=ALPHA, rank=RANK, use_rslora=use_rslora)
    want = _logits_j(jlora.attach_lora(jp, jl, **kw), b["input_ids"], b["position_ids"])
    with torch.no_grad():
        att = _logits_t(tlora.attach_lora(tp, tl, **kw), b["input_ids"], b["position_ids"])
        app = _logits_t(tlora.apply_lora(tp, tl, **kw), b["input_ids"], b["position_ids"])
        base = _logits_t(tp, b["input_ids"], b["position_ids"])
    assert err_ratio(att, want) < 1e-4
    assert err_ratio(att, app) < 1e-5
    assert err_ratio(att, base) > 1e-3  # the adapter does something
    # merged export equals JAX's
    merged = tlora.merge_lora(tp, tl, **kw)
    assert tree_err(merged, jlora.merge_lora(jp, jl, **kw)) < 1e-6
    assert not any(t.requires_grad for _, t in tree_leaves_with_path(merged))


def test_int8_base_forward_and_merge_match_jax(weights):
    """The QLoRA configuration: int8 frozen base (identical integers on
    both sides) with the side path on top; merging dequantises to bf16."""
    jp, tp = weights
    jq, tq = jquant.quantize_params(jp, min_size=0), tquant.quantize_params(tp, min_size=0)
    jl, tl = _adapter(jq, seed=2)
    node_t = tq["text"]["layers"][0]["mlp"]["up"]
    node_j = jq["text"]["layers"][0]["mlp"]["up"]
    assert np.array_equal(node_t["kernel_q"].numpy(), np.asarray(node_j["kernel_q"]))
    b = _batch(2)
    want = _logits_j(jlora.attach_lora(jq, jl, ALPHA, RANK), b["input_ids"], b["position_ids"])
    with torch.no_grad():
        got = _logits_t(tlora.attach_lora(tq, tl, ALPHA, RANK), b["input_ids"],
                        b["position_ids"])
    assert err_ratio(got, want) < 1e-4
    merged = tlora.merge_lora(tq, tl, ALPHA, RANK)
    jm = jlora.merge_lora(jq, jl, ALPHA, RANK)
    k_t = merged["text"]["layers"][0]["q_proj"]["kernel"]
    assert k_t.dtype == torch.bfloat16 and "kernel_q" not in merged["text"]["layers"][0]["q_proj"]
    k_j = np.asarray(jm["text"]["layers"][0]["q_proj"]["kernel"].astype(jnp.float32))
    assert err_ratio(k_t.float(), k_j) < 1e-2  # bf16 storage of the merged kernel


@pytest.mark.parametrize("quantized", [False, True])
def test_three_lora_steps_match_jax(weights, quantized):
    """make_lora_sft_step from the same adapter, optimizer state and
    batches: three losses and the adapters after them match JAX; the base
    is bit-unchanged; the first loss with b = 0 is the base model's."""
    jp, tp = weights
    if quantized:
        jp, tp = jquant.quantize_params(jp, min_size=0), tquant.quantize_params(tp, min_size=0)
    jl = jlora.init_lora(jp, jax.random.PRNGKey(7), rank=RANK)
    jtx = jstep.make_optimizer(5e-3, warmup_steps=1, total_steps=3)
    jstate = jtx.init(jl)
    tl, tstate = carry_train_state(jl, jstate)
    ttx = tstep.make_optimizer(5e-3, warmup_steps=1, total_steps=3)
    assert tstate["count"] == 0 and len(tstate["mu"]) == len(list(tree_leaves_with_path(tl)))
    jfn = jax.jit(jlora.make_lora_sft_step(CFG.text, jtx, alpha=ALPHA, rank=RANK))
    tfn = tlora.make_lora_sft_step(TCFG.text, ttx, alpha=ALPHA, rank=RANK, remat=quantized)
    before = {p: t.clone() for p, t in tree_leaves_with_path(tp)}
    losses_j, losses_t = [], []
    for i in range(3):
        b = _batch(10 + i)
        jl, jstate, lj = jfn(jl, jstate, jp, {k: jnp.asarray(v) for k, v in b.items()})
        tl, tstate, lt = tfn(tl, tstate, tp, dict(b))
        losses_j.append(float(lj))
        losses_t.append(float(lt))
    assert max(abs(a - b_) / b_ for a, b_ in zip(losses_t, losses_j)) < 1e-4
    assert tree_err(tl, jl) < 1e-4
    assert all(torch.equal(t, before[p]) for p, t in tree_leaves_with_path(tp))
    b0 = _batch(10)
    with torch.no_grad():
        base_loss = tstep.sft_loss_fn(tp["text"], TCFG.text, *(
            torch.from_numpy(b0[k]) for k in ("input_ids", "labels", "position_ids")))
    assert abs(float(base_loss) - losses_t[0]) < 1e-6


def test_lora_eval_fn_and_later_methods_raise(weights):
    jp, tp = weights
    jl, tl = _adapter(jp, seed=3)
    b = _batch(4)
    want = jlora.make_lora_eval_fn(CFG.text, ALPHA, RANK)(
        jl, jp, {k: jnp.asarray(v) for k, v in b.items()})
    got = tlora.make_lora_eval_fn(TCFG.text, ALPHA, RANK)(tl, tp, dict(b))
    assert abs(float(got) - float(want)) / float(want) < 1e-4 and not got.requires_grad
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError, match="PiSSA"):
        tlora.init_lora(tp, gen, method="pissa")
    with pytest.raises(NotImplementedError, match="DoRA"):
        tlora.init_lora(tp, gen, use_dora=True)
    dora = {"text": {"layers": [{"q_proj": {"a": torch.zeros(32, 2), "b": torch.zeros(2, 32),
                                            "m": torch.zeros(32)}}]}}
    with pytest.raises(NotImplementedError, match="DoRA"):
        tlora.attach_lora(tp, dora)
