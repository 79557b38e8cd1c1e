"""The port's LoRA path against the JAX package on the CPU in fp32: the
adapter tree, the attached side path, rsLoRA, the int8 (QLoRA) base, three
optimizer steps and the merged export; DoRA (column norms, identity at
init, attach against apply, every leaf's gradient and one step), PiSSA
and LoftQ (sign-invariant: the factors' product, the residual base, the
reconstruction error). Adapters and optimizer state are
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
from torch_port_helpers import jax_compile_cache  # noqa: F401 (autouse)

import infinitevl_tpu.models.quant as jquant
import infinitevl_tpu.train.lora as jlora
import infinitevl_tpu.train.step as jstep
import infinitevl_tpu_torch.models.quant as tquant
import infinitevl_tpu_torch.models.text as tmodel_text
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
    # PiSSA and DoRA were refused here before they were ported: the same
    # calls now build JAX's adapters (PiSSA's factors up to the SVD's column
    # signs, so its product a @ b is compared), and a quantised base still
    # raises ValueError for both, as in JAX
    gen = torch.Generator().manual_seed(0)
    tl = tlora.init_lora(tp, gen, rank=RANK, method="pissa")
    jl = jlora.init_lora(jp, jax.random.PRNGKey(0), rank=RANK, method="pissa")
    _hold_principal(_ab_products(tl), _ab_products(jl), tp, 1.0)
    tl = tlora.init_lora(tp, gen, rank=RANK, use_dora=True)
    jl = jlora.init_lora(jp, jax.random.PRNGKey(0), rank=RANK, use_dora=True)
    ms = {p: t for p, t in tree_leaves_with_path(tl) if p.endswith("/m")}
    assert len(ms) == 4 * CFG.text.num_hidden_layers and all(t.requires_grad for t in ms.values())
    assert tree_err({p: t for p, t in ms.items()}, {p: np.asarray(v) for p, v in
                                                    _jpaths(jl) if p.endswith("/m")}) < 1e-6
    tq = tquant.quantize_params(tp, min_size=0)
    for kw in (dict(method="pissa"), dict(use_dora=True)):
        with pytest.raises(ValueError, match="PiSSA/DoRA"):
            tlora.init_lora(tq, gen, **kw)
    w = tp["text"]["layers"][0]["q_proj"]["kernel"]
    d_in, d_out = w.shape
    dora = {"text": {"layers": [{"q_proj": {"a": torch.zeros(d_in, 2), "b": torch.zeros(2, d_out),
                                            "m": torch.ones(d_out)}}]}}
    q = tlora.attach_lora(tp, dora)["text"]["layers"][0]["q_proj"]
    # m = 1 and b = 0: the layer's output is x @ W with unit columns
    y = tmodel_text._dense(torch.eye(d_in), q)
    assert torch.allclose(y, w / w.norm(dim=0), rtol=1e-5, atol=1e-6)


def _jpaths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _jpaths(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _jpaths(v, f"{prefix}/{i}" if prefix else str(i))
    elif tree is not None:
        yield prefix, tree


def _ab_products(adapter):
    """{node path: a @ b in fp64} of an adapter tree, JAX's or the port's:
    the quantity an SVD's column signs leave unchanged."""
    leaves = dict((p, np.asarray(t.detach() if hasattr(t, "detach") else t, np.float64))
                  for p, t in _jpaths(adapter))
    return {p[:-2]: a @ leaves[p[:-2] + "/b"] for p, a in leaves.items() if p.endswith("/a")}


def _hold_principal(got, want, tp, scale):
    """PiSSA's products a @ b (the base kernels' rank-r principal parts
    over `scale`) against an fp64 SVD of the same kernels and against JAX's.
    An fp32 SVD's rank-r subspace moves by about its rounding over the
    relative gap 1 - s_r+1 / s_r (Davis-Kahan), and the tiny kernels' gaps
    run down to 0.006: JAX's own product stands up to 1.4e-5 from the fp64
    one there. So each kernel is held to 1e-6 / gap against fp64 and twice
    that against JAX (1e-5 or tighter where the gap is 0.1 or wider)."""
    assert set(got) == set(want) and len(got) == 4 * CFG.text.num_hidden_layers
    for path, prod in got.items():
        i, k = path.split("/")[2:4]
        w = tp["text"]["layers"][int(i)][k]["kernel"].double().numpy()
        u, sv, vt = np.linalg.svd(w, full_matrices=False)
        exact = (u[:, :RANK] * sv[:RANK]) @ vt[:RANK] / scale
        tol = 1e-6 / (1.0 - sv[RANK] / sv[RANK - 1])
        assert err_ratio(prod, exact) < tol and err_ratio(prod, want[path]) < 2 * tol, path


# ---------------------------------------------------------------- DoRA


def test_dora_column_norms_match_jax_and_the_formed_weight():
    rng = np.random.RandomState(0)
    w, a, b = (rng.standard_normal(s).astype(np.float32) for s in ((48, 40), (48, 4), (4, 40)))
    got = tlora._dora_column_norms(*map(torch.from_numpy, (w, a, b)))
    want = jlora._dora_column_norms(*map(jnp.asarray, (w, a, b)))
    assert got.dtype == torch.float32 and err_ratio(got, want) < 1e-5
    assert err_ratio(got, np.linalg.norm(w.astype(np.float64) + a @ b, axis=0)) < 1e-5


def _dora_adapter(jp, seed=0):
    """A JAX DoRA adapter with every factor moved off its init, and the
    port's copy."""
    jl = jlora.init_lora(jp, jax.random.PRNGKey(seed + 1), rank=RANK, use_dora=True)
    rng = np.random.RandomState(seed)
    jl = jax.tree.map(lambda x: x + jnp.asarray(
        0.02 * rng.standard_normal(x.shape).astype(np.float32)), jl)
    tl, _ = carry_train_state(jl)
    return jl, tl


def test_dora_identity_at_init_and_attach_equals_apply(weights):
    jp, tp = weights
    b = _batch(5)
    lora = tlora.init_lora(tp, torch.Generator().manual_seed(0), rank=RANK, use_dora=True)
    with torch.no_grad():
        base = _logits_t(tp, b["input_ids"], b["position_ids"])
        init = _logits_t(tlora.attach_lora(tp, lora, ALPHA, RANK), b["input_ids"],
                         b["position_ids"])
    assert err_ratio(init, base) < 1e-6  # b = 0 and m = ||W||_col: the base model
    jl, tl = _dora_adapter(jp)
    want = _logits_j(jlora.attach_lora(jp, jl, ALPHA, RANK), b["input_ids"], b["position_ids"])
    with torch.no_grad():
        att = _logits_t(tlora.attach_lora(tp, tl, ALPHA, RANK), b["input_ids"],
                        b["position_ids"])
        app = _logits_t(tlora.apply_lora(tp, tl, ALPHA, RANK), b["input_ids"],
                        b["position_ids"])
    assert err_ratio(att, want) < 1e-4 and err_ratio(att, app) < 1e-5
    assert err_ratio(att, base) > 1e-3
    assert tree_err(tlora.merge_lora(tp, tl, ALPHA, RANK), jlora.merge_lora(jp, jl, ALPHA, RANK)) \
        < 1e-5


def test_dora_step_gradients_and_update_match_jax(weights):
    """The gradient of every DoRA leaf (a, b and the magnitude m) against
    jax.grad, then one make_lora_sft_step from the same adapter and AdamW
    state: loss and adapter <= 1e-4; the base bit-unchanged."""
    jp, tp = weights
    jl, tl = _dora_adapter(jp, seed=4)
    b = _batch(6)
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    def jloss(l):
        m = jlora.attach_lora(jp, l, ALPHA, RANK)
        return jstep.sft_loss_fn(m["text"], CFG.text, jb["input_ids"], jb["labels"],
                                 jb["position_ids"])

    want, jg = jax.jit(jax.value_and_grad(jloss))(jl)
    merged = tlora.attach_lora(tp, tl, ALPHA, RANK)
    got = tstep.sft_loss_fn(merged["text"], TCFG.text, *(
        torch.from_numpy(b[k]) for k in ("input_ids", "labels", "position_ids")))
    named = list(tree_leaves_with_path(tl))
    grads = torch.autograd.grad(got, [t for _, t in named])
    jgl = {p: np.asarray(v) for p, v in _jpaths(jg)}
    assert abs(float(got) - float(want)) <= 1e-4 * float(want)
    errs = {p: err_ratio(g, jgl[p]) for (p, _), g in zip(named, grads)}
    assert {p.rsplit("/", 1)[1] for p in errs} == {"a", "b", "m"}
    assert max(errs.values()) < 1e-4, max(errs.items(), key=lambda kv: kv[1])
    jtx = jstep.make_optimizer(5e-3, grad_clip=1e9)
    jstate = jtx.init(jl)
    tl, tstate = carry_train_state(jl, jstate)
    before = {p: t.clone() for p, t in tree_leaves_with_path(tp)}
    jl2, _, lj = jax.jit(jlora.make_lora_sft_step(CFG.text, jtx, alpha=ALPHA, rank=RANK))(
        jl, jstate, jp, jb)
    tl2, _, lt = tlora.make_lora_sft_step(TCFG.text, tstep.make_optimizer(5e-3, grad_clip=1e9),
                                          alpha=ALPHA, rank=RANK)(tl, tstate, tp, dict(b))
    assert abs(float(lt) - float(lj)) <= 1e-4 * float(lj)
    assert tree_err(tl2, jl2) < 1e-4
    assert all(torch.equal(t, before[p]) for p, t in tree_leaves_with_path(tp))


# ---------------------------------------------------------------- PiSSA, LoftQ


@pytest.mark.parametrize("alpha", [None, 3.0 * RANK], ids=["alpha_rank", "alpha_3r"])
def test_pissa_decompose_matches_jax(weights, alpha):
    """The residual base against JAX's (<= 1e-5), the adapter's product
    a @ b as _hold_principal holds it (LAPACK and torch choose the singular
    vectors' signs apart, so the factors themselves are not compared), and
    the invariant: apply_lora(residual, adapter) is the base, logits
    <= 1e-5."""
    jp, tp = weights
    jres, jad = jlora.pissa_decompose(jp, jax.random.PRNGKey(0), rank=RANK, alpha=alpha)
    tres, tad = tlora.pissa_decompose(tp, None, rank=RANK, alpha=alpha)
    a = alpha if alpha is not None else RANK
    _hold_principal(_ab_products(tad), _ab_products(jad), tp, a / RANK)
    assert tree_err(tres, jres) < 1e-5
    assert all(t.requires_grad for _, t in tree_leaves_with_path(tad))
    assert not any(t.requires_grad for _, t in tree_leaves_with_path(tres))
    b = _batch(7)
    with torch.no_grad():
        base = _logits_t(tp, b["input_ids"], b["position_ids"])
        back = _logits_t(tlora.apply_lora(tres, tad, a, RANK), b["input_ids"],
                         b["position_ids"])
        side = _logits_t(tlora.attach_lora(tres, tad, a, RANK), b["input_ids"],
                         b["position_ids"])
    assert err_ratio(back, base) < 1e-5 and err_ratio(side, base) < 1e-5
    # the residual is the base less its principal part: far from the base
    k0 = tp["text"]["layers"][0]["q_proj"]["kernel"]
    assert err_ratio(tres["text"]["layers"][0]["q_proj"]["kernel"], k0.numpy()) > 1e-2


def test_loftq_init_matches_jax(weights):
    """Per target kernel: int8 integers and scales as JAX's (the first
    round quantises W itself; later rounds quantise W less the SVD's
    product, which the two LAPACKs round apart by an ulp at most, so an
    integer may move by one), the adapter's a @ b <= 1e-4 of JAX's, and
    ||W - (deq(Q) + s a b)||_F equal to JAX's within 1e-4 and below plain
    int8's ||W - deq(quant(W))||_F. Non-targets stay the base's tensors."""
    jp, tp = weights
    alpha, iters = 2.0 * RANK, 3
    jq, jad = jlora.loftq_init(jp, rank=RANK, alpha=alpha, iters=iters)
    tq, tad = tlora.loftq_init(tp, rank=RANK, alpha=alpha, iters=iters)
    got, want = _ab_products(tad), _ab_products(jad)
    assert set(got) == set(want) and len(got) == 4 * CFG.text.num_hidden_layers
    assert max(err_ratio(got[p], want[p]) for p in want) < 1e-4
    scale = alpha / RANK
    for i, (tl_, jl_) in enumerate(zip(tq["text"]["layers"], jq["text"]["layers"])):
        assert tl_["mlp"]["up"]["kernel"] is tp["text"]["layers"][i]["mlp"]["up"]["kernel"]
        for k in tlora.TARGETS:
            qi, ji = tl_[k]["kernel_q"].numpy().astype(int), np.asarray(jl_[k]["kernel_q"], int)
            assert tl_[k]["kernel_q"].dtype == torch.int8 and "kernel" not in tl_[k]
            assert np.abs(qi - ji).max() <= 1 and (qi != ji).mean() < 1e-3
            assert err_ratio(tl_[k]["scale"], jl_[k]["scale"]) < 1e-6
            w = tp["text"]["layers"][i][k]["kernel"].double()
            deq = tquant.dequantize_kernel(tl_[k], torch.float32).double()
            err = float(torch.linalg.norm(w - deq - scale * torch.from_numpy(
                got[f"text/layers/{i}/{k}"])))
            jdeq = np.asarray(jquant.dequantize_kernel(jl_[k], jnp.float32), np.float64)
            jerr = float(np.linalg.norm(w.numpy() - jdeq - scale * want[f"text/layers/{i}/{k}"]))
            plain = float(torch.linalg.norm(
                w - tquant.dequantize_kernel(tquant.quantize_kernel(w.float()), torch.float32)))
            assert abs(err - jerr) <= 1e-4 * jerr and err < plain, (i, k, err, jerr, plain)
    b = _batch(8)
    want_l = _logits_j(jlora.attach_lora(jq, jad, alpha, RANK), b["input_ids"],
                       b["position_ids"])
    with torch.no_grad():
        got_l = _logits_t(tlora.attach_lora(tq, tad, alpha, RANK), b["input_ids"],
                          b["position_ids"])
    assert err_ratio(got_l, want_l) < 1e-4
