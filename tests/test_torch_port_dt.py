"""Distillation (`stage: dt`) in the port against the JAX package on the
CPU in fp32: the attention -> DeltaNet conversion, the masks and the
stage handoff filter leaf for leaf, the teacher's hidden states (<= 1e-5),
the stage 1 and stage 2 losses and every trainable leaf's gradient
(<= 1e-4 of jax.value_and_grad), one optimizer step of each stage (<= 1e-4
with the clip idle, frozen leaves and the teacher bit-unchanged), and
`run_dt` end to end with the handoff from stage 1 into stage 2.

The JAX student's fresh random mixers are carried across with
from_jax_numpy, so both sides start from the same numbers."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import err_ratio, to_port_config
from torch_port_helpers import jax_compile_cache  # noqa: F401 (autouse)

import infinitevl_tpu.models.convert as jconvert
import infinitevl_tpu.train.distill as jdistill
import infinitevl_tpu.train.step as jstep
import infinitevl_tpu.utils.checkpoint as jckpt
import infinitevl_tpu_torch.hparams as thparams
import infinitevl_tpu_torch.models.convert as tconvert
import infinitevl_tpu_torch.train.distill as tdistill
import infinitevl_tpu_torch.train.trainer as ttrainer
import infinitevl_tpu_torch.utils.checkpoint as tckpt
from infinitevl_tpu.config import FULL, tiny_config
from infinitevl_tpu.models.infinitevl import get_rope_index as jrope_index
from infinitevl_tpu.models.params import init_params as jinit_params
from infinitevl_tpu.models.text import embed_tokens as jembed
from infinitevl_tpu.models.text import lm_head as jlm_head
from infinitevl_tpu.models.text import text_forward as jtext_forward
from infinitevl_tpu_torch.models.params import from_jax_numpy, init_text_params
from infinitevl_tpu_torch.models.text import embed_tokens as tembed
from infinitevl_tpu_torch.train.step import (
    make_optimizer,
    trainable_leaves,
    tree_leaves_with_path,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = tiny_config()
N = 4
SOFTMAX = (0,)
TEACHER_CFG = dataclasses.replace(CFG.text, num_hidden_layers=N, layer_types=(FULL,) * N)
FULL_CFG = dataclasses.replace(CFG, text=TEACHER_CFG)
T = 24  # > recurrent_threshold 8 (the chunk path) and > sliding_window 16
TOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    return dict(tree_leaves_with_path(tree))


def _jleaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _jleaves(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _jleaves(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


@pytest.fixture(scope="module")
def models():
    """JAX teacher (full tree) and student, and their port twins."""
    jfull = jinit_params(jax.random.PRNGKey(0), FULL_CFG, jnp.float32)
    jstudent, jscfg = jconvert.convert_attention(jfull["text"], TEACHER_CFG,
                                                 jax.random.PRNGKey(1), softmax_attention=SOFTMAX)
    return dict(jfull=jfull, jstudent=jstudent, jscfg=jscfg,
                tfull=from_jax_numpy(_np(jfull), "cpu"),
                tstudent=from_jax_numpy(_np(jstudent), "cpu"),
                tscfg=to_port_config(dataclasses.replace(CFG, text=jscfg)).text,
                ttcfg=to_port_config(FULL_CFG).text)


def _batch(packed: bool, seed=0, B=2):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, CFG.text.vocab_size - 8, (B, T))
    seg = np.ones((B, T), np.int32)
    if packed:
        seg[:, 9:17] = 2
        seg[:, 17:] = 3
        seg[1, 21:] = 0
    pos = np.zeros((B, T), np.int64)
    for r in range(B):
        for t in range(1, T):
            pos[r, t] = pos[r, t - 1] + 1 if seg[r, t] == seg[r, t - 1] else 0
    labels = np.where((rng.uniform(size=(B, T)) < 0.7) & (seg > 0), ids, -100)
    return dict(input_ids=ids, labels=labels,
                position_ids=np.broadcast_to(pos[None], (3, B, T)).copy(), segment_ids=seg)


def _mm_batch(seed=3):
    """One row with a 1x4x4-patch image (4 tokens) among text, 3 pads at its tail."""
    rng = np.random.RandomState(seed)
    ids = np.concatenate([rng.randint(0, CFG.text.vocab_size - 8, 5),
                          [CFG.vision_start_token_id], [CFG.image_token_id] * 4,
                          [CFG.vision_end_token_id], rng.randint(0, CFG.text.vocab_size - 8, 10),
                          np.zeros(3, np.int64)])[None]
    am = (np.arange(ids.shape[1])[None] < ids.shape[1] - 3).astype(np.int64)
    pos, _ = jrope_index(CFG, ids, np.array([[1, 4, 4]]), attention_mask=am)
    return dict(input_ids=ids, labels=np.where(am > 0, ids, -100), position_ids=np.asarray(pos),
                segment_ids=am.astype(np.int32),
                pixel_values=rng.standard_normal((16, 3 * 2 * 14 * 14)).astype(np.float32))


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _t(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


# ---------------------------------------------------------------- conversion


def test_convert_attention_structure_and_masks_match_jax(models):
    tt = models["tfull"]["text"]
    student, scfg = tconvert.convert_attention(tt, models["ttcfg"],
                                               torch.Generator().manual_seed(1),
                                               softmax_attention=SOFTMAX)
    assert scfg == models["tscfg"]
    js = models["jstudent"]
    assert [sorted(lp) for lp in student["layers"]] == [sorted(lp) for lp in js["layers"]]
    assert sorted(student) == sorted(js)
    # kept tensors are the teacher's own (shared, not copied); containers are new
    for i, lp in enumerate(student["layers"]):
        assert lp is not tt["layers"][i] and lp["mlp"] is not tt["layers"][i]["mlp"]
        assert lp["mlp"]["up"]["kernel"] is tt["layers"][i]["mlp"]["up"]["kernel"]
        assert lp["input_norm"] is tt["layers"][i]["input_norm"]
    assert student["layers"][0]["q_proj"]["kernel"] is tt["layers"][0]["q_proj"]["kernel"]
    assert student["embed"] is tt["embed"] and student is not tt
    assert student["layers"] is not tt["layers"]
    # the fresh mixers: shapes equal JAX's, the warm start's fixed parts equal
    jl = dict(_jleaves(js))
    for k, v in _leaves(student).items():
        assert tuple(v.shape) == np.asarray(jl[k]).shape, k
        if k.split("/", 2)[-1] in ("conv_q_w", "conv_k_w", "conv_v_w", "A_log",
                                   "a_proj/kernel", "b_proj/kernel"):
            assert torch.equal(v, torch.from_numpy(np.array(jl[k]))), k
    # masks and the handoff filter, leaf for leaf
    ts = models["tstudent"]
    want = dict(_jleaves(jconvert.trainable_mask(js, models["jscfg"], softmax_attention=SOFTMAX)))
    got = dict(tdistill._mask_leaves(tconvert.trainable_mask(ts, models["tscfg"],
                                                             softmax_attention=SOFTMAX)))
    assert got == {k: bool(v) for k, v in want.items()} and any(got.values())
    jf = jckpt.filter_softmax_layers(js, SOFTMAX)
    tf = tckpt.filter_softmax_layers(ts, SOFTMAX)
    assert sorted(dict(_jleaves(jf))) == sorted(_leaves(tf))
    assert "q_proj" not in tf["layers"][0] and "mlp" in tf["layers"][0]


def test_llama_pro_expand_and_gqa_order_match_jax(models):
    jt, tt = models["jfull"]["text"], models["tfull"]["text"]
    jexp, jcfg = jconvert.llama_pro_expand(jt, TEACHER_CFG, 2)
    texp, tcfg = tconvert.llama_pro_expand(tt, models["ttcfg"], 2)
    assert tcfg == to_port_config(dataclasses.replace(CFG, text=jcfg)).text
    jl, tl = dict(_jleaves(jexp)), _leaves(texp)
    assert set(jl) == set(tl)
    for k, v in tl.items():
        assert torch.equal(v, torch.from_numpy(np.array(jl[k]))), k
    # the copies are new tensors: the originals keep their o_proj
    assert texp["layers"][2]["o_proj"]["kernel"] is not tt["layers"][1]["o_proj"]["kernel"]
    assert tt["layers"][1]["o_proj"]["kernel"].abs().sum() > 0
    jm = dict(_jleaves(jconvert.expansion_trainable_mask(jexp, jcfg, 2)))
    tm = dict(tdistill._mask_leaves(tconvert.expansion_trainable_mask(texp, tcfg, 2)))
    assert tm == {k: bool(v) for k, v in jm.items()}
    # GQA expansion (kept for the mamba2 conversion): repeat_interleave order
    k = jt["layers"][0]["k_proj"]
    jw, jb = jconvert._gqa_expand(k["kernel"], k["bias"], 2, 16, 2)
    tk = tt["layers"][0]["k_proj"]
    tw, tb = tconvert._gqa_expand(tk["kernel"], tk["bias"], 2, 16, 2)
    assert torch.equal(tw, torch.from_numpy(np.array(jw)))
    assert torch.equal(tb, torch.from_numpy(np.array(jb)))


def test_mamba2_mixer_raises_by_name(models):
    """The mamba2 mixer used to raise here; it is ported now: the student
    has JAX's structure and layer types, its q / o are the teacher's own
    tensors and its k / v their GQA expansion (the weight copy is held
    against JAX in tests/test_torch_port_mamba2.py). An unknown mixer still
    raises by name."""
    tt = models["tfull"]["text"]
    student, scfg = tconvert.convert_attention(tt, models["ttcfg"], torch.Generator().manual_seed(1),
                                               softmax_attention=SOFTMAX, mixer="mamba2")
    js, jscfg = jconvert.convert_attention(models["jfull"]["text"], TEACHER_CFG,
                                           jax.random.PRNGKey(1), softmax_attention=SOFTMAX,
                                           mixer="mamba2")
    assert scfg == to_port_config(dataclasses.replace(CFG, text=jscfg)).text
    assert scfg.layer_types == ("sliding_attention",) + ("mamba2",) * (N - 1)
    jl = dict(_jleaves(js))
    assert {k: tuple(v.shape) for k, v in _leaves(student).items()} == \
        {k: np.asarray(v).shape for k, v in jl.items()}
    lp, tp = student["layers"][1], tt["layers"][1]
    assert lp["q_proj"]["kernel"] is tp["q_proj"]["kernel"]
    assert lp["o_proj"]["kernel"] is tp["o_proj"]["kernel"]
    assert torch.equal(lp["k_proj"]["kernel"], tconvert._gqa_expand(
        tp["k_proj"]["kernel"], None, 2, 16, 2)[0])
    with pytest.raises(NotImplementedError, match="available mixers"):
        tconvert.convert_attention(models["tfull"]["text"], models["ttcfg"], None, mixer="rwkv")


# ---------------------------------------------------------------- losses


@pytest.mark.parametrize("packed", [False, True], ids=["single", "packed"])
def test_teacher_io_and_stage1_loss_grads_match_jax(models, packed):
    b = _batch(packed)
    jseg = jnp.asarray(b["segment_ids"]) if packed else None
    tseg = torch.from_numpy(b["segment_ids"]) if packed else None
    jt, tt = models["jfull"]["text"], models["tfull"]["text"]
    jh = jax.jit(jdistill.teacher_layer_io, static_argnums=1)(
        jt, TEACHER_CFG, jembed(jt, jnp.asarray(b["input_ids"])),
        jnp.asarray(b["position_ids"]), jseg)
    th = tdistill.teacher_layer_io(tt, models["ttcfg"], tembed(tt, torch.from_numpy(
        b["input_ids"])), torch.from_numpy(b["position_ids"]), tseg)
    assert len(th) == len(jh) == N + 2
    assert max(err_ratio(a, w) for a, w in zip(th, jh)) < 1e-5
    # the loss and the gradient of every leaf the stage trains
    ts = models["tstudent"]
    mask = tconvert.trainable_mask(ts, models["tscfg"], softmax_attention=SOFTMAX)
    n = tdistill.apply_trainable_mask(ts, mask)
    want, jg = jax.jit(jax.value_and_grad(jdistill.stage1_loss), static_argnums=(1, 4))(
        models["jstudent"], models["jscfg"], jh, jnp.asarray(b["position_ids"]), 10.0, jseg)
    got = tdistill.stage1_loss(ts, models["tscfg"], th, torch.from_numpy(b["position_ids"]),
                               10.0, tseg)
    named = trainable_leaves(ts)
    grads = torch.autograd.grad(got, [t for _, t in named])
    jgl = dict(_jleaves(jg))
    assert len(named) == n > 0
    assert abs(float(got.detach()) - float(want)) <= TOL * abs(float(want))
    assert max(err_ratio(g, jgl[p]) for (p, _), g in zip(named, grads)) < TOL


def _jstage2_loss(sp, scfg, t_text, full, batch, with_labels, grid):
    """JAX stage 2's loss as its step computes it (train/distill.py)."""
    pos, seg = batch["position_ids"], batch["segment_ids"]
    if full is not None:
        embeds_of = lambda p: jdistill._mm_embeds(p, full, FULL_CFG, batch, grid, None)
    else:
        embeds_of = lambda p: jembed(p, batch["input_ids"])
    t_hidden, _, _ = jtext_forward(t_text, TEACHER_CFG, embeds_of(t_text), pos, None, seg)
    t_logits = jlm_head(t_text, TEACHER_CFG, t_hidden)
    s_hidden, _, _ = jtext_forward(sp, scfg, embeds_of(sp), pos, None, seg)
    s_logits = jlm_head(sp, scfg, s_hidden)
    mask = (batch["labels"] != -100).astype(jnp.float32) if with_labels else None
    loss = jstep.kl_distill_loss(s_logits, t_logits, 2.0, mask)
    if with_labels:
        loss = loss + jstep.cross_entropy_loss(s_logits, batch["labels"])
    return loss


@pytest.mark.parametrize("with_labels", [True, False], ids=["labels", "no_labels"])
@pytest.mark.parametrize("kind", ["text", "mm"])
def test_stage2_loss_grads_match_jax(models, kind, with_labels):
    b = _mm_batch() if kind == "mm" else _batch(True, seed=1)
    grid = ((1, 4, 4),) if kind == "mm" else None
    jfull = models["jfull"] if kind == "mm" else None
    want, jg = jax.jit(jax.value_and_grad(_jstage2_loss), static_argnums=(1, 5, 6))(
        models["jstudent"], models["jscfg"], models["jfull"]["text"], jfull, _j(b),
        with_labels, grid)
    tfull, ts = models["tfull"], models["tstudent"]
    tdistill.apply_trainable_mask(ts, tdistill.stage2_mask(ts))
    tb = _t(b)
    tt = tfull["text"]
    feats = tdistill.vision_features(tfull, to_port_config(FULL_CFG), tb, grid, None) \
        if kind == "mm" else {}
    embeds_of = (lambda p: tdistill._mm_embeds(p, to_port_config(FULL_CFG), tb["input_ids"],
                                               feats)) if kind == "mm" else \
        (lambda p: tembed(p, tb["input_ids"]))
    from infinitevl_tpu_torch.models.text import lm_head, text_forward

    with torch.no_grad():
        t_hidden, _ = text_forward(tt, models["ttcfg"], embeds_of(tt), tb["position_ids"], None,
                                   tb["segment_ids"])
        t_logits = lm_head(tt, models["ttcfg"], t_hidden)
    got = tdistill.stage2_loss(ts, models["tscfg"], embeds_of(ts), tb["position_ids"], t_logits,
                               tb["labels"] if with_labels else None, 2.0, tb["segment_ids"])
    named = trainable_leaves(ts)
    grads = torch.autograd.grad(got, [t for _, t in named], allow_unused=True)
    jgl = dict(_jleaves(jg))
    assert abs(float(got.detach()) - float(want)) <= TOL * abs(float(want))
    errs = {p: err_ratio(g, jgl[p]) for (p, _), g in zip(named, grads)
            if np.abs(np.asarray(jgl[p])).sum() > 0}
    assert len(errs) > len(named) // 2 and max(errs.values()) < TOL, max(errs.items(),
                                                                          key=lambda kv: kv[1])
    for (p, _), g in zip(named, grads):  # a leaf JAX gives no gradient gets none here
        if np.abs(np.asarray(jgl[p])).sum() == 0:
            assert g is None or float(g.abs().sum()) == 0.0, p


# ---------------------------------------------------------------- steps


def _snapshot(tree):
    return {k: v.detach().clone() for k, v in tree_leaves_with_path(tree)}


@pytest.mark.parametrize("stage", [1, 2])
def test_one_step_of_each_stage_matches_jax(models, stage):
    """One optimizer step (lr 1e-3, the clip idle): the student within 1e-4
    of JAX's; the teacher and the student's frozen leaves bit-unchanged,
    though the student shares them with the teacher. A leaf that is zero
    before the step (a bias) holds the AdamW update alone afterwards,
    g / (|g| + eps) x lr per element, which maps rounding noise in a
    vanishing gradient to +-lr on either side: such leaves are held by
    their gradients (test_stage2_loss_grads_match_jax), not here."""
    b = _batch(True, seed=2)
    tx_j = jstep.make_optimizer(1e-3, grad_clip=1e9)
    tx_t = make_optimizer(1e-3, grad_clip=1e9)
    js, jscfg = models["jstudent"], models["jscfg"]
    # the port converts its own teacher (sharing its tensors) and takes the
    # JAX student's random mixers, so both start from the same numbers
    tfull = from_jax_numpy(_np(models["jfull"]), "cpu")
    tt = tfull["text"]
    ts, tscfg = tconvert.convert_attention(tt, models["ttcfg"], torch.Generator().manual_seed(1),
                                           softmax_attention=SOFTMAX)
    carried = from_jax_numpy(_np(js), "cpu")
    for i in range(1, N):
        for k in carried["layers"][i]:
            if k not in ("mlp", "input_norm", "post_norm"):
                ts["layers"][i][k] = carried["layers"][i][k]
    teacher0 = _snapshot(tfull)
    if stage == 1:
        mask = jconvert.trainable_mask(js, jscfg, softmax_attention=SOFTMAX)
        jtx = jdistill.apply_trainable_mask(tx_j, mask)
        jstep_fn = jdistill.make_stage1_step(jscfg, TEACHER_CFG, jtx, 10.0)
        tmask = tconvert.trainable_mask(ts, tscfg, softmax_attention=SOFTMAX)
        tstep_fn = tdistill.make_stage1_step(tscfg, models["ttcfg"], tx_t, 10.0)
    else:
        jtx = tx_j
        jstep_fn = jdistill.make_stage2_step(jscfg, TEACHER_CFG, jtx, 2.0)
        tmask = tdistill.stage2_mask(ts)
        tstep_fn = tdistill.make_stage2_step(tscfg, models["ttcfg"], tx_t, 2.0)
    tdistill.apply_trainable_mask(ts, tmask, tfull)
    student0 = _snapshot(ts)
    frozen = {p for p, on in tdistill._mask_leaves(tmask) if not on}
    jnew, _, jloss = jax.jit(jstep_fn)(js, jtx.init(js), models["jfull"]["text"], _j(b))
    _, _, tloss = tstep_fn(ts, tx_t.init(ts), tt, dict(b))
    assert abs(float(tloss) - float(jloss)) <= TOL * abs(float(jloss))
    jl = dict(_jleaves(jnew))
    moved = 0
    for p, v in tree_leaves_with_path(ts):
        if p in frozen:
            assert torch.equal(v, student0[p]), p
            continue
        moved += not torch.equal(v, student0[p])
        if student0[p].abs().sum() > 0:
            assert err_ratio(v.detach(), jl[p]) < TOL, p
    # stage 2 trains every leaf but rope's derived inv_freq, which JAX moves
    assert moved > 0 and (frozen == {"inv_freq"}) == (stage == 2)
    assert all(torch.equal(v, teacher0[p]) for p, v in tree_leaves_with_path(tfull))


# ---------------------------------------------------------------- run_dt


def _dt_args(tmp_path, name, **over):
    args = thparams.load_yaml_args(os.path.join(REPO, "examples", "dt_stage1_tiny.yaml"))
    args.data.dataset_dir = os.path.join(REPO, "data")
    args.train.output_dir = str(tmp_path / name)
    for key, val in over.items():
        group = next(g for g in (args.data, args.train, args.finetune) if hasattr(g, key))
        setattr(group, key, val)
    return args


def _losses(out_dir):
    return [r["loss"] for r in map(json.loads, open(os.path.join(out_dir, "trainer_log.jsonl")))
            if "loss" in r]


def test_run_dt_stage1_then_stage2_handoff(tmp_path):
    """dt_stage1_tiny.yaml end to end: finite losses that fall; then stage 2
    from its checkpoint: with lr 0 the handed-over student is stage 1's,
    its preserved layers' attention the teacher's; with lr 1e-3 two finite
    steps; the multimodal recipe (mllm_demo) runs both stages."""
    a1 = _dt_args(tmp_path, "s1")
    s1 = ttrainer.run_exp(a1, device="cpu")
    l1 = _losses(a1.train.output_dir)
    assert len(l1) == 4 and np.isfinite(l1).all() and l1[-1] < l1[0], l1
    handoff = os.path.join(a1.train.output_dir, "checkpoints")
    a2 = _dt_args(tmp_path, "s2", distill_stage=2, checkpoint_path=handoff, max_steps=1,
                  learning_rate=0.0)
    s2 = ttrainer.run_exp(a2, device="cpu")
    cfg = ttrainer.build_config(a2)
    teacher_cfg = dataclasses.replace(cfg.text,
                                      layer_types=("full_attention",) * cfg.text.num_hidden_layers)
    teacher = init_text_params(teacher_cfg, torch.Generator().manual_seed(a2.train.seed), "cpu",
                               torch.float32)
    soft = set(a2.finetune.softmax_attention)
    for i, (lp1, lp2) in enumerate(zip(s1["layers"], s2["layers"])):
        for k, v in lp2.items():
            if k == "mlp":
                continue
            ref = teacher["layers"][i][k] if i in soft else lp1[k]
            for (_, x), (_, y) in zip(tree_leaves_with_path(v), tree_leaves_with_path(ref)):
                assert torch.equal(x, y), (i, k)
    a3 = _dt_args(tmp_path, "s2b", distill_stage=2, checkpoint_path=handoff, max_steps=2)
    ttrainer.run_exp(a3, device="cpu")
    assert np.isfinite(_losses(a3.train.output_dir)).all()
    for stage in (1, 2):
        am = _dt_args(tmp_path, f"mm{stage}", distill_stage=stage, dataset="mllm_demo",
                      cutoff_len=512, max_steps=1, max_samples=1,
                      image_min_pixels=56 * 56 * 4, image_max_pixels=56 * 56 * 4)
        ttrainer.run_exp(am, device="cpu")
        assert np.isfinite(_losses(am.train.output_dir)).all()
