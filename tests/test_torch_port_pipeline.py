"""Pipeline parallelism in one process (parallel/pipeline.py and
parallel/pipeline_seq.py with no pipe mesh: every stage in turn) on the
CPU in fp32, the tiny preset (8 layers: 2 pattern periods, 2 stages):

- against the JAX package on one shape each, the same weights (JAX's,
  carried across by models/params.from_jax_numpy) and the same numpy
  inputs: `pp_sft_loss_fn(mesh=None)`; `pp_sft_value_and_grad_1f1b`'s loss
  and every gradient (JAX's stage-stacked tree through from_jax_numpy;
  inv_freq, which the port keeps frozen, masked); `seq_pp_sft_loss_fn`
  with packed segment ids. Losses within 1e-5 relative, gradients within
  1e-4 err_ratio (JAX's own pipeline tests: rtol 2e-4, atol 1e-6);
- against the port's plain `sft_loss_fn` (itself held against JAX by
  tests/test_torch_port_train.py), at (S, M) = (2, 2) and (2, 4), with and
  without packed segment ids: the losses of pp_sft_loss_fn, GPipe and
  1F1B, and their gradients (1F1B's equal to GPipe's within 1e-6), and the
  sequence axis's;
- the stage cut: stacking then unstacking returns the same layers, JAX's
  stage_stacks unstack to JAX's own per-layer layers, and the cut's
  ValueErrors fire;
- `run_sft` with pipeline_stages 2 in one process trains (gpipe, 1f1b,
  sequence) the one-process steps, and `_run_sft_pipeline`'s checks raise
  JAX's ValueErrors (JAX's test_pp_yaml_validation_errors and
  test_seq_pp_yaml_validation_errors, plus multimodal data)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import err_ratio, to_port_config
from torch_port_helpers import jax_compile_cache  # noqa: F401 (autouse)

import infinitevl_tpu.parallel.pipeline as jpp
import infinitevl_tpu.parallel.pipeline_seq as jseq
import infinitevl_tpu_torch.parallel.pipeline as tpp
import infinitevl_tpu_torch.parallel.pipeline_seq as tseq
from infinitevl_tpu import tiny_config
from infinitevl_tpu.models.params import init_params
from infinitevl_tpu_torch.hparams import parse_args
from infinitevl_tpu_torch.models.params import from_jax_numpy
from infinitevl_tpu_torch.train.step import (
    full_finetune_leaf,
    set_trainable,
    sft_loss_fn,
    trainable_leaves,
    tree_leaves_with_path,
)
from infinitevl_tpu_torch.train.trainer import run_exp, run_sft

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
JCFG = tiny_config()
TCFG = to_port_config(JCFG).text


@pytest.fixture(scope="module")
def weights():
    """JAX's tiny text tree (fp32, key 1) as numpy, and the port's copy with
    full finetuning's trainable leaves."""
    text = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(1), JCFG,
                                                dtype=jnp.float32)["text"])
    return text


def _port(text_np):
    t = from_jax_numpy(text_np, "cpu")
    set_trainable({"text": t}, full_finetune_leaf)
    return t


def _batch(B, T, seed=0, packed=False, seq=False):
    """JAX's pipeline tests' batch; packed: two segments a row, the edge at
    T / 2 (batch axis) or T / 2 + 3 (off the sequence chunks' edges)."""
    rng = np.random.RandomState(seed)
    b = {"input_ids": rng.randint(0, JCFG.text.vocab_size - 8, (B, T)),
         "labels": rng.randint(0, JCFG.text.vocab_size - 8, (B, T)),
         "position_ids": np.ascontiguousarray(np.broadcast_to(np.arange(T)[None, None],
                                                              (3, B, T)))}
    if packed:
        cut = T // 2 + 3 if seq else T // 2
        b["segment_ids"] = np.where(np.arange(T) < cut, 1, 2)[None].repeat(B, 0).astype(
            np.int32)
    return b


def _args(b, torch_side=True):
    keys = ("input_ids", "labels", "position_ids")
    conv = torch.as_tensor if torch_side else jnp.asarray
    seg = b.get("segment_ids")
    return [conv(b[k]) for k in keys], None if seg is None else conv(seg)


def _by_path(pp, grads, n):
    """The stage cut's gradients by one-process path."""
    out = {}
    for (p, _), g in zip(trainable_leaves(pp), grads):
        parts = p.split("/")
        if parts[0] == "stage_layers":
            p = "/".join(["layers", str(int(parts[1]) * n + int(parts[2]))] + parts[3:])
        out[p] = g.detach().numpy()
    return out


def _plain(text, b):
    (ids, labels, pos), seg = _args(b)
    named = trainable_leaves(text)
    loss = sft_loss_fn(text, TCFG, ids, labels, pos, seg, remat=True)
    grads = torch.autograd.grad(loss, [t for _, t in named])
    return float(loss.detach()), {p: g.numpy() for (p, _), g in zip(named, grads)}


def _max_err(got, want, skip=()):
    assert got.keys() == want.keys(), set(got) ^ set(want)
    return max(err_ratio(got[k], v) for k, v in want.items() if k not in skip)


# ---------------------------------------------------------------- against JAX


def test_pp_loss_fn_matches_jax(weights):
    b = _batch(4, 16)
    (ids, labels, pos), _ = _args(b, torch_side=False)
    pp_j = jpp.stack_stage_params(jax.tree.map(jnp.asarray, weights), JCFG.text, 2)
    want = float(jax.jit(lambda p: jpp.pp_sft_loss_fn(p, JCFG.text, ids, labels, pos, 2))(pp_j))
    (ids, labels, pos), _ = _args(b)
    pp = tpp.stack_stage_params(_port(weights), TCFG, 2)
    got = float(tpp.pp_sft_loss_fn(pp, TCFG, ids, labels, pos, 2).detach())
    assert abs(got - want) <= LOSS_TOL * abs(want), (got, want)


def test_1f1b_loss_and_gradients_match_jax(weights):
    """JAX's hand-scheduled 1F1B against the port's: the loss and every
    leaf's gradient (JAX's stage_stacks carried across by from_jax_numpy);
    inv_freq, frozen in the port, is masked out of JAX's side."""
    b = _batch(4, 16, seed=1)
    (ids, labels, pos), _ = _args(b, torch_side=False)
    pp_j = jpp.stack_stage_params(jax.tree.map(jnp.asarray, weights), JCFG.text, 2)
    loss_j, g_j = jax.jit(lambda p: jpp.pp_sft_value_and_grad_1f1b(
        p, JCFG.text, ids, labels, pos, 2))(pp_j)
    want = {p: t.numpy() for p, t in tree_leaves_with_path(
        from_jax_numpy(jax.tree.map(np.asarray, g_j), "cpu")) if p != "inv_freq"}
    (ids, labels, pos), _ = _args(b)
    pp = tpp.stack_stage_params(_port(weights), TCFG, 2)
    loss, grads = tpp.pp_sft_value_and_grad_1f1b(pp, TCFG, ids, labels, pos, 2)
    assert abs(float(loss) - float(loss_j)) <= LOSS_TOL * abs(float(loss_j))
    assert _max_err(_by_path(pp, grads, 4), want) <= GRAD_TOL


def test_seq_pp_loss_fn_matches_jax_packed(weights):
    b = _batch(1, 4 * 2 * JCFG.text.sliding_window, seed=2, packed=True, seq=True)
    (ids, labels, pos), seg = _args(b, torch_side=False)
    pp_j = jpp.stack_stage_params(jax.tree.map(jnp.asarray, weights), JCFG.text, 2)
    want = float(jax.jit(lambda p: jseq.seq_pp_sft_loss_fn(
        p, JCFG.text, ids, labels, pos, 4, segment_ids=seg))(pp_j))
    (ids, labels, pos), seg = _args(b)
    pp = tpp.stack_stage_params(_port(weights), TCFG, 2)
    got = float(tseq.seq_pp_sft_loss_fn(pp, TCFG, ids, labels, pos, 4, segment_ids=seg)
                .detach())
    assert abs(got - want) <= LOSS_TOL * abs(want), (got, want)


# ---------------------------------------------------------------- against the plain loss


@pytest.mark.parametrize("packed", [False, True], ids=["rows", "packed"])
@pytest.mark.parametrize("micro", [2, 4])
def test_schedules_match_the_plain_loss(weights, micro, packed):
    """pp_sft_loss_fn, GPipe and 1F1B at S 2 against sft_loss_fn: losses,
    and every gradient (1F1B's equal to GPipe's)."""
    text = _port(weights)
    b = _batch(4, 16, seed=3, packed=packed)
    loss0, g0 = _plain(text, b)
    (ids, labels, pos), seg = _args(b)
    pp = tpp.stack_stage_params(text, TCFG, 2)
    got = float(tpp.pp_sft_loss_fn(pp, TCFG, ids, labels, pos, micro, seg).detach())
    assert abs(got - loss0) <= LOSS_TOL * loss0
    res = {}
    for name, fn in (("gpipe", tpp.pp_sft_value_and_grad_gpipe),
                     ("1f1b", tpp.pp_sft_value_and_grad_1f1b)):
        loss, grads = fn(pp, TCFG, ids, labels, pos, micro, seg)
        assert abs(float(loss) - loss0) <= LOSS_TOL * loss0, name
        res[name] = _by_path(pp, grads, 4)
        assert _max_err(res[name], g0) <= GRAD_TOL, name
    assert _max_err(res["1f1b"], res["gpipe"]) <= 1e-6


def test_sequence_axis_matches_the_plain_loss(weights):
    """The sequence axis (4 chunks of 2 windows, a segment edge off the
    chunk edges): the loss and every gradient, with the carries'
    gradients flowing chunk to chunk."""
    text = _port(weights)
    b = _batch(1, 4 * 2 * TCFG.sliding_window, seed=4, packed=True, seq=True)
    loss0, g0 = _plain(text, b)
    (ids, labels, pos), seg = _args(b)
    pp = tpp.stack_stage_params(text, TCFG, 2)
    loss, grads = tseq.seq_pp_sft_value_and_grad(pp, TCFG, ids, labels, pos, 4, seg)
    assert abs(float(loss) - loss0) <= LOSS_TOL * loss0
    assert _max_err(_by_path(pp, grads, 4), g0) <= GRAD_TOL


# ---------------------------------------------------------------- the stage cut


def test_stack_unstack_and_jax_stage_stacks(weights):
    text = _port(weights)
    pp = tpp.stack_stage_params(text, TCFG, 2)
    assert [len(s) for s in pp["stage_layers"]] == [4, 4]
    back = tpp.unstack_stage_params(pp)
    assert all(a is b for a, b in zip(back["layers"], text["layers"]))
    # JAX's stage-stacked tree comes across with its per-layer layers
    pp_j = jpp.stack_stage_params(weights, JCFG.text, 2)
    got = dict(tree_leaves_with_path(from_jax_numpy(jax.tree.map(np.asarray, pp_j), "cpu")))
    want = dict(tree_leaves_with_path(from_jax_numpy(
        jax.tree.map(np.asarray, jpp.unstack_stage_params(pp_j)), "cpu")))
    assert got.keys() == want.keys() and all(torch.equal(got[k], v) for k, v in want.items())


def test_stage_cut_errors(weights):
    text = _port(weights)
    with pytest.raises(ValueError, match="stages must divide"):
        tpp.stack_stage_params(text, TCFG, 3)
    import dataclasses

    # a pattern that repeats only as a whole is one period: 2 stages cannot cut it
    odd = dataclasses.replace(TCFG, layer_types=TCFG.layer_types[:7] + ("full_attention",))
    with pytest.raises(ValueError, match="2 stages must divide the 1 pattern periods"):
        tpp.stack_stage_params(text, odd, 2)
    with pytest.raises(ValueError, match="has no period"):
        tpp.stack_stage_params(dict(text, layers=[]), TCFG, 2)
    b = _batch(3, 16)
    (ids, labels, pos), _ = _args(b)
    pp = tpp.stack_stage_params(text, TCFG, 2)
    with pytest.raises(ValueError, match="not divisible by 2 microbatches"):
        tpp.pp_sft_value_and_grad_1f1b(pp, TCFG, ids, labels, pos, 2)
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        tpp.make_pp_sft_train_step(TCFG, None, 2, schedule="x", n_stages=2)
    b = _batch(1, 3 * TCFG.sliding_window + 1)
    (ids, labels, pos), _ = _args(b)
    with pytest.raises(ValueError, match="divisible"):
        tseq.seq_pp_sft_loss_fn(pp, TCFG, ids, labels, pos, 2)
    b = _batch(1, 2 * TCFG.sliding_window)
    (ids, labels, pos), _ = _args(b)
    with pytest.raises(ValueError, match="multiple of the sliding"):
        tseq.seq_pp_sft_loss_fn(pp, TCFG, ids, labels, pos, 4)


# ---------------------------------------------------------------- run_sft


def _conf(out, **over):
    import yaml

    conf = yaml.safe_load(open(os.path.join(REPO, "examples", "sft_pp_tiny.yaml")))
    conf.update(dataset_dir=os.path.join(REPO, "data"), output_dir=str(out), max_steps=2,
                num_train_epochs=2.0, logging_steps=1, save_steps=1000, data_parallel=1,
                model_parallel=1, per_device_train_batch_size=4)
    conf.update(over)
    return conf


def _losses(out):
    return [r["loss"] for r in map(json.loads, open(os.path.join(out, "trainer_log.jsonl")))
            if "loss" in r]


@pytest.mark.parametrize("over", [
    {}, dict(pipeline_schedule="1f1b"),
    dict(pp_microbatch_axis="sequence", per_device_train_batch_size=2),
], ids=["gpipe", "1f1b", "sequence"])
def test_run_sft_pipelined_in_one_process(tmp_path, over):
    """pipeline_stages 2 in a world of one: every stage in turn, the
    one-process run's step losses and weights (within 1e-5 / 1e-4)."""
    plain = dict(over, pipeline_stages=1)
    plain.pop("pipeline_schedule", None)
    plain.pop("pp_microbatch_axis", None)
    want = run_exp(parse_args(_conf(tmp_path / "one", **plain)), device="cpu")
    got = run_exp(parse_args(_conf(tmp_path / "pp", **over)), device="cpu")
    lw, lg = _losses(tmp_path / "one"), _losses(tmp_path / "pp")
    assert len(lw) == len(lg) == 2
    assert max(abs(a - b) / abs(b) for a, b in zip(lg, lw)) <= LOSS_TOL, (lg, lw)
    g, w = dict(tree_leaves_with_path(got)), dict(tree_leaves_with_path(want))
    assert len(got["text"]["layers"]) == 8
    assert max(err_ratio(g[k], v) for k, v in w.items() if not k.endswith("k_proj/bias")) \
        <= GRAD_TOL


_BASE = {"config_preset": "tiny", "stage": "sft", "dataset": "demo", "cutoff_len": 32,
         "max_steps": 1, "bf16": False, "pipeline_stages": 2,
         "per_device_train_batch_size": 2}


@pytest.mark.parametrize("over,match", [
    (dict(finetuning_type="lora"), "finetuning_type: full"),
    (dict(finetuning_type="full", per_device_train_batch_size=3, n_microbatches=2),
     "divisible by n_microbatches"),
    # the port's own: each data rank splits its rows (JAX splits the global batch)
    (dict(finetuning_type="full", data_parallel=2, n_microbatches=4),
     "a data rank's 2 rows must be divisible by n_microbatches 4"),
    (dict(finetuning_type="full", quantization_bit=8), "QLoRA"),
    (dict(finetuning_type="full", cutoff_len=64, pp_microbatch_axis="sequence",
          pipeline_schedule="1f1b"), "gpipe schedule only"),
    (dict(finetuning_type="full", cutoff_len=40, n_microbatches=2,
          pp_microbatch_axis="sequence"), "multiples of the sliding"),
    (dict(finetuning_type="full", cutoff_len=64, pp_microbatch_axis="tokens"),
     "batch | sequence"),
    (dict(finetuning_type="full", dataset="mllm_demo", max_samples=1, cutoff_len=256,
          image_min_pixels=28 * 28, image_max_pixels=56 * 56), "text-only"),
], ids=["lora", "batch_not_divisible", "rank_rows_not_divisible", "qlora", "sequence_1f1b",
        "sequence_chunk", "unknown_axis", "multimodal"])
def test_run_sft_pipeline_refusals(tmp_path, over, match):
    """JAX's checks of _run_sft_pipeline, as ValueErrors with their
    conditions (JAX's test_pp_yaml_validation_errors and
    test_seq_pp_yaml_validation_errors, and multimodal data)."""
    conf = dict(_BASE, dataset_dir=os.path.join(REPO, "data"), output_dir=str(tmp_path),
                **over)
    with pytest.raises(ValueError, match=match):
        run_sft(parse_args(conf), device="cpu")
