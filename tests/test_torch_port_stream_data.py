"""Streaming datasets (`streaming: true`) against the JAX package: the lazy
mixer, the lazy encoder, the reservoir collator with and without windowed
packing, the streaming val split and build_dataset_stream's constraint
set give exactly JAX's rows and batches, and run_exp SFT on a stream takes
JAX's steps (losses within 1e-4, fp32, from the same weights)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_port_helpers import jax_compile_cache  # noqa: F401 (autouse)

import infinitevl_tpu.data.loader as jloader
import infinitevl_tpu.hparams as jhparams
import infinitevl_tpu.train.trainer as jtrainer
import infinitevl_tpu_torch.data.loader as tloader
import infinitevl_tpu_torch.hparams as thparams
import infinitevl_tpu_torch.train.trainer as ttrainer
from infinitevl_tpu.config import tiny_config
from infinitevl_tpu.models.params import init_params
from infinitevl_tpu_torch.models.params import from_jax_numpy

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data")


def _rows(tmp_path):
    (tmp_path / "a.jsonl").write_text("\n".join(
        json.dumps({"instruction": f"a{i}", "output": "x " * i}) for i in range(4)))
    (tmp_path / "b.jsonl").write_text("\n".join(
        json.dumps({"instruction": f"b{i}", "output": "y " * i}) for i in range(9)))
    return {n: (jloader.DatasetAttr(name=n, file_name=f"{n}.jsonl"),
                tloader.DatasetAttr(name=n, file_name=f"{n}.jsonl")) for n in "ab"}


@pytest.mark.parametrize("strategy,probs", [
    ("concat", None), ("interleave_under", [0.5, 0.5]), ("interleave_over", [0.7, 0.3])])
def test_stream_mixed_examples_equal_jax(tmp_path, strategy, probs):
    reg = _rows(tmp_path)
    kw = dict(mix_strategy=strategy, interleave_probs=probs, seed=3)
    want = list(jloader.stream_mixed_examples(["a", "b"], {n: a[0] for n, a in reg.items()},
                                              str(tmp_path), **kw))
    got = list(tloader.stream_mixed_examples(["a", "b"], {n: a[1] for n, a in reg.items()},
                                             str(tmp_path), **kw))
    assert got == want and len(got) > 4
    # the lazy mixer is the materialized one's sequence
    assert got == tloader.load_mixed_examples(["a", "b"], {n: a[1] for n, a in reg.items()},
                                              str(tmp_path), **kw)
    assert list(tloader.iter_examples(reg["b"][1], str(tmp_path))) == list(
        jloader.iter_examples(reg["b"][0], str(tmp_path)))


def test_encode_supervised_stream_equals_jax_and_refuses_media():
    exs = [{"messages": [{"role": "user", "content": f"hello {i}"},
                         {"role": "assistant", "content": f"world {i} " * i}]} for i in range(5)]
    want = list(jloader.encode_supervised_stream(iter(exs), jloader.SimpleTokenizer(),
                                                 "qwen2_vl", 12))
    got = list(tloader.encode_supervised_stream(iter(exs), tloader.SimpleTokenizer(),
                                                "qwen2_vl", 12))
    assert len(got) == len(want) == 5
    for w, g in zip(want, got):
        assert w.keys() == g.keys()
        for k in w:
            np.testing.assert_array_equal(w[k], g[k])
    mm = [{"messages": [{"role": "user", "content": "<image> hi"}], "images": ["x.png"]}]
    with pytest.raises(ValueError, match="text-only"):
        list(tloader.encode_supervised_stream(iter(mm), tloader.SimpleTokenizer(), "qwen2_vl",
                                              64))


def _args(mod, **over):
    conf = dict(stage="sft", config_preset="tiny", dataset="demo,demo_chat",
                dataset_dir=DATA, streaming=True, max_steps=4, cutoff_len=48,
                mix_strategy="interleave_over", interleave_probs=[0.6, 0.4])
    conf.update(over)
    return mod.parse_args(conf)


def _equal_batches(want, got):
    want, got = list(want), list(got)
    assert len(got) == len(want) > 0
    for w, g in zip(want, got):
        assert w.keys() == g.keys()
        for k in w:
            a, b = np.asarray(w[k]), np.asarray(g[k])
            assert a.shape == b.shape and a.dtype.kind == b.dtype.kind, k
            np.testing.assert_array_equal(a, b, err_msg=k)
    return len(got)


@pytest.mark.parametrize("packing", [False, True], ids=["rows", "packed"])
@pytest.mark.parametrize("buffer_size", [3, 16384])
def test_collate_stream_over_build_dataset_stream_equals_jax(buffer_size, packing):
    """The whole streaming pipeline (the mix of demo and demo_chat, encoded
    lazily, the reservoir, windowed packing) yields JAX's batches."""
    kw = dict(seed=5, buffer_size=buffer_size, packing=packing)
    want = jtrainer.collate_stream(jtrainer.build_dataset_stream(_args(jhparams)), 3, 48, **kw)
    got = ttrainer.collate_stream(ttrainer.build_dataset_stream(_args(thparams)), 3, 48, **kw)
    n = _equal_batches(want, got)
    assert n >= 2


def test_split_val_streaming_equals_jax():
    args_j, args_t = _args(jhparams, val_size=3), _args(thparams, val_size=3)
    rows = lambda: ({"input_ids": np.array([i]), "labels": np.array([i])} for i in range(10))
    jtrain, jeval = jtrainer._split_val(args_j, rows(), mm=False)
    ttrain, teval = ttrainer._split_val(args_t, rows(), mm=False)
    assert [int(e["input_ids"][0]) for e in teval] == [int(e["input_ids"][0]) for e in jeval] \
        == [0, 1, 2]
    assert [int(e["input_ids"][0]) for e in ttrain] == [int(e["input_ids"][0]) for e in jtrain]


@pytest.mark.parametrize("over,match", [
    (dict(stage="dt"), "sft/pt"),
    (dict(max_steps=None), "max_steps"),
    (dict(max_samples=10), "max_samples"),
    (dict(val_size=0.1), "val_size"),
], ids=["stage", "max_steps", "max_samples", "fractional_val_size"])
def test_build_dataset_stream_refuses_jax_constraint_set(over, match):
    for mod, trainer in ((jhparams, jtrainer), (thparams, ttrainer)):
        with pytest.raises(ValueError, match=match):
            trainer.build_dataset_stream(_args(mod, **over))


def test_run_exp_streaming_matches_jax_losses(tmp_path, monkeypatch):
    """sft_tiny.yaml with streaming: true (a reservoir of 8 rows), the tiny
    preset cut to two layers, the same weights on both sides and rope's
    inv_freq frozen in JAX's optimizer as the port's full finetuning leaves
    it: four steps, each loss within 1e-4 of JAX's."""
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, num_hidden_layers=2, layer_types=cfg.text.layer_types[:2]))
    text = init_params(jax.random.PRNGKey(0), cfg, jnp.float32)["text"]
    text_np = jax.tree.map(np.asarray, text)
    real_tx = jtrainer._make_tx

    def make_tx(args, steps):
        label = lambda tree: jax.tree_util.tree_map_with_path(
            lambda p, _: "frozen" if getattr(p[-1], "key", None) == "inv_freq" else "train",
            tree)
        return optax.multi_transform({"train": real_tx(args, steps),
                                      "frozen": optax.set_to_zero()}, label)

    monkeypatch.setattr(jtrainer, "tiny_config", lambda: cfg)
    monkeypatch.setattr(jtrainer, "_make_tx", make_tx)
    monkeypatch.setattr(jtrainer, "_load_or_init_params",
                        lambda args, c, mm, dtype: {"text": jax.tree.map(jnp.array, text)})
    from torch_port_ranks import tiny_cut

    monkeypatch.setattr(ttrainer, "tiny_config", tiny_cut)
    monkeypatch.setattr(ttrainer, "_load_or_init_params",
                        lambda args, c, mm, dtype, device: {"text": from_jax_numpy(text_np,
                                                                                   device)})
    losses = {}
    for name, mod, trainer in (("jax", jhparams, jtrainer), ("port", thparams, ttrainer)):
        args = mod.load_yaml_args(os.path.join(REPO, "examples", "sft_tiny.yaml"))
        args.data.dataset_dir = DATA
        args.train.output_dir = str(tmp_path / name)
        args.data.streaming, args.data.buffer_size, args.data.packing = True, 8, False
        args.train.max_steps, args.train.logging_steps = 4, 1
        if name == "port":
            trainer.run_exp(args, device="cpu")
        else:
            trainer.run_exp(args)
        losses[name] = [r["loss"] for r in map(json.loads, open(
            tmp_path / name / "trainer_log.jsonl")) if "loss" in r]
    want, got = losses["jax"], losses["port"]
    assert len(got) == len(want) == 4
    assert max(abs(a - b) / abs(b) for a, b in zip(got, want)) < 1e-4, (got, want)
