"""The sequence-chunked layers of long-context training against the JAX
package on the CPU in fp32, at a tiny config (window 16, delta_seq_chunk_t
32, delta_seq_chunk_eval 16, mlp_chunk_t 16, delta_chunk_size 8): the
same numpy inputs through JAX's function and the port's, outputs within
1e-5 and every gradient (the input's, each leaf's, the carried state's)
within 1e-4 (err_ratio). Rows: one sequence, one padded at its tail, and
packed segments, one of which spans a chunk edge; T a multiple of the
chunk and T with a pad. Then the dispatch on and off against the port's
full-T path, and SFT steps at a cutoff above delta_seq_chunk_t against
JAX's trainer. The conv with the history's ids, the chunked MLP and the
layer chunk from a carry are in test_torch_port_longctx_layers.py."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import carry_train_state, err_ratio, to_port_config
from torch_port_helpers import jax_compile_cache  # noqa: F401 (autouse)

import infinitevl_tpu.models.text as jtext
import infinitevl_tpu.train.step as jstep
import infinitevl_tpu.train.trainer as jtrainer
import infinitevl_tpu_torch.hparams as thparams
import infinitevl_tpu_torch.models.text as ttext
import infinitevl_tpu_torch.train.step as tstep
import infinitevl_tpu_torch.train.trainer as ttrainer
from infinitevl_tpu.config import LINEAR, SLIDING, tiny_config
from infinitevl_tpu.models.params import init_delta_layer, init_params, init_swa_layer
from infinitevl_tpu.ops.rope import mrope_cos_sin as jcos_sin
from infinitevl_tpu_torch.models.params import from_jax_numpy
from infinitevl_tpu_torch.train.step import tree_leaves_with_path

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_TOL, GRAD_TOL = 1e-5, 1e-4
W, CHUNK = 16, 16  # the SWA window and the DeltaNet sequence chunk
B = 2


def _cfg(on=True):
    """JAX's tiny text config with the chunk knobs; `on` False turns the
    chunked path off (delta_seq_chunk_t 0, mlp_chunk_t 0)."""
    return dataclasses.replace(
        tiny_config().text, sliding_window=W, delta_chunk_size=8,
        delta_seq_chunk_t=32 if on else 0, delta_seq_chunk_eval=CHUNK,
        mlp_chunk_t=16 if on else 0)


JCFG = _cfg()
TCFG = to_port_config(dataclasses.replace(tiny_config(), text=JCFG)).text


def _segments(kind: str, T: int) -> np.ndarray:
    """[B, T] int32 ids. one: a single id a row; tail: row 0 one sequence
    then id-0 pads (the collators' unpacked rows); packed: row 0 with a
    boundary on a chunk edge (16) and one inside a chunk (37), its segment 2
    spanning the edge at 32."""
    if kind == "one":
        return np.ones((B, T), np.int32)
    if kind == "tail":
        row = [1] * (T - 13) + [0] * 13
    else:
        row = [1] * 16 + [2] * 21 + [3] * (T - 37)
    return np.asarray([row, [5] * T], np.int32)


def _x(T, seed=1, D=None):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((B, T, D or JCFG.hidden_size)) * 0.3).astype(np.float32)


def _cos_sin(T):
    pos = jnp.broadcast_to(jnp.arange(T)[None, None], (3, B, T))
    inv = 1.0 / (JCFG.rope_theta ** (np.arange(0, JCFG.head_dim, 2) / JCFG.head_dim))
    c, s = jcos_sin(pos, jnp.asarray(inv, jnp.float32), JCFG.mrope_section, 1.0,
                    dtype=jnp.float32)
    return np.asarray(c), np.asarray(s)


_LAYERS = {}


def _layer(role):
    if role not in _LAYERS:
        init = init_swa_layer if role == SLIDING else init_delta_layer
        _LAYERS[role] = jax.tree.map(np.asarray, init(jax.random.PRNGKey(7), JCFG,
                                                      dtype=jnp.float32))
    return _LAYERS[role]


def _flat(tree):
    return dict(tree_leaves_with_path(tree))


def _jflat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_jflat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_jflat(v, f"{prefix}/{i}" if prefix else str(i)))
        return out
    return {prefix: np.asarray(tree)}


def _compare(jfn, tfn, p_np, args_np, mask=None):
    """jfn(p, *args) (JAX) and tfn(p, *args) (port) on the same numpy
    inputs; the loss sum(sin(y) * mask) differentiated with respect to p
    and every floating array of args. Returns (output err, largest gradient
    err over the input and every leaf)."""
    m = np.ones(1, np.float32) if mask is None else mask.astype(np.float32)[..., None]
    diff = [i for i, a in enumerate(args_np)
            if isinstance(a, np.ndarray) and a.dtype == np.float32]

    def jloss(p, *dargs):
        args = list(args_np)
        for i, a in zip(diff, dargs):
            args[i] = a
        y = jfn(p, *args)
        return jnp.sum(jnp.sin(y) * m), y

    (_, jy), jg = jax.value_and_grad(jloss, argnums=tuple(range(1 + len(diff))),
                                     has_aux=True)(p_np, *[args_np[i] for i in diff])
    tp = from_jax_numpy(p_np, "cpu", trainable=True)
    targs = [torch.from_numpy(a).requires_grad_(a.dtype == np.float32)
             if isinstance(a, np.ndarray) else a for a in args_np]
    ty = tfn(tp, *targs)
    loss = (torch.sin(ty) * torch.from_numpy(m)).sum()
    leaves = _flat(tp)
    grads = torch.autograd.grad(loss, list(leaves.values()) + [targs[i] for i in diff],
                                allow_unused=True)
    y_err = err_ratio(ty * torch.from_numpy(m), np.asarray(jy) * m)
    jleaves = _jflat(jg[0])
    g_err = 0.0
    for (path, _), g in zip(leaves.items(), grads[: len(leaves)]):
        want = jleaves[path]
        if np.abs(want).sum() == 0:
            assert g is None or float(g.abs().max()) == 0.0, path
            continue
        g_err = max(g_err, err_ratio(g, want))
    for g, want in zip(grads[len(leaves):], jg[1:]):
        g_err = max(g_err, err_ratio(g, np.asarray(want)))
    return y_err, g_err


CASES = [(T, kind) for T in (64, 53) for kind in ("one", "tail", "packed")]


@pytest.mark.parametrize("T,kind", CASES, ids=[f"T{T}-{k}" for T, k in CASES])
def test_swa_forward_seq_chunked_matches_jax(T, kind):
    seg = None if kind == "one" else _segments(kind, T)
    cos, sin = _cos_sin(T)
    y_err, g_err = _compare(
        lambda p, x, c, s, sg: jtext.swa_forward_seq_chunked(p, JCFG, x, c, s, sg, W),
        lambda p, x, c, s, sg: ttext.swa_forward_seq_chunked(p, TCFG, x, c, s, sg, W),
        _layer(SLIDING), [_x(T), cos, sin, seg])
    assert y_err <= OUT_TOL and g_err <= GRAD_TOL, (y_err, g_err)


@pytest.mark.parametrize("T,kind", CASES, ids=[f"T{T}-{k}" for T, k in CASES])
def test_delta_forward_seq_chunked_matches_jax(T, kind):
    """The port keeps tail pads' ids from the delta rule (tail_pads_only):
    the real positions, and every gradient of a loss over them, match JAX's
    rule with the ids."""
    seg = None if kind == "one" else _segments(kind, T)
    tail = kind == "tail"
    y_err, g_err = _compare(
        lambda p, x, sg: jtext.delta_forward_seq_chunked(p, JCFG, x, sg, CHUNK),
        lambda p, x, sg: ttext.delta_forward_seq_chunked(p, TCFG, x, sg, CHUNK,
                                                         tail_pads_only=tail),
        _layer(LINEAR), [_x(T), seg], mask=(seg != 0) if tail else None)
    assert y_err <= OUT_TOL and g_err <= GRAD_TOL, (y_err, g_err)


def _text_weights():
    jcfg = dataclasses.replace(tiny_config(), text=JCFG)
    jp = init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)["text"]
    return jax.tree.map(np.asarray, jp)


@pytest.mark.parametrize("remat", [True, False], ids=["layer-checkpoint", "chunks-only"])
def test_dispatch_on_off_and_jax(remat, monkeypatch):
    """text_forward with the chunked path on and off (delta_seq_chunk_t 0)
    on packed rows that cross chunk edges, with remat's per-layer checkpoint
    around the chunks' own or with the chunks' alone: hidden within 1e-5 and
    every gradient within 1e-4 of the full-T path's, and the chunked hidden
    state within 1e-5 of JAX's text_forward. The chunked layers ran."""
    T = 53
    pnp = _text_weights()
    x = _x(T, seed=4)
    pos = np.broadcast_to(np.arange(T)[None, None], (3, B, T)).astype(np.int32)
    seg = _segments("packed", T)
    calls = []
    real = ttext._delta_chunk
    monkeypatch.setattr(ttext, "_delta_chunk", lambda *a: calls.append(1) or real(*a))
    res = {}
    for on in (True, False):
        tcfg = to_port_config(dataclasses.replace(tiny_config(), text=_cfg(on))).text
        tp = from_jax_numpy(pnp, "cpu", trainable=True)
        tx = torch.from_numpy(x).requires_grad_(True)
        h, _ = ttext.text_forward(tp, tcfg, tx, torch.from_numpy(pos),
                                  segment_ids=torch.from_numpy(seg), remat=remat)
        leaves = _flat(tp)
        names = [k for k in leaves if k != "inv_freq" and "embed" not in k]
        gs = torch.autograd.grad(torch.sin(h).sum(), [tx] + [leaves[k] for k in names])
        res[on] = (h.detach(), dict(zip(["x"] + names, gs)))
    assert calls, "the chunked DeltaNet path did not run"
    (h1, g1), (h0, g0) = res[True], res[False]
    assert err_ratio(h1, h0) <= OUT_TOL
    assert max(err_ratio(g1[k], g0[k]) for k in g0) <= GRAD_TOL
    want, _, _ = jtext.text_forward(pnp, JCFG, x, pos, segment_ids=seg)
    assert err_ratio(h1, np.asarray(want)) <= OUT_TOL


def _args(tmp_path, **over):
    args = thparams.load_yaml_args(os.path.join(REPO, "examples", "sft_tiny.yaml"))
    args.data.dataset_dir = os.path.join(REPO, "data")
    args.train.output_dir = str(tmp_path)
    for key, val in over.items():
        group = next(g for g in (args.model, args.data, args.train, args.finetune)
                     if hasattr(g, key))
        setattr(group, key, val)
    return args


@pytest.fixture
def chunked_tiny(monkeypatch):
    """The tiny preset of both packages with the chunk knobs of this file,
    so that sft_tiny.yaml's cutoff of 64 runs the chunked layers."""
    jcfg = dataclasses.replace(tiny_config(), text=JCFG)
    monkeypatch.setattr(jtrainer, "tiny_config", lambda: jcfg)
    monkeypatch.setattr(ttrainer, "tiny_config", lambda: to_port_config(jcfg))
    calls = []
    real = ttext._swa_chunk
    monkeypatch.setattr(ttext, "_swa_chunk", lambda *a: calls.append(1) or real(*a))
    return calls


def test_sft_steps_at_a_cutoff_above_delta_seq_chunk_t_match_jax(tmp_path, chunked_tiny):
    """sft_tiny.yaml (packed rows) at cutoff 64 > delta_seq_chunk_t 32:
    three full-finetuning steps of the port's Trainer from JAX-initialised
    weights, each loss within 1e-4 of JAX's trainer step; then run_sft
    itself for three steps, finite. (Both sides train every leaf, as
    tests/test_torch_port_trainer.py's loss curves do.)"""
    import infinitevl_tpu.hparams as jhparams

    n = 3

    jargs = jhparams.load_yaml_args(os.path.join(REPO, "examples", "sft_tiny.yaml"))
    jargs.data.dataset_dir = os.path.join(REPO, "data")
    jargs.train.max_steps = n
    targs = _args(tmp_path, max_steps=n, logging_steps=1)
    jcfg, tcfg = jtrainer.build_config(jargs), ttrainer.build_config(targs)
    assert tcfg == to_port_config(jcfg) and tcfg.text.delta_seq_chunk_t == 32
    jdata = jtrainer.build_dataset(jargs, cfg=jcfg)
    tdata = ttrainer.build_dataset(targs, cfg=tcfg)
    jp = {"text": init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)["text"]}
    tx_j = jtrainer._make_tx(jargs, n)
    state = tx_j.init(jp)
    step_j = jax.jit(jstep.make_sft_train_step(jcfg.text, tx_j))
    want = []
    for batch in jtrainer._batches(jargs, jdata, jcfg, False):
        if len(want) == n:
            break
        batch.pop("_n_tokens")
        jp, state, loss = step_j(jp, state, batch)
        want.append(float(loss))
    tp, _ = carry_train_state({"text": init_params(jax.random.PRNGKey(0), jcfg,
                                                   jnp.float32)["text"]})
    tx_t = ttrainer._make_tx(targs, n)
    trainer = ttrainer.Trainer(tstep.make_sft_train_step(tcfg.text, tx_t), tp, tx_t.init(tp),
                               str(tmp_path / "trainer"), logging_steps=1, save_steps=1000)
    trainer.train(ttrainer._batches(targs, tdata, tcfg, False), max_steps=n)
    got = [r["loss"] for r in trainer.log.records if "loss" in r]
    assert chunked_tiny, "the chunked SWA path did not run"
    assert len(got) == n and max(abs(a - b) / b for a, b in zip(got, want)) < 1e-4, (got, want)
    ttrainer.run_sft(targs, device="cpu")
    recs = [json.loads(line) for line in open(tmp_path / "trainer_log.jsonl")]
    losses = [r["loss"] for r in recs if "loss" in r]
    assert len(losses) == n and all(np.isfinite(losses))
