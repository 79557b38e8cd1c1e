"""The Mamba2 conversion mixer in the port against the JAX package on the
CPU in fp32: the SSD scan (the decode step, the recurrence, the gradient
of every input against jax.grad; the chunk form on aligned, unaligned and
packed rows and from a nonzero state is in test_torch_port_mamba2_scan.py), `mamba2_forward` inside the
hybrid model of tests/test_mamba2.py (stateless with packed rows, cached
chunked prefill in two calls, decode, StreamingEngine), the decoder state's
mamba keys, the conversion's weight copy, the handoff filter and the HF
export's names, greedy `Generator` tokens on a converted tiny model (plain,
fused, int8), and `examples/dt_stage1_mamba2_tiny.yaml` through `run_exp` with
its step losses against JAX's (the clip idle).

Tolerances: ops <= 1e-5 (err_ratio), gradients and model outputs <= 1e-4,
tokens identical. Weights are JAX's, carried across with from_jax_numpy."""

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

import infinitevl_tpu.hparams as jhparams
import infinitevl_tpu.models.convert as jconvert
import infinitevl_tpu.train.trainer as jtrainer
import infinitevl_tpu.utils.checkpoint as jckpt
import infinitevl_tpu_torch.hparams as thparams
import infinitevl_tpu_torch.models.convert as tconvert
import infinitevl_tpu_torch.train.distill as tdistill
import infinitevl_tpu_torch.train.trainer as ttrainer
import infinitevl_tpu_torch.utils.checkpoint as tckpt
from infinitevl_tpu.config import FULL, MAMBA2, tiny_config
from infinitevl_tpu.generation import Generator as JGenerator
from infinitevl_tpu.models.params import init_mamba2_layer as jinit_mamba2
from infinitevl_tpu.models.params import init_text_params as jinit_text
from infinitevl_tpu.models.state import init_decoder_state as jinit_state
from infinitevl_tpu.models.text import embed_tokens as jembed
from infinitevl_tpu.models.text import text_forward as jtext_forward
from infinitevl_tpu.ops import mamba2 as jm2
from infinitevl_tpu_torch.generation import Generator
from infinitevl_tpu_torch.models.params import from_jax_numpy
from infinitevl_tpu_torch.models.state import (
    clone_state,
    init_decoder_state,
    state_bytes,
    state_row,
)
from infinitevl_tpu_torch.models.text import embed_tokens as tembed
from infinitevl_tpu_torch.models.text import text_forward as ttext_forward
from infinitevl_tpu_torch.ops import mamba2 as tm2
from infinitevl_tpu_torch.train.step import tree_leaves_with_path

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OP_TOL, MODEL_TOL = 1e-5, 1e-4
CFG0 = tiny_config(num_hidden_layers=4)
# the hybrid of tests/test_mamba2.py: every role the state holds
HYBRID = dataclasses.replace(CFG0, text=dataclasses.replace(
    CFG0.text, layer_types=("sliding_attention", "mamba2", "linear_attention", "mamba2")))
THYBRID = to_port_config(HYBRID)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def _scan_inputs(B=2, T=24, H=2, N=8, P=8, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, H, P).astype(np.float32) * 0.5
    dt = (np.abs(rng.randn(B, T, H)) * 0.3 + 0.05).astype(np.float32)
    A = (-np.abs(rng.randn(H)) - 0.1).astype(np.float32)
    b = rng.randn(B, T, H, N).astype(np.float32) * 0.5
    c = rng.randn(B, T, H, N).astype(np.float32) * 0.5
    h0 = rng.randn(B, H, N, P).astype(np.float32) * 0.5
    return x, dt, A, b, c, h0


def _packed(B, T):
    """Row 0: three segments, one boundary on a chunk edge (8) and one
    inside a chunk; row 1: two segments."""
    seg = np.ones((B, T), np.int32)
    seg[0, 8:13], seg[0, 13:] = 2, 3
    seg[1, 10:] = 2
    return seg


# ---------------------------------------------------------------- ops


def test_step_and_recurrent_match_jax():
    x, dt, A, b, c, h0 = _scan_inputs(T=6)
    want_y, want_h = jm2.mamba2_step(*map(jnp.asarray, (x[:, 0], dt[:, 0], A, b[:, 0], c[:, 0],
                                                       h0)))
    h0_t = torch.from_numpy(h0)
    y, h = tm2.mamba2_step(*map(torch.from_numpy, (x[:, 0], dt[:, 0], A, b[:, 0], c[:, 0])), h0_t)
    assert err_ratio(y, want_y) < OP_TOL and err_ratio(h, want_h) < OP_TOL
    assert torch.equal(h0_t, torch.from_numpy(h0))  # the state passed in is not modified
    want_y, want_h = jm2.mamba2_recurrent(*map(jnp.asarray, (x, dt, A, b, c)),
                                          initial_state=jnp.asarray(h0))
    y, h = tm2.mamba2_recurrent(*map(torch.from_numpy, (x, dt, A, b, c)), initial_state=h0_t)
    assert err_ratio(y, want_y) < OP_TOL and err_ratio(h, want_h) < OP_TOL


@pytest.mark.parametrize("packed", [False, True], ids=["single", "packed"])
def test_chunk_scan_gradients_match_jax(packed):
    """d/d(x, dt, A, B, C, h0) of sum(sin(y)) + sum(h * w) against jax.grad."""
    x, dt, A, b, c, h0 = _scan_inputs(T=21, seed=3)
    seg = _packed(2, 21) if packed else None
    wh = np.random.RandomState(4).randn(*h0.shape).astype(np.float32)

    def jloss(*args):
        y, h = jm2.mamba2_chunk_scan(*args[:5], initial_state=args[5], chunk_size=8,
                                     segment_ids=None if seg is None else jnp.asarray(seg))
        return jnp.sum(jnp.sin(y)) + jnp.sum(h * jnp.asarray(wh))

    want = jax.grad(jloss, argnums=tuple(range(6)))(*map(jnp.asarray, (x, dt, A, b, c, h0)))
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (x, dt, A, b, c, h0)]
    y, h = tm2.mamba2_chunk_scan(*leaves[:5], initial_state=leaves[5], chunk_size=8,
                                 segment_ids=None if seg is None else torch.from_numpy(seg))
    got = torch.autograd.grad(torch.sin(y).sum() + (h * torch.from_numpy(wh)).sum(), leaves)
    for name, g, w in zip(("x", "dt", "A", "B", "C", "h0"), got, want):
        assert err_ratio(g, w) < MODEL_TOL, name


# ---------------------------------------------------------------- the layer in a model


@pytest.fixture(scope="module")
def hybrid():
    jp = jinit_text(jax.random.PRNGKey(0), HYBRID.text, jnp.float32)
    return jp, from_jax_numpy(_np(jp), "cpu")


def _ids(seed, B, T, vocab=HYBRID.text.vocab_size):
    return np.random.RandomState(seed).randint(0, vocab, (B, T))


def _pos(B, T, start=0):
    return np.broadcast_to(np.arange(start, start + T)[None, None], (3, B, T)).copy()


def test_params_dispatch_and_fp32_leaves(hybrid):
    """init_text_params builds the mamba2 role with JAX's shapes and
    dtypes (dt_bias, A_log and D fp32 in a bf16 tree); from_jax_numpy keeps
    them fp32."""
    from infinitevl_tpu_torch.models.params import init_mamba2_layer, init_text_params

    jp, tp = hybrid
    jb = jinit_text(jax.random.PRNGKey(0), HYBRID.text, jnp.bfloat16)
    tb = init_text_params(THYBRID.text, torch.Generator().manual_seed(0), "cpu")
    for i in (1, 3):
        want = {k: (np.asarray(v).shape, str(np.asarray(v).dtype))
                for k, v in _paths(jb["layers"][i])}
        got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
               for k, v in tree_leaves_with_path(tb["layers"][i])}
        assert got == want
        for k in ("dt_bias", "A_log", "D"):
            assert tp["layers"][i][k].dtype == torch.float32, k
    m = init_mamba2_layer(THYBRID.text, torch.Generator().manual_seed(1), "cpu", torch.float32,
                          mimic_init=True)
    jm = jax.tree.map(np.asarray, jinit_mamba2(
        jax.random.PRNGKey(1), HYBRID.text, jnp.float32, mimic_init=True))
    for k in ("conv_w", "conv_b", "A_log", "D", "o_norm"):
        assert torch.equal(m[k], torch.from_numpy(np.array(jm[k]))), k
    assert not m["dt_proj"]["kernel"].any()
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert bool(((dt >= 1e-3 * 0.999) & (dt <= 0.1 * 1.001)).all())


def test_stateless_forward_with_packed_rows_matches_jax(hybrid):
    jp, tp = hybrid
    T = 24
    ids, seg = _ids(1, 2, T), _packed(2, T)
    pos = np.zeros((2, T), np.int64)
    for r in range(2):
        for t in range(1, T):
            pos[r, t] = pos[r, t - 1] + 1 if seg[r, t] == seg[r, t - 1] else 0
    pos = np.broadcast_to(pos[None], (3, 2, T)).copy()
    want, _, _ = jtext_forward(jp, HYBRID.text, jembed(jp, jnp.asarray(ids)), jnp.asarray(pos),
                               None, jnp.asarray(seg))
    with torch.no_grad():
        got, state = ttext_forward(tp, THYBRID.text, tembed(tp, torch.from_numpy(ids)),
                                   torch.from_numpy(pos), None, torch.from_numpy(seg))
    assert state is None and err_ratio(got, want) < MODEL_TOL


@pytest.mark.parametrize("conv_carry", [False, True])
def test_cached_prefill_in_two_calls_then_decode_matches_jax(hybrid, conv_carry):
    """Chunked prefill (12 + 8 tokens) then five decode steps, the state
    updated in place: every call's hidden states and the mamba / DeltaNet /
    ring state against JAX's cached path (<= 1e-4), and with conv_carry the
    cached path against the stateless one."""
    jp, tp = hybrid
    jcfg = dataclasses.replace(HYBRID.text, conv_carry=conv_carry)
    tcfg = dataclasses.replace(THYBRID.text, conv_carry=conv_carry)
    T, n = 20, 5
    ids, pos = _ids(2, 1, T + n), _pos(1, T + n)
    js = jinit_state(jcfg, 1, jnp.float32)
    ts = init_decoder_state(tcfg, 1, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in ts.items() if k != "cum_len"} == \
        {k: tuple(v.shape) for k, v in js.items() if k != "cum_len"}
    outs = []
    with torch.no_grad():
        for lo, hi in [(0, 12), (12, T)] + [(t, t + 1) for t in range(T, T + n)]:
            want, js, _ = jtext_forward(jp, jcfg, jembed(jp, jnp.asarray(ids[:, lo:hi])),
                                        jnp.asarray(pos[:, :, lo:hi]), js)
            got, ts = ttext_forward(tp, tcfg, tembed(tp, torch.from_numpy(ids[:, lo:hi])),
                                    torch.from_numpy(pos[:, :, lo:hi]), ts)
            assert err_ratio(got, want) < MODEL_TOL, (lo, hi)
            for k in ("mamba_conv", "mamba_h", "delta_h", "swa_k"):
                assert err_ratio(ts[k], js[k]) < MODEL_TOL, (lo, hi, k)
            outs.append(got)
        assert ts["cum_len"] == T + n
        ref, _ = ttext_forward(tp, tcfg, tembed(tp, torch.from_numpy(ids)),
                               torch.from_numpy(pos))
    if conv_carry:
        # the conv reads its history, so the cached path is the stateless
        # one (without it the second chunk's conv pads with zeros, as the
        # reference's multi-token conv does, and the states part from there)
        assert err_ratio(torch.cat(outs, dim=1), ref) < MODEL_TOL


def test_state_keys_bytes_clone_and_row():
    """The mamba keys exist only with mamba2 layers; state_bytes counts
    them; clone_state and state_row copy them (the stream stays untouched);
    a state without DeltaNet layers still reads its batch from delta_h."""
    ts = init_decoder_state(THYBRID.text, 2, torch.bfloat16, "cpu")
    js = jinit_state(HYBRID.text, 2, jnp.bfloat16)
    assert state_bytes(ts) == sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(js)) - 4
    tc = THYBRID.text
    assert ts["mamba_conv"].shape == (2, 2, tc.conv_size, 3 * tc.num_attention_heads * tc.head_dim)
    assert ts["mamba_h"].shape == (2, 2, tc.num_attention_heads, tc.head_dim, tc.head_dim)
    assert ts["mamba_h"].dtype == torch.float32 and ts["mamba_conv"].dtype == torch.bfloat16
    plain = init_decoder_state(to_port_config(CFG0).text, 1, torch.bfloat16, "cpu")
    assert "mamba_h" not in plain and "mamba_conv" not in plain
    ts["mamba_h"].normal_()
    ts["mamba_conv"].normal_()
    snap, row = clone_state(ts), state_row(ts, 1)
    for k in ("mamba_conv", "mamba_h"):
        assert torch.equal(snap[k], ts[k]) and snap[k].data_ptr() != ts[k].data_ptr()
        assert torch.equal(row[k], ts[k][:, 1:2])
    snap["mamba_h"].zero_()
    row["mamba_conv"].zero_()
    assert ts["mamba_h"].abs().sum() > 0 and ts["mamba_conv"][:, 1].abs().sum() > 0
    only_m2 = dataclasses.replace(tc, layer_types=("sliding_attention",) + ("mamba2",) * 3)
    s = init_decoder_state(only_m2, 3, torch.bfloat16, "cpu")
    assert s["delta_h"].shape[:2] == (0, 3) and s["mamba_h"].shape[:2] == (3, 3)


def test_streaming_engine_matches_jax_and_ask_leaves_the_stream():
    """StreamingEngine on the hybrid with a 2-block ViT (12x12 frames: 9
    tokens + <vision_start>, two SSD chunks): after prime and 3 frames every
    state key (mamba ones included) <= 1e-4 of JAX's engine, the size
    constant, the `ask` tokens identical, the stream bit-unchanged by the
    ask, and frames-ask-frames bit-equal to frames-frames."""
    from infinitevl_tpu.config import VisionConfig
    from infinitevl_tpu.models.params import init_params as jinit_params
    from infinitevl_tpu.streaming import StreamingEngine as JEngine
    from infinitevl_tpu_torch.streaming import StreamingEngine

    vision = VisionConfig(depth=2, hidden_size=32, intermediate_size=64, num_heads=4,
                          patch_size=2, spatial_merge_size=2, temporal_patch_size=1,
                          window_size=8, out_hidden_size=HYBRID.text.hidden_size,
                          fullatt_block_indexes=(1,), tokens_per_second=2)
    jcfg = dataclasses.replace(HYBRID, vision=vision)
    jp = jinit_params(jax.random.PRNGKey(3), jcfg, dtype=jnp.float32)
    tp, tcfg = from_jax_numpy(_np(jp), "cpu"), to_port_config(jcfg)
    rng = np.random.RandomState(3)
    prompt, question = rng.randint(0, 400, (1, 6)), rng.randint(0, 400, (1, 3))
    frames = rng.randint(0, 256, (5, 12, 12, 3)).astype(np.uint8)
    je = JEngine(jp, jcfg, frame_hw=(12, 12), dtype=jnp.float32)
    te, plain = (StreamingEngine(tp, tcfg, frame_hw=(12, 12), device="cpu") for _ in range(2))
    n0 = state_bytes(te.state)
    for eng in (je, te, plain):
        eng.prime(prompt)
        for f in frames[:3]:
            eng.push_frame_raw(f)
    assert te.state["cum_len"] == int(je.state["cum_len"]) == 6 + 3 * 10
    for k, v in te.state.items():
        if k != "cum_len":
            assert err_ratio(v, je.state[k]) < MODEL_TOL, k
    before = clone_state(te.state)
    want = je.ask(question, max_new_tokens=6, eos_token_id=-1)
    got = te.ask(question, max_new_tokens=6, eos_token_id=-1)
    assert got == want and len(got) == 6 and state_bytes(te.state) == n0
    assert all(torch.equal(v, before[k]) for k, v in te.state.items() if k != "cum_len")
    for eng in (te, plain):
        for f in frames[3:]:
            eng.push_frame_raw(f)
    assert te.state["cum_len"] == plain.state["cum_len"]
    assert all(torch.equal(v, plain.state[k]) for k, v in te.state.items() if k != "cum_len")


# ---------------------------------------------------------------- conversion and serving


@pytest.fixture(scope="module")
def converted():
    """A JAX full-attention teacher, its mamba2 student (JAX's conversion)
    and the port's twins of both."""
    tcfg = dataclasses.replace(CFG0.text, layer_types=(FULL,) * 4)
    jt = jinit_text(jax.random.PRNGKey(5), tcfg, jnp.float32)
    js, jscfg = jconvert.convert_attention(jt, tcfg, jax.random.PRNGKey(6),
                                           softmax_attention=(0,), mixer="mamba2")
    full = dataclasses.replace(CFG0, text=tcfg)
    return dict(jt=jt, jtcfg=tcfg, js=js, jscfg=jscfg,
                tt=from_jax_numpy(_np(jt), "cpu"), ttcfg=to_port_config(full).text,
                ts=from_jax_numpy(_np(js), "cpu"),
                tscfg=to_port_config(dataclasses.replace(CFG0, text=jscfg)))


def test_conversion_weight_copy_matches_jax(converted, tmp_path):
    """q / o copied and k / v GQA-expanded bit for bit as JAX does; the
    mimic-initialised SSD side equal where it is not drawn (conv identity,
    dt_proj zero, A_log 1, D 1, conv_b 0); the student's config equal."""
    student, scfg = tconvert.convert_attention(converted["tt"], converted["ttcfg"],
                                               torch.Generator().manual_seed(6),
                                               softmax_attention=(0,), mixer="mamba2")
    assert scfg == converted["tscfg"].text
    assert scfg.layer_types == ("sliding_attention",) + (MAMBA2,) * 3
    js = converted["js"]
    for i in range(1, 4):
        lp, jl = student["layers"][i], js["layers"][i]
        for k in ("q_proj", "k_proj", "v_proj", "o_proj"):
            for leaf in jl[k]:
                assert torch.equal(lp[k][leaf], torch.from_numpy(np.array(jl[k][leaf]))), (i, k)
        for k in ("conv_w", "conv_b", "A_log", "D"):
            assert torch.equal(lp[k], torch.from_numpy(np.array(jl[k]))), (i, k)
        assert not lp["dt_proj"]["kernel"].any()
        assert lp["mlp"]["up"]["kernel"] is converted["tt"]["layers"][i]["mlp"]["up"]["kernel"]
    # the stage handoff's filter and the HF export's names as JAX's: a
    # Mamba2 layer exports q / k / v / o / g_proj, A_log, dt_bias and
    # o_norm, and has no names for conv_w, conv_b, D or dt_proj
    jf = jckpt.filter_softmax_layers(js, (0,))
    assert [sorted(lp) for lp in tckpt.filter_softmax_layers(student, (0,))["layers"]] == \
        [sorted(lp) for lp in jf["layers"]]
    jckpt.export_hf_safetensors({"text": js}, dataclasses.replace(CFG0, text=converted["jscfg"]),
                                str(tmp_path))
    from safetensors.numpy import load_file

    names = set(load_file(str(tmp_path / "model.safetensors")))
    assert set(tckpt.hf_tensors({"text": student}, converted["tscfg"])) == names
    assert not any(k in n for n in names for k in ("conv_w", "dt_proj", ".D"))
    mask = dict(tdistill._mask_leaves(tconvert.trainable_mask(student, scfg,
                                                              softmax_attention=(0,))))
    jmask = jconvert.trainable_mask(js, converted["jscfg"], softmax_attention=(0,))
    assert mask == {p: bool(v) for p, v in _paths(jmask)}
    assert mask["layers/1/conv_w"] and mask["layers/1/q_proj/kernel"]
    assert not mask["layers/1/mlp/up/kernel"] and not mask["layers/0/q_proj/kernel"]


@pytest.mark.parametrize("T", [6, 40], ids=["short", "ring_wrapped"])
def test_generator_greedy_tokens_on_a_converted_model(converted, T):
    """The JAX student (1 SWA + 3 mamba2 layers, window 16) served by both
    Generators: greedy tokens identical; prompt 40 wraps the ring."""
    jp, tp = {"text": converted["js"]}, {"text": converted["ts"]}
    ids = _ids(7 + T, 2, T, vocab=CFG0.text.vocab_size - 8)
    want = JGenerator(jp, dataclasses.replace(CFG0, text=converted["jscfg"])).generate(
        ids, max_new_tokens=10)
    got = Generator(tp, converted["tscfg"], device="cpu").generate(ids, max_new_tokens=10)
    assert got.shape == want.shape == (2, 10)
    np.testing.assert_array_equal(got, want)


def test_fused_and_int8_serving_of_a_converted_model(converted):
    """fuse_projections keeps a mamba2 layer's projections as they are (JAX
    fuses only the SWA and DeltaNet flavors); int8 quantises them as JAX
    does (the same integers); both serve the tokens JAX's engines give."""
    from infinitevl_tpu.models.fuse import fuse_projections as jfuse
    from infinitevl_tpu_torch.models.fuse import fuse_projections

    jp, tp = {"text": converted["js"]}, {"text": converted["ts"]}
    jf, tf = jfuse(jp), fuse_projections(tp)
    for jl, tl in zip(jf["text"]["layers"], tf["text"]["layers"]):
        assert sorted(jl) == sorted(tl)
    assert "q_proj" in tf["text"]["layers"][1] and "qkv_proj" in tf["text"]["layers"][0]
    jcfg = dataclasses.replace(CFG0, text=converted["jscfg"])
    ids = _ids(11, 1, 30, vocab=CFG0.text.vocab_size - 8)
    for kw in (dict(fuse=True), dict(quant="int8")):
        want = JGenerator(jp, jcfg, **kw).generate(ids, max_new_tokens=8)
        got = Generator(tp, converted["tscfg"], device="cpu", **kw).generate(ids, max_new_tokens=8)
        np.testing.assert_array_equal(got, want, err_msg=str(kw))


# ---------------------------------------------------------------- run_exp


def _args(mod, tmp_path, **over):
    args = mod.load_yaml_args(os.path.join(REPO, "examples", "dt_stage1_mamba2_tiny.yaml"))
    args.data.dataset_dir = os.path.join(REPO, "data")
    args.train.output_dir = str(tmp_path)
    # the clip idle: JAX clips by every leaf's norm, the port by the
    # trainable leaves' (ROADMAP §3, item 6)
    args.train.max_grad_norm = 1e9
    args.train.max_steps = 4
    for key, val in over.items():
        setattr(args.finetune if hasattr(args.finetune, key) else args.train, key, val)
    return args


def _losses(out_dir):
    return [r["loss"] for r in map(json.loads, open(os.path.join(out_dir, "trainer_log.jsonl")))
            if "loss" in r]


@pytest.mark.parametrize("stage", [1, 2])
def test_run_exp_dt_stage1_mamba2_losses_match_jax(tmp_path, monkeypatch, stage):
    """examples/dt_stage1_mamba2_tiny.yaml through both run_exp, stage 1 as
    written and stage 2 (`distill_stage: 2`): the port takes JAX's teacher
    (init_text_params) and the fresh parts of JAX's student
    (convert_attention's draws: g_proj, dt_bias) carried across, so both
    start from the same numbers; four step losses <= 1e-4 of JAX's,
    falling; the teacher bit-unchanged. Stage 2 leaves rope's inv_freq
    frozen, where JAX trains it (ROADMAP §3, item 6): JAX's optimizer
    masks it out here. (The port's run_dt used to encode text rows with
    the config's tokenizer, where JAX's uses the plain one: the first
    batch's ids differed and so did every loss.)"""
    import optax

    made = {}
    real_j = jtrainer.convert_attention

    def spy(t_text, *a, **kw):
        made["teacher"], (made["student"], cfg) = t_text, real_j(t_text, *a, **kw)
        return made["student"], cfg

    monkeypatch.setattr(jtrainer, "convert_attention", spy)
    if stage == 2:
        real_tx = jtrainer._make_tx

        def masked_tx(args, steps):
            labels = lambda tree: jax.tree_util.tree_map_with_path(
                lambda path, _: "frozen" if jax.tree_util.keystr(path).endswith("['inv_freq']")
                else "train", tree)
            return optax.multi_transform({"train": real_tx(args, steps),
                                          "frozen": optax.set_to_zero()}, labels)

        monkeypatch.setattr(jtrainer, "_make_tx", masked_tx)
    ja = _args(jhparams, tmp_path / "jax", distill_stage=stage)
    jtrainer.run_exp(ja)
    want = _losses(ja.train.output_dir)

    teacher = from_jax_numpy(_np(made["teacher"]), "cpu")
    before = {p: t.clone() for p, t in tree_leaves_with_path(teacher)}
    carried = from_jax_numpy(_np(made["student"]), "cpu")
    real_t = ttrainer.convert_attention

    def convert(t_text, *a, **kw):
        student, cfg = real_t(t_text, *a, **kw)
        for i, role in enumerate(cfg.layer_types):
            if role == MAMBA2:
                for k in ("g_proj", "dt_bias"):
                    student["layers"][i][k] = carried["layers"][i][k]
        return student, cfg

    monkeypatch.setattr(ttrainer, "init_text_params", lambda *a, **kw: teacher)
    monkeypatch.setattr(ttrainer, "convert_attention", convert)
    ta = _args(thparams, tmp_path / "port", distill_stage=stage)
    student = ttrainer.run_exp(ta, device="cpu")
    got = _losses(ta.train.output_dir)
    assert len(got) == len(want) == 4 and got[-1] < got[0]
    assert max(abs(g - w) / w for g, w in zip(got, want)) < MODEL_TOL, (got, want)
    assert all(torch.equal(t, before[p]) for p, t in tree_leaves_with_path(teacher))
    assert all(torch.isfinite(t).all() for _, t in tree_leaves_with_path(student))
