"""The port's StreamingEngine against the JAX engine, on the CPU in fp32:
the same prompt, frames and question (numpy, from a seed) through both,
weights carried by from_jax_numpy, the JAX config converted field by field.

Tolerances: the state after prime + frames err_ratio <= 1e-4 (fp32 through
the ViT and 8 decoder layers, summation order only); greedy `ask` tokens
identical; clip = sequential frames and batched = independent engines
max|diff| <= 1e-4 (other summation orders inside one forward); everything
the in-place hazard could break is held bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import to_port_config

from infinitevl_tpu.config import VisionConfig, tiny_config
from infinitevl_tpu.models.params import init_params
from infinitevl_tpu.streaming import StreamingEngine as JEngine
from infinitevl_tpu_torch.device import default_device
from infinitevl_tpu_torch.models.params import from_jax_numpy
from infinitevl_tpu_torch.models.state import clone_state, state_bytes
from infinitevl_tpu_torch.streaming import StreamingEngine

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = 1e-4
STATE_KEYS = ("swa_k", "swa_v", "delta_h", "conv_q", "conv_k", "conv_v")
HW = (12, 12)  # 6x6 patches -> 9 tokens: T = 10 > recurrent_threshold 8 (chunk path)


def make_cfg(conv_carry=False, temporal_patch_size=1):
    base = tiny_config()
    vision = VisionConfig(depth=2, hidden_size=32, intermediate_size=64, num_heads=4,
                          patch_size=2, spatial_merge_size=2,
                          temporal_patch_size=temporal_patch_size, window_size=8,
                          out_hidden_size=base.text.hidden_size,
                          fullatt_block_indexes=(1,), tokens_per_second=2)
    text = dataclasses.replace(base.text, conv_carry=conv_carry)
    return dataclasses.replace(base, vision=vision, text=text)


def err_ratio(x, ref):
    x = np.asarray(x, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.abs(x - ref).mean() / (np.abs(ref).mean() + 1e-12)


@pytest.fixture(scope="module", params=[False, True], ids=["reference_conv", "conv_carry"])
def setup(request):
    jcfg = make_cfg(conv_carry=request.param)
    jp = init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tp = from_jax_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, to_port_config(jcfg), jp, tp


def engine(tp, tcfg, **kw):
    return StreamingEngine(tp, tcfg, frame_hw=HW, device="cpu", **kw)


def pixels(rng, cfg, n_frames=1):
    v = cfg.vision
    n = (HW[0] // v.patch_size) * (HW[1] // v.patch_size)
    feat = v.in_channels * v.temporal_patch_size * v.patch_size**2
    return rng.standard_normal((n_frames * n, feat)).astype(np.float32)


def raw_frames(rng, n):
    return rng.randint(0, 256, (n, *HW, 3)).astype(np.uint8)


def assert_states_equal(a, b):
    assert a["cum_len"] == b["cum_len"]
    for key in STATE_KEYS:
        assert torch.equal(a[key], b[key]), key


def assert_states_close(a, b, tol=1e-4):
    assert a["cum_len"] == b["cum_len"]
    for key in STATE_KEYS:
        assert float((a[key].double() - b[key].double()).abs().max()) < tol, key


def test_engine_matches_jax_prime_frames_ask(setup):
    jcfg, tcfg, jp, tp = setup
    rng = np.random.RandomState(0)
    je = JEngine(jp, jcfg, frame_hw=HW, dtype=jnp.float32)
    te = engine(tp, tcfg)
    bytes0 = state_bytes(te.state)
    prompt = rng.randint(0, 400, (1, 6))
    je.prime(prompt)
    te.prime(prompt)
    for _ in range(3):
        px = pixels(rng, jcfg)
        je.push_frame(jnp.asarray(px))
        te.push_frame(px)
    assert te.state["cum_len"] == int(je.state["cum_len"]) == 6 + 3 * 10
    assert (te.frames, te.pos_base, te.pos_max) == (je.frames, je.pos_base, je.pos_max)
    for key in STATE_KEYS:
        assert err_ratio(te.state[key], je.state[key]) < TOL, key
    assert state_bytes(te.state) == bytes0
    question = rng.randint(0, 400, (1, 3))
    want = je.ask(question, max_new_tokens=6, eos_token_id=-1)
    before = clone_state(te.state)
    got = te.ask(question, max_new_tokens=6, eos_token_id=-1)
    assert got == want and len(got) == 6
    assert_states_equal(te.state, before)  # ask decodes on a clone
    stats = te.stats()
    assert stats["frames"] == 3 and stats["tokens"] == 36 and stats["fps"] > 0


def test_raw_and_paired_frames_match_jax():
    jcfg = make_cfg(temporal_patch_size=2)
    tcfg = to_port_config(jcfg)
    jp = init_params(jax.random.PRNGKey(1), jcfg, dtype=jnp.float32)
    tp = from_jax_numpy(jax.tree.map(np.asarray, jp), "cpu")
    f = raw_frames(np.random.RandomState(1), 3)
    je, te = JEngine(jp, jcfg, frame_hw=HW, dtype=jnp.float32), engine(tp, tcfg)
    je.push_frame_raw(f[0])
    te.push_frame_raw(f[0])
    for frame in f[1:]:
        assert te.push_frame_raw_paired(frame) == je.push_frame_raw_paired(frame)
    assert te.frames == je.frames == 3 and te.pos_max == je.pos_max
    assert te.state["cum_len"] == int(je.state["cum_len"]) == 20
    for key in STATE_KEYS:
        assert err_ratio(te.state[key], je.state[key]) < TOL, key
    # push_frame_pair takes the pair already patchified
    from infinitevl_tpu_torch.data.processing import normalize, patchify

    pair, _ = patchify(normalize(f[1:]), 2, 2, 2)
    te2 = engine(tp, tcfg)
    te2.push_frame_raw(f[0])
    te2.push_frame_pair(pair)
    assert_states_close(te2.state, te.state, 1e-5)


def test_ask_leaves_the_stream_untouched(setup):
    """The in-place hazard: frames -> ask -> frames gives, bit for bit, the
    state of the same frames with no ask."""
    _, tcfg, _, tp = setup
    f = raw_frames(np.random.RandomState(2), 4)
    with_ask, without = engine(tp, tcfg), engine(tp, tcfg)
    for e in (with_ask, without):
        e.prime(np.arange(5)[None])
        e.push_frame_raw(f[0])
        e.push_frame_raw(f[1])
    answer = with_ask.ask(np.array([[7, 8, 9]]), max_new_tokens=5, eos_token_id=-1)
    assert len(answer) == 5
    assert with_ask.ask(np.array([[7, 8, 9]]), max_new_tokens=5, eos_token_id=-1) == answer
    for e in (with_ask, without):
        e.push_frame_raw(f[2])
        e.push_frame_raw(f[3])
    assert_states_equal(with_ask.state, without.state)
    assert (with_ask.frames, with_ask.pos_max) == (without.frames, without.pos_max)


@pytest.mark.parametrize("tps", [1, 2])
def test_push_clip_raw_equals_sequential_frames(tps):
    jcfg = make_cfg(conv_carry=True, temporal_patch_size=tps)
    tcfg = to_port_config(jcfg)
    jp = init_params(jax.random.PRNGKey(3), jcfg, dtype=jnp.float32)
    tp = from_jax_numpy(jax.tree.map(np.asarray, jp), "cpu")
    f = raw_frames(np.random.RandomState(3), 3)
    seq, clip = engine(tp, tcfg), engine(tp, tcfg)
    for frame in f:
        seq.push_frame_raw(frame)
    clip.push_clip_raw(f)
    assert (clip.frames, clip.pos_max) == (seq.frames, seq.pos_max)
    assert_states_close(clip.state, seq.state)
    if tps == 1:  # and the JAX engine's clip step
        je = JEngine(jp, jcfg, frame_hw=HW, dtype=jnp.float32)
        je.push_clip_raw(f)
        for key in STATE_KEYS:
            assert err_ratio(clip.state[key], je.state[key]) < TOL, key
    else:  # paired: two real frames per unit
        paired = engine(tp, tcfg)
        paired.push_clip_raw(raw_frames(np.random.RandomState(4), 4), paired=True)
        assert paired.frames == 4 and paired.state["cum_len"] == 20


def test_batched_streams_equal_independent_engines_and_extract():
    jcfg = make_cfg(conv_carry=True)
    tcfg = to_port_config(jcfg)
    jp = init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tp = from_jax_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.RandomState(5)
    steps = [pixels(rng, jcfg, 2) for _ in range(2)]  # two lockstep frames, 2 streams
    n = steps[0].shape[0] // 2
    multi = engine(tp, tcfg, batch_size=2)
    jmulti = JEngine(jp, jcfg, frame_hw=HW, dtype=jnp.float32, batch_size=2)
    singles = [engine(tp, tcfg), engine(tp, tcfg)]
    for px in steps:
        multi.push_frames_batched(px)
        jmulti.push_frames_batched(jnp.asarray(px))
        for row, e in enumerate(singles):
            e.push_frame(px[row * n:(row + 1) * n])
    for key in STATE_KEYS:
        assert err_ratio(multi.state[key], jmulti.state[key]) < TOL, key
    with pytest.raises(ValueError, match="extract_stream"):
        multi.ask(np.array([[7, 8, 9]]))
    snapshot = clone_state(multi.state)
    question = np.array([[7, 8, 9]])
    for row, e in enumerate(singles):
        sub = multi.extract_stream(row)
        assert_states_close(sub.state, e.state)
        want = jmulti.extract_stream(row).ask(question, max_new_tokens=5, eos_token_id=-1)
        assert sub.ask(question, max_new_tokens=5, eos_token_id=-1) == want
        # the snapshot is a copy: pushing to it leaves the parent as it was
        sub.push_frame(steps[0][:n])
    assert_states_equal(multi.state, snapshot)


def test_engine_device_default_and_argument_checks(setup):
    _, tcfg, _, tp = setup
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            default_device()
        with pytest.raises(RuntimeError, match="CUDA"):
            StreamingEngine(tp, tcfg, frame_hw=HW)  # device=None means the card
    with pytest.raises(ValueError, match="params are on"):
        StreamingEngine(tp, tcfg, frame_hw=HW, device="meta")
    with pytest.raises(ValueError, match="multiple of patch"):
        engine_bad = StreamingEngine(tp, tcfg, frame_hw=(10, 12), device="cpu")
        del engine_bad
    e = engine(tp, tcfg)
    assert e.t_offset_for_frame(0, 30.0) == 0 and e.stats() == {}
    assert [e.t_offset_for_frame(i, 1.0) for i in range(3)] == [0, 2, 4]
