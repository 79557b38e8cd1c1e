"""The port's text-serving slice end to end against the JAX package at
tiny_config(), on the CPU in fp32, with the same weights on both sides
(JAX init_params -> numpy -> from_jax_numpy) and the JAX config converted
field by field into the port's own.

Tolerances: logits and post-prefill state err_ratio <= 1e-4 (fp32 through
8 layers, summation order only); greedy tokens identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import to_port_config
from torch_port_helpers import jax_compile_cache  # noqa: F401 (autouse)

import infinitevl_tpu.models.state as jstate
from infinitevl_tpu.config import tiny_config
from infinitevl_tpu.generation import Generator as JGenerator
from infinitevl_tpu.models.infinitevl import forward as _jforward
from infinitevl_tpu.models.infinitevl import get_rope_index as jrope_index
from infinitevl_tpu.models.params import init_params
from infinitevl_tpu.models.text import text_forward as _jtext_forward
from infinitevl_tpu_torch.generation import Generator
from infinitevl_tpu_torch.models.infinitevl import forward, get_rope_index
from infinitevl_tpu_torch.models.params import from_jax_numpy, init_text_params
from infinitevl_tpu_torch.models.state import clone_state, init_decoder_state, state_bytes
from infinitevl_tpu_torch.models.text import _dense, text_forward
from infinitevl_tpu_torch.streaming import StreamingEngine

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = 1e-4
CFG = tiny_config()


TCFG = to_port_config(CFG)

# jitted JAX references (op-by-op eager JAX is several times slower here)
jforward = jax.jit(_jforward, static_argnames=("cfg", "grid_thw"))
jtext_forward = jax.jit(_jtext_forward, static_argnames=("cfg",))


def err_ratio(x, ref):
    x = np.asarray(x, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.abs(x - ref).mean() / (np.abs(ref).mean() + 1e-12)


@pytest.fixture(scope="module")
def weights():
    jp = init_params(jax.random.PRNGKey(0), CFG, jnp.float32)
    tp = from_jax_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jp, tp


def _ids(seed, B, T):
    return np.random.RandomState(seed).randint(0, CFG.text.vocab_size - 8, (B, T))


def test_get_rope_index_integer_exact():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 400, (2, 30))
    mask = np.ones_like(ids)
    mask[1, :4] = 0
    for kw in ({}, {"attention_mask": mask}):
        for a, b in zip(get_rope_index(TCFG, ids, **kw), jrope_index(CFG, ids, **kw)):
            np.testing.assert_array_equal(a, b)
    # image (1x4x4 patches -> 4 tokens) then video (2x4x4 -> 8 tokens)
    mm = np.concatenate([
        rng.randint(0, 400, 3), [CFG.vision_start_token_id], [CFG.image_token_id] * 4,
        rng.randint(0, 400, 5), [CFG.video_token_id] * 8, rng.randint(0, 400, 2),
    ])[None]
    kw = dict(image_grid_thw=np.array([[1, 4, 4]]), video_grid_thw=np.array([[2, 4, 4]]),
              second_per_grid_ts=[2.0])
    for a, b in zip(get_rope_index(TCFG, mm, **kw), jrope_index(CFG, mm, **kw)):
        np.testing.assert_array_equal(a, b)


def _compare_state(ts, js):
    assert ts["cum_len"] == int(js["cum_len"])
    for key in ("swa_k", "swa_v", "delta_h", "conv_q", "conv_k", "conv_v"):
        assert tuple(ts[key].shape) == js[key].shape, key
        assert err_ratio(ts[key], js[key]) < TOL, key


@pytest.mark.parametrize("T", [5, 40])  # recurrent path; chunk path + ring wrap
def test_prefill_and_decode_match_jax(weights, T):
    jp, tp = weights
    ids = _ids(T, 2, T + 1)
    pos, _ = jrope_index(CFG, ids)
    js = jstate.init_decoder_state(CFG.text, 2, jnp.float32)
    ts = init_decoder_state(TCFG.text, 2, torch.float32, "cpu")
    for sl in (slice(0, T), slice(T, T + 1)):  # prefill, then one decode step
        jl, js = jforward(jp, CFG, jnp.asarray(ids[:, sl]), jnp.asarray(pos[:, :, sl]), js)
        tl, ts = forward(tp, TCFG, torch.as_tensor(ids[:, sl]),
                         torch.as_tensor(pos[:, :, sl]), ts)
        assert err_ratio(tl, jl) < TOL, sl
        _compare_state(ts, js)


def test_stateless_forward_matches_jax(weights):
    jp, tp = weights
    ids = _ids(1, 2, 24)
    pos, _ = jrope_index(CFG, ids)
    jh, _, _ = jtext_forward(jp["text"], CFG.text,
                             jp["text"]["embed"][jnp.asarray(ids)], jnp.asarray(pos))
    th, state = text_forward(tp["text"], TCFG.text, tp["text"]["embed"][torch.as_tensor(ids)],
                             torch.as_tensor(pos))
    assert state is None
    assert err_ratio(th, jh) < TOL


@pytest.mark.parametrize("T, chunk", [(5, None), (40, None), (50, 16)])
def test_generate_greedy_tokens_identical(weights, T, chunk):
    """Prompt 5: recurrent delta path; 40: chunk path with the window-16
    ring wrapped; 50 with prefill_chunk_size 16: chunked prefill."""
    jp, tp = weights
    ids = _ids(100 + T, 2, T)
    jg, tg = JGenerator(jp, CFG), Generator(tp, TCFG, device="cpu")
    if chunk:
        jg.prefill_chunk_size = tg.prefill_chunk_size = chunk
    want = jg.generate(ids, max_new_tokens=12)
    got = tg.generate(ids, max_new_tokens=12)
    assert got.shape == want.shape == (2, 12)
    np.testing.assert_array_equal(got, want)


def test_state_size_clone_and_init(weights):
    _, tp = weights
    ts = init_decoder_state(TCFG.text, 2, torch.bfloat16, "cpu")
    js = jstate.init_decoder_state(CFG.text, 2, jnp.bfloat16)
    assert state_bytes(ts) == jstate.state_bytes(js) - 4  # JAX cum_len is an int32 array
    snap = clone_state(ts)
    ids = torch.as_tensor(_ids(3, 2, 6))
    pos = torch.arange(6).expand(3, 2, 6)
    forward(tp, TCFG, ids, pos, ts)
    assert snap["cum_len"] == 0 and not snap["delta_h"].any()
    assert ts["cum_len"] == 6 and ts["delta_h"].any()
    # random init at the tiny width: the JAX shapes and dtypes
    gp = init_text_params(TCFG.text, torch.Generator().manual_seed(0), "cpu", torch.float32)
    flat_t = jax.tree_util.tree_leaves(gp)
    flat_j = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, tp["text"]))
    assert [tuple(x.shape) for x in flat_t] == [x.shape for x in flat_j]


def test_paths_of_later_slices_raise(weights):
    """What is still to be ported raises (DoRA scales, biased int4 storage,
    the stacked layer layout); what the serving slice (fuse, quant,
    speculative, beam) and the training slice (segment_ids, LoRA side
    paths) ported no longer does."""
    jp, tp = weights
    assert Generator(tp, TCFG, fuse=True, device="cpu").params is not tp
    assert Generator(tp, TCFG, quant="int8", device="cpu").cfg is TCFG
    g = Generator(tp, TCFG, device="cpu")
    assert g.generate_beam(_ids(0, 1, 4), num_beams=2, max_new_tokens=2).shape == (1, 2)
    assert g.generate_speculative(_ids(0, 1, 4), max_new_tokens=2).shape == (1, 2)
    assert StreamingEngine(tp, TCFG, frame_hw=(28, 28), fuse=True, device="cpu").frames == 0
    ids = torch.as_tensor(_ids(0, 1, 4))
    pos = torch.arange(4).expand(3, 1, 4)
    # packed segment ids: the stateless forward takes them (logits <= 1e-4
    # of JAX's); a cached forward refuses them
    ids12, pos12 = _ids(3, 1, 12), np.broadcast_to(np.arange(12), (3, 1, 12)).copy()
    seg = np.array([[1] * 5 + [2] * 7], np.int32)
    want, _ = jforward(jp, CFG, jnp.asarray(ids12), jnp.asarray(pos12),
                       segment_ids=jnp.asarray(seg))
    got, _ = forward(tp, TCFG, torch.as_tensor(ids12), torch.as_tensor(pos12),
                     segment_ids=torch.from_numpy(seg))
    assert err_ratio(got, want) < TOL
    with pytest.raises(ValueError, match="stateless"):
        forward(tp, TCFG, ids, pos, init_decoder_state(TCFG.text, 1, device="cpu"),
                segment_ids=torch.ones((1, 4), dtype=torch.int32))
    # the LoRA side path: y = x W + (x a) b
    x, w, a, b = (torch.randn(*s) for s in ((3, 4), (4, 5), (4, 2), (2, 5)))
    assert torch.allclose(_dense(x, {"kernel": w, "lora_a": a, "lora_b": b}),
                          x @ w + (x @ a) @ b, atol=1e-6)
    # DoRA's column scale is ported (train/lora.attach_lora attaches m): m
    # over the columns' norms of W + a b multiplies the output before the
    # bias; the biased int4 layout still raises
    m, bias = torch.randn(5), torch.randn(5)
    s = m / (w + a @ b).norm(dim=0)
    assert torch.allclose(_dense(x, {"kernel": w, "lora_a": a, "lora_b": b, "dora_m": m,
                                     "bias": bias}), (x @ w + (x @ a) @ b) * s + bias,
                          atol=1e-5)
    with pytest.raises(NotImplementedError, match="kernel_q4b"):
        _dense(torch.zeros(1, 4), {"kernel_q4b": torch.zeros(4, 4), "kernel": torch.zeros(4, 4)})
    with pytest.raises(NotImplementedError, match="layer_stacks"):
        text_forward({**tp["text"], "layer_stacks": {}}, TCFG.text,
                     torch.zeros(1, 4, TCFG.text.hidden_size), pos)
    # vision inputs are ported now: the case that used to raise is a parity
    # case (one 1x4x4-patch image -> 4 tokens; logits err_ratio <= 1e-4)
    rng = np.random.RandomState(5)
    mm = np.concatenate([_ids(1, 1, 3)[0], [CFG.vision_start_token_id],
                         [CFG.image_token_id] * 4, _ids(2, 1, 2)[0]])[None]
    grid = np.array([[1, 4, 4]])
    px = rng.standard_normal((16, 3 * 2 * 14 * 14)).astype(np.float32)
    # a grid without pixel values only moves the positions
    g.prefill_prompt(mm, image_grid_thw=grid)
    mpos, _ = jrope_index(CFG, mm, grid)
    want, _ = jforward(jp, CFG, jnp.asarray(mm), jnp.asarray(mpos),
                       pixel_values=jnp.asarray(px), grid_thw=((1, 4, 4),))
    got, _ = forward(tp, TCFG, torch.as_tensor(mm), torch.as_tensor(mpos),
                     pixel_values=torch.from_numpy(px), grid_thw=((1, 4, 4),))
    assert err_ratio(got, want) < TOL
    with pytest.raises(ValueError, match="do not match"):  # 3 pads, 4 features
        g.prefill_prompt(np.delete(mm, 4, axis=1), pixel_values=px, image_grid_thw=grid)
