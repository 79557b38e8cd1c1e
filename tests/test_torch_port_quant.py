"""Weight-only quantization and projection fusion of the port against the
JAX package, on the CPU (the quantizers' stored integers and scales, held
IDENTICAL, are in test_torch_port_quant_codes.py): a tree quantized
or fused by the JAX package feeds the port through from_jax_numpy, and the
quantized / fused forward and Generator agree (logits err_ratio <= 1e-4 in
fp32: summation order only; greedy tokens identical). On CPU tensors every
int4 matmul takes kernel G's plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import to_port_config
from torch_port_helpers import jax_compile_cache  # noqa: F401 (autouse)

import infinitevl_tpu.models.quant as jq
import infinitevl_tpu_torch.models.quant as tq
from infinitevl_tpu.config import tiny_config
from infinitevl_tpu.generation import Generator as JGenerator
from infinitevl_tpu.models.fuse import fuse_projections as j_fuse
from infinitevl_tpu.models.infinitevl import forward as _jforward
from infinitevl_tpu.models.infinitevl import get_rope_index as jrope_index
from infinitevl_tpu.models.params import init_params
from infinitevl_tpu.models.vision import get_vision_plan as j_plan
from infinitevl_tpu.models.vision import vision_forward as j_vision_forward
from infinitevl_tpu_torch.generation import Generator
from infinitevl_tpu_torch.models.fuse import ALL_GROUPS, fuse_projections, is_fused
from infinitevl_tpu_torch.models.infinitevl import forward
from infinitevl_tpu_torch.models.params import from_jax_numpy
from infinitevl_tpu_torch.models.text import embed_tokens
from infinitevl_tpu_torch.models.vision import get_vision_plan, vision_forward
from infinitevl_tpu_torch.streaming import StreamingEngine

torch.set_num_threads(2)

TOL = 1e-4
CFG = tiny_config()
TCFG = to_port_config(CFG)
# wide enough that the default min_size (65536 elements) quantizes the MLP,
# o_proj and the embedding, as Generator(quant=...) does at real widths
WIDE = tiny_config(num_hidden_layers=4, hidden_size=256)
TWIDE = to_port_config(WIDE)

jforward = jax.jit(_jforward, static_argnames=("cfg", "grid_thw"))


def err_ratio(x, ref):
    x = np.asarray(x, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.abs(x - ref).mean() / (np.abs(ref).mean() + 1e-12)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def leaves(tree, prefix=""):
    """{path: leaf} of a nested dict / list tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(leaves(v, f"{prefix}/{k}"))
    return out


def assert_trees_identical(ttree, jtree):
    """Same paths; integer leaves bit-equal, float leaves bit-equal too (both
    packages do the same IEEE operations on the same inputs)."""
    tl, jl = leaves(ttree), leaves(to_np(jtree))
    assert sorted(tl) == sorted(jl)
    for path, j in jl.items():
        t = tl[path]
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype).replace("torch.", "") == j.dtype.name, path
        np.testing.assert_array_equal(t.float().numpy(), j.astype(np.float32), err_msg=path)


@pytest.fixture(scope="module")
def weights():
    jp = init_params(jax.random.PRNGKey(0), CFG, jnp.float32)
    return jp, from_jax_numpy(to_np(jp), "cpu")


@pytest.fixture(scope="module")
def wide_weights():
    jp = init_params(jax.random.PRNGKey(1), WIDE, jnp.float32)
    return jp, from_jax_numpy(to_np(jp), "cpu")


def _prefill_logits(jp, tp, jcfg, tcfg, ids):
    pos, _ = jrope_index(jcfg, ids)
    from infinitevl_tpu.models.state import init_decoder_state as j_init
    from infinitevl_tpu_torch.models.state import init_decoder_state

    js = j_init(jcfg.text, ids.shape[0], jnp.float32)
    ts = init_decoder_state(tcfg.text, ids.shape[0], torch.float32, "cpu")
    jl, js = jforward(jp, jcfg, jnp.asarray(ids), jnp.asarray(pos), js)
    tl, ts = forward(tp, tcfg, torch.as_tensor(ids), torch.as_tensor(pos), ts)
    return tl, jl, ts, js


@pytest.mark.parametrize("mode", ["int8", "int4", "fuse", "fuse+int4", "int4f"])
def test_quantized_and_fused_forward_match_jax(weights, mode):
    """The very same quantized / fused weights (made by the JAX package,
    carried across) through both forwards: prefill logits and state."""
    jp, _ = weights
    if "fuse" in mode:
        jp = j_fuse(jp)
    if "int" in mode:
        jp = jq.quantize_params(jp, min_size=1024, bits=8 if mode == "int8" else 4,
                                group_size=32, quantize_embed=True)
    tp = from_jax_numpy(to_np(jp), "cpu")
    if mode == "int4f":
        tp = tq.prefer_fused_int4(tp)  # the port's kernel_q4f route; JAX keeps its XLA route
    ids = np.random.RandomState(2).randint(0, CFG.text.vocab_size - 8, (2, 20))
    tl, jl, ts, js = _prefill_logits(jp, tp, CFG, TCFG, ids)
    assert err_ratio(tl, jl) < TOL
    for key in ("swa_k", "delta_h", "conv_q", "conv_v"):
        assert err_ratio(ts[key], js[key]) < TOL, key
    if "int" in mode:  # the quantized embedding gathers and dequantizes alike
        from infinitevl_tpu.models.text import embed_tokens as j_embed

        np.testing.assert_array_equal(
            embed_tokens(tp["text"], torch.as_tensor(ids)).numpy(),
            np.asarray(j_embed(jp["text"], jnp.asarray(ids))))


def test_fused_forward_equals_unfused(weights):
    """Column slices of the fused matmul are the unfused outputs: the port's
    fused forward against its own unfused one, each fusion group alone."""
    _, tp = weights
    ids = np.random.RandomState(4).randint(0, CFG.text.vocab_size - 8, (1, 12))
    pos = torch.arange(12).expand(3, 1, 12)
    base, _ = forward(tp, TCFG, torch.as_tensor(ids), pos)
    for groups in (ALL_GROUPS, {"qkv"}, {"delta"}, {"mlp"}):
        fp = fuse_projections(tp, groups=groups)
        got, _ = forward(fp, TCFG, torch.as_tensor(ids), pos)
        assert err_ratio(got, base) < 1e-5, groups
    fp = fuse_projections(tp)
    assert fuse_projections(fp)["text"]["layers"][0] is not None  # idempotent
    assert sorted(leaves(fuse_projections(fp))) == sorted(leaves(fp))
    assert "gate_up" in fp["visual"]["blocks"][0]["mlp"]
    bare = fuse_projections(tp["text"])  # a bare text tree
    assert "layers" in bare and is_fused(bare)


@pytest.mark.parametrize("mode", ["int4", "int8"])
def test_vision_forward_quantized_and_fused_matches_jax(weights, mode):
    jp, _ = weights
    jv = jq.quantize_params(j_fuse(jp), min_size=1024, bits=4 if mode == "int4" else 8,
                            group_size=16)["visual"]
    tv = from_jax_numpy(to_np(jv), "cpu")
    key = "kernel_q4" if mode == "int4" else "kernel_q"
    assert key in tv["blocks"][0]["mlp"]["gate_up"] and key in tv["blocks"][0]["qkv"]
    grid = ((1, 4, 4),)
    px = np.random.RandomState(5).standard_normal((16, 3 * 2 * 14 * 14)).astype(np.float32)
    want = j_vision_forward(jv, CFG.vision, jnp.asarray(px), j_plan(grid, CFG.vision))
    got = vision_forward(tv, TCFG.vision, torch.from_numpy(px), get_vision_plan(grid, TCFG.vision))
    assert err_ratio(got, want) < TOL


@pytest.mark.parametrize("kw", [dict(quant="int8"), dict(quant="int4"),
                                dict(quant="int4", quant_group_size=1 << 20),
                                dict(fuse=True), dict(fuse=True, quant="int4")])
def test_generator_quant_and_fuse_match_jax(wide_weights, kw):
    """Generator(quant=..., fuse=...) on each side from the same fp32
    weights: the served trees identical, greedy tokens identical."""
    jp, tp = wide_weights
    jg, tg = JGenerator(jp, WIDE, **kw), Generator(tp, TWIDE, device="cpu", **kw)
    assert_trees_identical(tg.params, jg.params)
    assert tg.dtype == torch.float32
    if "quant" in kw:
        names = set(k.rsplit("/", 1)[-1] for k in leaves(tg.params))
        assert ("kernel_q4" if kw["quant"] == "int4" else "kernel_q") in names
        assert "embed_q" in names
    ids = np.random.RandomState(7).randint(0, WIDE.text.vocab_size - 8, (2, 20))
    want = jg.generate(ids, max_new_tokens=8)
    got = tg.generate(ids, max_new_tokens=8)
    np.testing.assert_array_equal(got, want)


def test_generator_takes_prequantized_params_and_refuses_unknown_mode(weights, wide_weights):
    """An already quantized tree is served as it is: the activation dtype
    rides on the embedding's scale (bf16 here), as in the JAX Generator."""
    _, tp = weights
    bf = jax.tree.map(lambda t: t.bfloat16() if t.dtype == torch.float32 else t, tp)
    qp = tq.quantize_params(bf, min_size=1024, quantize_embed=True)
    assert "embed" not in qp["text"]
    g = Generator(qp, TCFG, device="cpu")
    assert g.dtype == torch.bfloat16 and g.params is qp
    out = g.generate(np.arange(10)[None] % 400, max_new_tokens=3)
    assert out.shape == (1, 3)
    eng = StreamingEngine(qp, TCFG, frame_hw=(28, 28), device="cpu")
    assert eng.dtype == torch.bfloat16 and eng.params is qp
    fused = StreamingEngine(bf, TCFG, frame_hw=(28, 28), fuse=True, device="cpu")
    assert is_fused(fused.params) and not is_fused(bf)
    eng8 = StreamingEngine(wide_weights[1], TWIDE, frame_hw=(28, 28), quant="int8",
                           device="cpu")
    assert "embed_q" in eng8.params["text"] and eng8.dtype == torch.float32
    with pytest.raises(ValueError, match="unknown quant mode"):
        Generator(tp, TCFG, quant="fp8", device="cpu")
    with pytest.raises(ValueError, match="params are on"):
        Generator(qp, TCFG, device="meta")
