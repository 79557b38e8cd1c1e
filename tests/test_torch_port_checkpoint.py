"""HF safetensors checkpoints in and out of the port, against the
`safetensors` package and the JAX package on the CPU.

- the port's codec (utils/safetensors_io.py) against the `safetensors`
  package in both directions, per dtype, in one file and in shards;
- JAX export -> port loader: leaves bit-equal to from_jax_numpy's, text
  and multimodal logits within 1e-5 (err_ratio) of JAX's, tied and untied;
- port export -> JAX loader: leaves bit-equal (fp32 and bf16); config.json
  read back to equal configs by both packages;
- the loader's details: legacy names, `params=` overlays, no match raises,
  param_count, and mimic_init's deterministic parts against JAX's."""

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

import infinitevl_tpu.models.params as jparams
import infinitevl_tpu.utils.checkpoint as jckpt
import infinitevl_tpu_torch.models.params as tparams
import infinitevl_tpu_torch.utils.checkpoint as tckpt
from infinitevl_tpu.config import from_hf_json as jfrom_hf_json
from infinitevl_tpu.config import infinitevl_3b, tiny_config
from infinitevl_tpu.models.infinitevl import forward as _jforward
from infinitevl_tpu.models.infinitevl import get_rope_index as jrope_index
from infinitevl_tpu_torch.config import from_hf_json as tfrom_hf_json
from infinitevl_tpu_torch.models.infinitevl import forward as tforward
from infinitevl_tpu_torch.train.step import tree_leaves_with_path
from infinitevl_tpu_torch.utils import safetensors_io as sio

torch.set_num_threads(2)

CFG = tiny_config()
TCFG = to_port_config(CFG)
jforward = jax.jit(_jforward, static_argnames=("cfg", "grid_thw"))


def _leaves(tree):
    return dict(tree_leaves_with_path(tree))


def _assert_bit_equal(got, want):
    g, w = _leaves(got), _leaves(want)
    assert set(g) == set(w), set(g) ^ set(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        assert torch.equal(g[k], w[k]), k


def _jax_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _jax_leaves(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _jax_leaves(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, np.asarray(tree)


# ---------------------------------------------------------------- the codec

_DT = {"F32": torch.float32, "BF16": torch.bfloat16, "F16": torch.float16,
       "I64": torch.int64}


def _sample(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    if dtype.is_floating_point:
        mk = lambda *s: torch.randn(s, generator=g).to(dtype)
    else:
        mk = lambda *s: torch.randint(-2**40, 2**40, s, generator=g, dtype=dtype)
    base = mk(5, 7)
    return {"a.weight": base.T,  # a transposed view: its bytes must be the view's
            "b": mk(3, 1, 4), "c.scalar": mk(), "d": mk(0, 3), "e": mk(64)}


def _write_index(d, shards):
    index = {"weight_map": {n: f for f, names in shards.items() for n in names},
             "metadata": {"total_size": 0}}
    with open(os.path.join(d, "model.safetensors.index.json"), "w") as f:
        json.dump(index, f)


@pytest.mark.parametrize("sharded", [False, True], ids=["one_file", "sharded"])
@pytest.mark.parametrize("name", list(_DT))
def test_codec_against_the_safetensors_package(tmp_path, name, sharded):
    from safetensors import safe_open
    from safetensors.torch import save_file as pkg_save

    dtype = _DT[name]
    tensors = _sample(dtype)
    groups = ({"model-00001-of-00002.safetensors": ["a.weight", "b"],
               "model-00002-of-00002.safetensors": ["c.scalar", "d", "e"]} if sharded
              else {"model.safetensors": list(tensors)})
    for direction in ("port_writes", "package_writes"):
        d = tmp_path / direction
        d.mkdir()
        for fn, names in groups.items():
            part = {n: tensors[n] for n in names}
            if direction == "port_writes":
                sio.save_file(part, str(d / fn), metadata={"format": "pt"})
            else:
                pkg_save({n: t.contiguous() for n, t in part.items()}, str(d / fn),
                         metadata={"format": "pt"})
        if sharded:
            _write_index(str(d), groups)
        files = tparams.checkpoint_files(str(d))
        assert [os.path.basename(f) for f in files] == sorted(groups)
        ours = {k: v for f in files for k, v in sio.iter_file(f)}
        theirs = {}
        for f in files:
            with safe_open(f, framework="pt") as h:
                assert h.metadata() == {"format": "pt"} == sio.read_metadata(f)
                theirs.update({k: h.get_tensor(k) for k in h.keys()})
        for got in (ours, theirs):
            assert set(got) == set(tensors)
            for k, want in tensors.items():
                assert got[k].dtype == dtype and got[k].shape == want.shape, k
                assert torch.equal(got[k], want), (direction, k)
        if direction == "port_writes":  # the header is padded to 8 bytes
            with open(files[0], "rb") as f:
                assert int.from_bytes(f.read(8), "little") % 8 == 0


# ---------------------------------------------------------------- JAX <-> port


def _cfg(tied: bool):
    return dataclasses.replace(CFG, text=dataclasses.replace(CFG.text,
                                                             tie_word_embeddings=tied))


def _mm_inputs():
    ids = np.concatenate([np.arange(3, 6), [CFG.vision_start_token_id],
                          [CFG.image_token_id] * 4, np.arange(7, 9)])[None]
    grid = np.array([[1, 4, 4]])
    pos, _ = jrope_index(CFG, ids, grid)
    px = np.random.RandomState(5).standard_normal((16, 3 * 2 * 14 * 14)).astype(np.float32)
    return ids, np.asarray(pos), px


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_jax_export_loads_into_the_port(tmp_path, tied):
    """Leaves bit-equal to from_jax_numpy's; the loaded model's text and
    multimodal logits bit-equal to those of the carried weights and within
    1e-5 of JAX's (err_ratio, fp32)."""
    cfg = _cfg(tied)
    jp = jparams.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    jckpt.export_hf_safetensors(jp, cfg, str(tmp_path), max_shard_bytes=300_000)
    assert os.path.exists(tmp_path / "model.safetensors.index.json")
    got = tparams.load_hf_checkpoint(str(tmp_path), to_port_config(cfg), torch.float32,
                                     device="cpu")
    carried = tparams.from_jax_numpy(jax.tree.map(np.asarray, jp), "cpu")
    _assert_bit_equal(got, carried)
    assert ("lm_head" in got["text"]) == (not tied)

    ids = np.random.RandomState(1).randint(0, CFG.text.vocab_size - 8, (2, 11))
    pos = np.broadcast_to(np.arange(11)[None, None], (3, 2, 11)).copy()
    mm_ids, mm_pos, px = _mm_inputs()
    tcfg = to_port_config(cfg)
    for ids_, pos_, kw_j, kw_t in (
            (ids, pos, {}, {}),
            (mm_ids, mm_pos, dict(pixel_values=jnp.asarray(px), grid_thw=((1, 4, 4),)),
             dict(pixel_values=torch.from_numpy(px), grid_thw=((1, 4, 4),)))):
        want, _ = jforward(jp, cfg, jnp.asarray(ids_), jnp.asarray(pos_), **kw_j)
        with torch.no_grad():
            a, _ = tforward(got, tcfg, torch.from_numpy(ids_), torch.from_numpy(pos_), **kw_t)
            b, _ = tforward(carried, tcfg, torch.from_numpy(ids_), torch.from_numpy(pos_),
                            **kw_t)
        assert torch.equal(a, b)
        assert err_ratio(a, want) < 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shard", [None, 200_000], ids=["one_file", "sharded"])
def test_port_export_loads_into_jax(tmp_path, dtype, shard):
    tp = tparams.init_params(TCFG, torch.Generator().manual_seed(3), "cpu", dtype)
    kw = {} if shard is None else {"max_shard_bytes": shard}
    nbytes = tckpt.export_hf_safetensors(tp, TCFG, str(tmp_path), **kw)
    inv = tp["text"]["inv_freq"]
    assert nbytes == sum(t.numel() * t.element_size() for _, t in tree_leaves_with_path(tp)) \
        - inv.numel() * inv.element_size()  # inv_freq is rebuilt, not stored
    assert os.path.exists(tmp_path / "model.safetensors.index.json") == (shard is not None)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jp = jparams.load_hf_checkpoint(str(tmp_path), CFG, jdtype)
    want = dict(_jax_leaves(jp))
    got = _leaves(tp)
    assert set(got) == set(want)
    for k, t in got.items():
        w = want[k]
        if dtype == torch.bfloat16 and w.dtype.name == "bfloat16":
            w = torch.from_numpy(w.view(np.int16).copy()).view(torch.bfloat16)
        else:
            w = torch.from_numpy(np.array(w))
        assert torch.equal(t, w.to(t.dtype)) and w.dtype == t.dtype, k
    # and back into the port, bit for bit
    _assert_bit_equal(tparams.load_hf_checkpoint(str(tmp_path), TCFG, dtype, device="cpu"), tp)


@pytest.mark.parametrize("which", ["tiny", "3b"])
def test_config_json_reads_back_equal_in_both_packages(tmp_path, which):
    jcfg = tiny_config() if which == "tiny" else infinitevl_3b()
    tcfg = to_port_config(jcfg)
    assert tckpt.config_to_hf_dict(tcfg) == jckpt.config_to_hf_dict(jcfg)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(tckpt.config_to_hf_dict(tcfg)))
    assert tfrom_hf_json(str(path)) == to_port_config(jfrom_hf_json(str(path)))
    if which == "3b":  # the deployed config survives the round trip whole
        assert tfrom_hf_json(str(path)) == tcfg


def test_loader_details(tmp_path):
    """Legacy names (model.* / visual.*), a `params=` overlay keeps what the
    checkpoint lacks, a stored lm_head is dropped under tied embeddings, a
    directory with no matching tensor raises, param_count equals JAX's."""
    tp = tparams.init_params(TCFG, torch.Generator().manual_seed(4), "cpu", torch.float32)
    tensors = tckpt.hf_tensors(tp, TCFG)
    legacy = {k.replace("model.language_model.", "model.").replace("model.visual.", "visual."): v
              for k, v in tensors.items()}
    legacy["lm_head.weight"] = tp["text"]["embed"]  # tied: stored but not read
    sio.save_file(legacy, str(tmp_path / "model.safetensors"))
    _assert_bit_equal(tparams.load_hf_checkpoint(str(tmp_path), TCFG, torch.float32,
                                                 device="cpu"), tp)
    # text only into a template: the visual tree keeps the template's values
    other = tparams.init_params(TCFG, torch.Generator().manual_seed(5), "cpu", torch.float32)
    text_only = tmp_path / "text"
    text_only.mkdir()
    sio.save_file({k: v for k, v in tensors.items() if "visual" not in k},
                  str(text_only / "model.safetensors"))
    got = tparams.load_hf_checkpoint(str(text_only), TCFG, torch.float32, params=other,
                                     device="cpu")
    _assert_bit_equal(got["text"], tp["text"])
    _assert_bit_equal(got["visual"], other["visual"])
    empty = tmp_path / "empty"
    empty.mkdir()
    sio.save_file({"something.else": torch.zeros(2)}, str(empty / "model.safetensors"))
    with pytest.raises(ValueError, match="no tensors matched"):
        tparams.load_hf_checkpoint(str(empty), TCFG, torch.float32, device="cpu")
    jp = jparams.init_params(jax.random.PRNGKey(0), CFG, jnp.float32)
    assert tparams.param_count(tp) == jparams.param_count(jp)


def test_mimic_init_deterministic_parts_equal_jax():
    """The warm start's fixed values (identity conv tap, zero a / b
    projections, A_log 0, the norms) bit-equal to JAX's; dt_bias, the
    inverse softplus of dt = 1e-3 in fp32, within one ulp (torch rounds it
    as float64 arithmetic does, XLA's fp32 log / expm1 one ulp away); the
    random parts keep their shapes."""
    jl = jparams.init_delta_layer(jax.random.PRNGKey(0), CFG.text, jnp.float32,
                                  mimic_init=True)
    tl = tparams.init_delta_layer(TCFG.text, torch.Generator().manual_seed(0), "cpu",
                                  torch.float32, mimic_init=True)
    want = dict(_jax_leaves(jl))
    got = _leaves(tl)
    assert set(got) == set(want)
    fixed = ("conv_q_w", "conv_k_w", "conv_v_w", "a_proj/kernel", "b_proj/kernel", "A_log",
             "input_norm", "post_norm", "o_norm")
    for k, t in got.items():
        assert tuple(t.shape) == want[k].shape and str(t.dtype)[6:] == str(want[k].dtype), k
        if k in fixed:
            assert torch.equal(t, torch.from_numpy(np.array(want[k]))), k
    ulps = np.abs(got["dt_bias"].numpy().view(np.int32).astype(np.int64)
                  - want["dt_bias"].view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    dt = torch.tensor(1e-3, dtype=torch.float32).double()
    assert torch.equal(got["dt_bias"], (dt + torch.log(-torch.expm1(-dt))).float().expand(4))
