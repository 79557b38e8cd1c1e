"""The quantised integers and scales against the JAX package on the CPU:
int8 kernels, int8 embedding rows, int4 kernels by group size, and whole
trees (int8 / int4, fused or not, an untied head, the options) identical
to JAX's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_quant import (
    CFG,
    TCFG,
    assert_trees_identical,
    leaves,
    to_np,
    weights,
)
from torch_port_helpers import err_ratio
from torch_port_helpers import jax_compile_cache  # noqa: F401 (autouse)

import infinitevl_tpu.models.quant as jq
import infinitevl_tpu_torch.models.quant as tq
from infinitevl_tpu.models.fuse import fuse_projections as j_fuse
from infinitevl_tpu_torch.models.fuse import fuse_projections, is_fused
from infinitevl_tpu_torch.models.params import from_jax_numpy
from infinitevl_tpu_torch.models.text import _dense, lm_head
from infinitevl_tpu_torch.ops.int4_kernels import int4_matmul_fused

torch.set_num_threads(2)


@pytest.mark.parametrize("shape, dtype", [((64, 48), np.float32), ((130, 24), np.float32),
                                          ((64, 48), "bfloat16")])
def test_quantize_kernel_int8_identical(shape, dtype):
    w = (np.random.RandomState(shape[0]).standard_normal(shape) * 0.05).astype(np.float32)
    jw = jnp.asarray(w).astype(dtype)
    tw = from_jax_numpy(np.asarray(jw), "cpu")
    jn, tn = jq.quantize_kernel(jw), tq.quantize_kernel(tw)
    assert tn["kernel_q"].dtype == torch.int8 and tn["scale"].dtype == torch.float32
    assert_trees_identical(tn, jn)
    np.testing.assert_array_equal(tq.dequantize_kernel(tn, torch.float32).numpy(),
                                  np.asarray(jq.dequantize_kernel(jn, jnp.float32)))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_quantize_embed_rows_identical(dtype):
    w = (np.random.RandomState(3).standard_normal((96, 32)) * 0.05).astype(np.float32)
    jw = jnp.asarray(w).astype(dtype)
    jn = jq.quantize_embed_rows(jw)
    tn = tq.quantize_embed_rows(from_jax_numpy(np.asarray(jw), "cpu"))
    assert_trees_identical(tn, jn)
    assert tn["embed_scale"].dtype == (torch.float32 if dtype is np.float32 else torch.bfloat16)
    assert tn["head_q"].shape == (32, 96) and tn["head_q"].is_contiguous()


@pytest.mark.parametrize("shape, group, n_groups", [
    ((64, 48), 16, 4),      # grouped
    ((256, 40), 128, 2),    # one group per plane
    ((60, 36), 16, 1),      # half 30 is no multiple of 16: one group per column
    ((64, 48), 1 << 20, 1), # per-column scales by request
])
def test_quantize_kernel_int4_identical(shape, group, n_groups):
    w = (np.random.RandomState(shape[1]).standard_normal(shape) * 0.05).astype(np.float32)
    jn = jq.quantize_kernel_int4(jnp.asarray(w), group)
    tn = tq.quantize_kernel_int4(torch.from_numpy(w), group)
    assert tn["kernel_q4"].dtype == torch.uint8 and tn["scale4"].shape == (n_groups, shape[1])
    assert_trees_identical(tn, jn)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        for t, j in zip(tq.unpack_int4(tn["kernel_q4"], dt), jq.unpack_int4(jn["kernel_q4"], jdt)):
            np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32))
    np.testing.assert_array_equal(
        tq.dequantize_kernel_int4(tn, torch.float32).numpy(),
        np.asarray(jq.dequantize_kernel_int4(jn, jnp.float32)))
    # the dual-plane matmul of both packages and kernel G's plain version
    x = np.random.RandomState(1).standard_normal((3, shape[0])).astype(np.float32)
    ref = jq.int4_matmul(jnp.asarray(x), jn)
    assert err_ratio(tq.int4_matmul(torch.from_numpy(x), tn), ref) < 1e-5
    assert err_ratio(int4_matmul_fused(torch.from_numpy(x), tn), ref) < 1e-5
    assert err_ratio(_dense(torch.from_numpy(x), tn), ref) < 1e-5
    with pytest.raises(ValueError, match="even d_in"):
        tq.quantize_kernel_int4(torch.zeros(5, 4))


@pytest.mark.parametrize("bits, fuse", [(8, False), (4, False), (4, True), (8, True)])
def test_quantize_params_tree_identical(weights, bits, fuse):
    """Fuse (optionally), then quantize on each side: the same tree, the
    same integers and scales, the same byte count. The JAX tree also comes
    across whole through from_jax_numpy (int8 / uint8 leaves kept)."""
    jp, tp = weights
    if fuse:
        jp, tp = j_fuse(jp), fuse_projections(tp)
        assert is_fused(tp) and not is_fused(weights[1])
        assert_trees_identical(tp, jp)
    kw = dict(min_size=1024, bits=bits, group_size=32, quantize_embed=True)
    jqp, tqp = jq.quantize_params(jp, **kw), tq.quantize_params(tp, **kw)
    assert_trees_identical(tqp, jqp)
    assert tq.quantized_bytes(tqp) == jq.quantized_bytes(jqp)
    assert tq.quantized_bytes(tqp) < tq.quantized_bytes(tp)
    carried = from_jax_numpy(to_np(jqp), "cpu")
    assert_trees_identical(carried, jqp)
    names = set(k.rsplit("/", 1)[-1] for k in leaves(tqp))
    assert ("kernel_q4" if bits == 4 else "kernel_q") in names
    assert {"embed_q", "embed_scale", "head_q"} <= names and "embed" not in names
    assert ("gate_up" in str(sorted(leaves(tqp)))) == fuse
    # the input tree is left as it was
    assert "kernel" in tp["text"]["layers"][0]["mlp"]["gate_up" if fuse else "gate"]


def test_quantize_params_untied_head_and_options(weights):
    jp, tp = weights
    w = np.random.RandomState(0).standard_normal((64, 512)).astype(np.float32) * 0.05
    jt = {**jp["text"], "lm_head": jnp.asarray(w)}
    tt = {**tp["text"], "lm_head": torch.from_numpy(w)}
    kw = dict(min_size=1024, quantize_embed=True)
    jqp, tqp = jq.quantize_params(jt, **kw), tq.quantize_params(tt, **kw)
    assert_trees_identical(tqp, jqp)
    assert "lm_head_q" in tqp and "lm_head" not in tqp
    h = np.random.RandomState(1).standard_normal((2, 64)).astype(np.float32)
    from infinitevl_tpu.models.text import lm_head as j_lm_head

    assert err_ratio(lm_head(tqp, TCFG.text, torch.from_numpy(h)),
                     j_lm_head(jqp, CFG.text, jnp.asarray(h))) < 1e-5
    with pytest.raises(ValueError, match="bits"):
        tq.quantize_params(tp, bits=3)
    # biased nibble storage is a probe no entry point produces: not ported
    with pytest.raises(NotImplementedError, match="kernel_q4b"):
        tq.quantize_params(tp, bits=4, int4_biased=True)
    with pytest.raises(NotImplementedError, match="kernel_q4b"):
        _dense(torch.zeros(1, 4), {"kernel_q4b": torch.zeros(2, 4, dtype=torch.uint8),
                                   "scale4": torch.ones(1, 4)})
    # prefer_fused_int4 renames every int4 node; both keys take kernel G
    q4 = tq.quantize_params(tp, min_size=1024, bits=4, group_size=32)
    f4 = tq.prefer_fused_int4(q4)
    assert sorted(k.replace("kernel_q4f", "kernel_q4") for k in leaves(f4)) == sorted(leaves(q4))
    assert any(k.endswith("kernel_q4f") for k in leaves(f4))
    assert not any(k.endswith("kernel_q4") for k in leaves(f4))
