"""The sequence-chunked pieces of the long-context layers against the JAX
package on the CPU in fp32: `causal_conv1d` with the history's segment
ids, `mlp_forward_chunked`, and `decoder_layer_chunk_forward` from a
nonzero carry, the carried state's gradient included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_longctx import (
    B,
    GRAD_TOL,
    JCFG,
    OUT_TOL,
    TCFG,
    _compare,
    _cos_sin,
    _layer,
    _x,
)
from torch_port_helpers import err_ratio
from torch_port_helpers import jax_compile_cache  # noqa: F401 (autouse)

import infinitevl_tpu.models.text as jtext
import infinitevl_tpu_torch.models.text as ttext
from infinitevl_tpu.config import LINEAR, SLIDING
from infinitevl_tpu.ops.short_conv import causal_conv1d as jconv
from infinitevl_tpu_torch.ops.short_conv import causal_conv1d as tconv

torch.set_num_threads(2)


def _carry(role, seed):
    """A nonzero carry, as a chunk past the first hands on: random K/V or
    state and tails, with the segment ids of a packed row whose segment 2
    continues into the next call."""
    rng = np.random.RandomState(seed)
    jc = jtext.init_layer_seq_carry(_layer(role), JCFG, role, B, jnp.float32)
    out = []
    for t in jc:
        t = np.asarray(t)
        if t.dtype == np.int32:
            t = np.full(t.shape, 2, np.int32)
            t[1] = 5
            if role == LINEAR:
                t[0, 0] = 1
        else:
            t = (rng.standard_normal(t.shape) * (0.1 if t.ndim == 4 and role == LINEAR
                                                  else 0.3)).astype(np.float32)
        out.append(t)
    return out



def test_causal_conv1d_with_history_segment_ids_matches_jax():
    """A segment that continues from the history keeps its taps; one that
    starts on the edge, and the -1 history, see none."""
    rng = np.random.RandomState(0)
    T, D, Wc = 12, 24, 4
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    w = rng.standard_normal((Wc, D)).astype(np.float32)
    b = rng.standard_normal((D,)).astype(np.float32)
    hist = rng.standard_normal((B, Wc, D)).astype(np.float32)
    seg = np.asarray([[3] * 5 + [4] * 7, [9] * T], np.int32)
    hseg = np.asarray([[-1, 3, 3], [8, 8, 8]], np.int32)
    want = jconv(x, w, b, initial_state=hist, segment_ids=seg,
                 initial_state_segment_ids=hseg)
    got = tconv(*(torch.from_numpy(a) for a in (x, w, b)), initial_state=torch.from_numpy(hist),
                segment_ids=torch.from_numpy(seg),
                initial_state_segment_ids=torch.from_numpy(hseg))
    assert err_ratio(got, want) <= OUT_TOL
    # without history ids the history is invisible, as before
    plain = tconv(*(torch.from_numpy(a) for a in (x, w, b)),
                  initial_state=torch.from_numpy(hist), segment_ids=torch.from_numpy(seg))
    assert err_ratio(plain, jconv(x, w, b, initial_state=hist, segment_ids=seg)) <= OUT_TOL
    assert not torch.allclose(plain[:, :3], got[:, :3])


def test_mlp_forward_chunked_matches_jax():
    p = _layer(LINEAR)["mlp"]
    y_err, g_err = _compare(lambda p, x: jtext.mlp_forward_chunked(p, x, 16),
                            lambda p, x: ttext.mlp_forward_chunked(p, x, 16), p, [_x(64)])
    assert y_err <= OUT_TOL and g_err <= GRAD_TOL, (y_err, g_err)


@pytest.mark.parametrize("role", [SLIDING, LINEAR])
def test_decoder_layer_chunk_forward_matches_jax(role):
    """One call of the carry form from a nonzero carry over a packed row
    whose segment crosses the call's edge: the output, the carry out and
    the gradients of the input, the carry in (the state's included) and
    every leaf."""
    T = 32
    seg = np.asarray([[2] * 10 + [3] * 22, [5] * T], np.int32)
    cos, sin = _cos_sin(T)
    carry = _carry(role, 3)
    nc = len(carry)

    def run(mod, cfg):
        def f(p, x, c, s, sg, *cr):
            y, out = mod.decoder_layer_chunk_forward(p, cfg, role, x, c, s, sg, tuple(cr))
            lib = jnp if mod is jtext else torch
            floats = [t for t in out if t.dtype == lib.float32]
            return lib.concatenate([y.reshape(-1)] + [t.reshape(-1) for t in floats])
        return f

    y_err, g_err = _compare(run(jtext, JCFG), run(ttext, TCFG), _layer(role),
                            [_x(T), cos, sin, seg, *carry])
    assert nc == (3 if role == SLIDING else 5)
    assert y_err <= OUT_TOL and g_err <= GRAD_TOL, (y_err, g_err)
