"""The Mamba2 SSD chunk scan against the JAX package on the CPU: aligned,
unaligned and packed rows and from a state (<= 1e-5), and bf16 inputs
accumulated in fp32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_mamba2 import OP_TOL, _packed, _scan_inputs
from torch_port_helpers import err_ratio
from torch_port_helpers import jax_compile_cache  # noqa: F401 (autouse)

from infinitevl_tpu.ops import mamba2 as jm2
from infinitevl_tpu_torch.ops import mamba2 as tm2

torch.set_num_threads(2)


@pytest.mark.parametrize("T,packed,init", [(24, False, False), (21, False, False),
                                           (24, True, False), (21, False, True),
                                           (21, True, True)],
                         ids=["aligned", "unaligned", "packed", "initial_state",
                              "packed_initial_state"])
def test_chunk_scan_matches_jax(T, packed, init):
    x, dt, A, b, c, h0 = _scan_inputs(T=T)
    seg = _packed(2, T) if packed else None
    want_y, want_h = jm2.mamba2_chunk_scan(
        *map(jnp.asarray, (x, dt, A, b, c)), initial_state=jnp.asarray(h0) if init else None,
        chunk_size=8, segment_ids=None if seg is None else jnp.asarray(seg))
    y, h = tm2.mamba2_chunk_scan(
        *map(torch.from_numpy, (x, dt, A, b, c)),
        initial_state=torch.from_numpy(h0) if init else None, chunk_size=8,
        segment_ids=None if seg is None else torch.from_numpy(seg))
    assert y.shape == (2, T, 2, 8) and h.dtype == torch.float32
    assert err_ratio(y, want_y) < OP_TOL and err_ratio(h, want_h) < OP_TOL
    # chunk-size invariant, and the recurrence's numbers (no segments)
    if not packed:
        y4, _ = tm2.mamba2_chunk_scan(*map(torch.from_numpy, (x, dt, A, b, c)),
                                      initial_state=torch.from_numpy(h0) if init else None,
                                      chunk_size=4)
        yr, hr = tm2.mamba2_recurrent(*map(torch.from_numpy, (x, dt, A, b, c)),
                                      initial_state=torch.from_numpy(h0) if init else None)
        assert err_ratio(y4, y) < OP_TOL and err_ratio(yr, y) < OP_TOL
        assert err_ratio(hr, h) < OP_TOL


def test_chunk_scan_bf16_inputs_accumulate_in_fp32():
    x, dt, A, b, c, _ = _scan_inputs(T=40)
    bf = [torch.from_numpy(t).bfloat16() for t in (x, b, c)]
    y, h = tm2.mamba2_chunk_scan(bf[0], torch.from_numpy(dt), torch.from_numpy(A), bf[1], bf[2],
                                 chunk_size=16)
    want_y, want_h = jm2.mamba2_chunk_scan(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in bf[:1]),
        jnp.asarray(dt), jnp.asarray(A),
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in bf[1:]), chunk_size=16)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    assert err_ratio(h, np.asarray(want_h)) < OP_TOL
    assert err_ratio(y.float(), np.asarray(want_y.astype(jnp.float32))) < 1e-2  # y rounded
