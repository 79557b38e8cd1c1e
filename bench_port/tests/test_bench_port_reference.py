"""The frozen plain fp32 reference against the port at a tiny size on the
CPU (the test may import the port; the reference may not): its chunked
rules against their token recurrences, its preprocessing against the port's,
its ViT against the port's vision forward, and whole runs of each driver
compared to the reference at fp32 rounding."""

import numpy as np
import pytest
import torch
from conftest import run_tiny, tiny_spec

from reference import infinitevl as ref


def _rand(*shape, gen):
    return torch.randn(*shape, generator=gen, dtype=torch.float64).float()


@pytest.mark.parametrize("T", [1, 63, 64, 150])
def test_delta_rule_chunked_matches_its_recurrence(T):
    g = torch.Generator().manual_seed(T)
    H, K, V = 3, 8, 12
    q, k, v = _rand(T, H, K, gen=g), _rand(T, H, K, gen=g), _rand(T, H, V, gen=g)
    gate = -torch.rand(T, H, generator=g).double().float()
    beta = torch.rand(T, H, generator=g)
    o, s = ref.delta_rule(q, k, v, gate, beta)
    o2, s2 = ref.delta_rule_recurrent(q, k, v, gate, beta)
    assert torch.allclose(o, o2, atol=2e-5) and torch.allclose(s, s2, atol=2e-5)
    # from a state: the rule over [0, t) then [t, T) is the rule over [0, T)
    if T > 10:
        oa, sa = ref.split_scan(ref.delta_rule, 10, q, k, v, gate, beta)
        assert torch.allclose(oa, o, atol=2e-5) and torch.allclose(sa, ref.delta_rule(
            q[:10], k[:10], v[:10], gate[:10], beta[:10])[1], atol=2e-5)


@pytest.mark.parametrize("T", [1, 64, 100])
def test_ssd_chunked_matches_its_recurrence(T):
    g = torch.Generator().manual_seed(100 + T)
    H, N, P = 2, 6, 5
    x, Bm, Cm = _rand(T, H, P, gen=g), _rand(T, H, N, gen=g), _rand(T, H, N, gen=g)
    dt = torch.rand(T, H, generator=g) * 0.5
    A = -torch.rand(H, generator=g) * 4
    y, h = ref.ssd(x, dt, A, Bm, Cm)
    y2, h2 = ref.ssd_recurrent(x, dt, A, Bm, Cm)
    assert torch.allclose(y, y2, atol=2e-5) and torch.allclose(h, h2, atol=2e-5)


def test_preprocessing_matches_the_ports():
    from infinitevl_tpu_torch import native
    from infinitevl_tpu_torch.data.processing import normalize, patchify

    S = ref.Sizes(tiny_spec())
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, (112, 84, 3), dtype=np.uint8)
    got = ref.normalize_patchify(torch.as_tensor(frame), S).numpy()
    want, _ = patchify(normalize(frame[None]), 14, 2, 2)
    assert np.allclose(got, want, atol=1e-6)
    if native.available():  # the window's path: the native pipeline, same-size resize
        nat = native.preprocess_frame(frame, (112, 84))
        assert np.allclose(got, nat, atol=1e-5)


@pytest.mark.parametrize("hw", [(112, 112), (224, 168)])
def test_vit_matches_the_ports_vision_forward(hw):
    from harness.weights import build, port_config
    from infinitevl_tpu_torch.models.vision import get_vision_plan, vision_forward

    spec = tiny_spec()
    spec["vision"]["depth"] = 3
    spec["vision"]["fullatt_block_indexes"] = [1]
    cfg = port_config(spec)
    params = build(spec, 3, torch.device("cpu"))
    S = ref.Sizes(spec)
    H, W = hw
    frame = torch.randint(0, 256, (H, W, 3), generator=torch.Generator().manual_seed(1),
                          dtype=torch.uint8)
    patches = ref.normalize_patchify(frame, S)
    gh, gw = H // 14, W // 14
    want = vision_forward(params["visual"], cfg.vision, patches,
                          get_vision_plan(((1, gh, gw),), cfg.vision))
    got = ref.vit_frame(params["visual"], S, patches, gh, gw)
    assert (got - want).norm() / want.norm() < 1e-5


@pytest.mark.parametrize("cell", ["stream_tiny.delta", "stream_tiny.m2", "docqa_tiny.delta"])
def test_each_driver_agrees_with_the_reference(tiny_bench, cell):
    """The whole timed path at the tiny size in fp32: the SWA ring's wrap, the
    DeltaNet / Mamba2 state, conv tails, probe logits; a document across
    the 2,048-token prefill chunk."""
    root, bench = tiny_bench
    out, lines = run_tiny(root, bench, cell, seed=2**31 + 5)
    assert out["correct"], lines
    for c in out["checks"].values():
        assert c["value"] <= 1e-5
