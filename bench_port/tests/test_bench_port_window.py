"""The window's arithmetic, seeded traffic, and the work and FLOP counts
against hand counts at small shapes."""

import numpy as np
import pytest
from conftest import TINY_DOCQA, TINY_STREAM, tiny_spec

from harness import flops, peaks
from harness.spec import BENCH_DIR, load_module, work_module
from harness.stats import median, percentile, rate


def test_rate_is_window_work_over_window_time_with_a_stall():
    # 10 steps of 16 frames at 0.1 s, one stall of 1 s: the rate counts the stall
    ends = np.cumsum([0.1] * 5 + [1.0] + [0.1] * 4)
    assert rate(160, 0.0, float(ends[-1])) == pytest.approx(160 / 1.9)


def test_p95_and_median_over_all_steps_and_requests():
    steps = [0.1] * 99 + [2.0]  # one stall among 100 steps
    assert percentile(steps, 95.0) == pytest.approx(0.1)
    steps = [0.1] * 90 + [2.0] * 10  # ten stalls reach the 95th percentile
    assert percentile(steps, 95.0) == pytest.approx(2.0)
    assert percentile([1.0, 2.0, 3.0, 4.0], 95.0) == pytest.approx(np.percentile([1, 2, 3, 4], 95))
    assert median([5.0, 1.0, 3.0]) == 3.0
    assert median([4.0, 1.0, 3.0, 2.0]) == 2.5


def test_stream_traffic_repeats_for_a_seed():
    import torch

    drv = load_module(BENCH_DIR / "drivers" / "stream.py")
    a = drv._frames(TINY_STREAM, 2**31 + 99, torch.device("cpu"))
    b = drv._frames(TINY_STREAM, 2**31 + 99, torch.device("cpu"))
    c = drv._frames(TINY_STREAM, 2**31 + 98, torch.device("cpu"))
    assert a.dtype == np.uint8 and a.shape == (4, 3, 112, 112, 3)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert drv.plan(TINY_STREAM, 5) == drv.plan(TINY_STREAM, 5)
    rows, step, probe = drv.plan(TINY_STREAM, 5)
    assert rows[0] < 2 <= rows[1] and 2 <= step <= 3 and 0 <= probe < 500


def test_docqa_traffic_repeats_for_a_seed_and_every_document_is_its_own():
    drv = load_module(BENCH_DIR / "drivers" / "docqa.py")
    p = [drv.prompt(TINY_DOCQA, 2**31 + 7, i) for i in range(4)]
    assert np.array_equal(p[1], drv.prompt(TINY_DOCQA, 2**31 + 7, 1))
    assert [x.shape[1] for x in p] == [2104, 304, 604, 2104]
    assert not np.array_equal(p[0], p[3])
    assert int(max(x.max() for x in p)) < TINY_DOCQA["id_high"]
    done = [(i, 0.1, [1, 2]) for i in range(7)]
    s = drv.check_sample(TINY_DOCQA, 3, done)
    assert s == drv.check_sample(TINY_DOCQA, 3, done) and len(s) == 3
    assert any(i % 3 == 0 for i, _ in s)  # one of the longest documents


def test_the_five_document_lengths_keep_the_median_in_the_middle_one():
    # with equal shares of five lengths the median stays on the third, whatever
    # request the window ends on
    lengths = [8192, 20480, 32768, 14336, 26624]
    for n in range(10, 40):
        got = median([lengths[i % 5] for i in range(n)])
        assert got == 20480, n


def test_delta_chunk_work_by_hand():
    w = work_module(BENCH_DIR, "delta_chunk")
    # one full chunk of 64, H 1, K = V = 2
    f, b, peak = w.work(B=1, T=64, H=1, K=2, V=2)
    C = 64
    hand = C * 63 * 2 + C * 65 * 2 + C * 63 * 4 + 6 * C * 4 + C * 65 * 2
    assert f == hand
    assert b == 2 * (2 * 64 * 2 + 2 * 64 * 2) + 4 * (2 * 64 + 2 * 4)
    assert peak == peaks.PEAK_BF16_FLOPS
    # a partial chunk counts its own tokens: 65 tokens = a chunk of 64 + one of 1
    f65, _, _ = w.work(B=1, T=65, H=1, K=2, V=2)
    assert f65 == hand + (0 + 2 * 2 + 0 + 6 * 4 + 2 * 2)


def test_swa_ring_and_vit_flash_work_by_hand():
    w = work_module(BENCH_DIR, "swa_ring")
    # 3 queries at positions 5, 6, 7 with a window of 4: 4 keys each
    f, b, _ = w.work(B=1, T=3, Hq=2, Hkv=1, D=8, cap=4, cum_len=5, window=4)
    assert f == 4 * 2 * 8 * 12
    assert b == 2 * (2 * 3 * 2 * 8 + 2 * 3 * 8 + 2 * 4 * 8)
    # before the ring fills: queries at 0, 1 see 1 and 2 keys
    assert w.work(B=1, T=2, Hq=1, Hkv=1, D=1, cap=4, cum_len=0, window=4)[0] == 4 * 3
    v = work_module(BENCH_DIR, "vit_flash")
    f, b, _ = v.work(S=128, H=2, D=4, L=64)
    assert f == 4 * 2 * 4 * 128 * 64 and b == 2 * 4 * 128 * 2 * 4 + 4 * 128


def test_visible_keys_by_hand():
    for cum, T, W in [(0, 5, 3), (2, 5, 8), (10, 4, 8), (0, 300, 64), (7, 1, 8)]:
        assert flops.visible_keys(cum, T, W) == sum(min(W, cum + t + 1) for t in range(T))


def test_vit_and_stream_flops_by_hand():
    spec = tiny_spec()
    v = spec["vision"]
    D, I, H = v["hidden_size"], v["intermediate_size"], v["num_heads"]
    gh = gw = 8  # a 112 x 112 frame: windows of 8 x 8 patches = the whole frame
    n = gh * gw
    per_block = 2 * n * D * 4 * D + 2 * n * 3 * D * I + 4 * D * n * n
    merged = n // 4
    hand = (2 * n * 3 * 2 * 14 * 14 * D + v["depth"] * per_block
            + 2 * merged * 4 * D * 4 * D + 2 * merged * 4 * D * v["out_hidden_size"])
    assert flops.vit_frame_flops(spec, gh, gw) == hand
    t = spec["text"]
    Dt, It = t["hidden_size"], t["intermediate_size"]
    swa = 2 * Dt * (2 * 4 * 16 + 2 * 2 * 16) + 6 * Dt * It
    HK, HV = 4 * 16, 4 * 32
    delta = 2 * Dt * (HK + HK + HV + 2 * 4 + HV) + 2 * HV * Dt + 6 * Dt * It
    assert flops.decoder_linear_flops_per_token(spec) == 2 * swa + 6 * delta
    T = 17  # <vision_start> + 16 merged tokens
    frame = flops.stream_frame_flops(spec, gh, gw, cum_len=100)
    want = (hand + T * (2 * swa + 6 * delta) + 2 * 4 * 4 * 16 * T * 16
            + 6 * flops.delta_chunk_flops(T, 4, 16, 32))
    assert frame == pytest.approx(want)
