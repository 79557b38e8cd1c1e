"""The comparison that decides `correct` has to fail what is wrong.

- The control: the reference with its linear layers' operands in float8
  e4m3 (the step below the configurations' bf16) in the program's place.
  On the CPU at the tiny size it reads above the tiny limits; on the card,
  at each cell's own size, above the cell's committed limits (`card`).
- Faults planted under a run, the harness's look for a card skipped: a
  step that returns its state unchanged, half of the batch left out, a
  token altered where it is produced. Each run reads `correct` false."""

import json

import pytest
import torch
from conftest import ROOT, run_tiny

from harness.spec import read_json, resolve
from reference import infinitevl as ref


def test_the_control_fails_at_the_tiny_size(tiny_bench):
    import time

    from harness.context import RunContext

    root, bench = tiny_bench
    for name in ("stream_tiny.delta", "stream_tiny.m2", "docqa_tiny.delta"):
        cell = resolve(bench, name, root)
        drv = cell.driver()
        res = drv.run(RunContext(cell, 11, 0.5, False, torch.device("cpu"), time.perf_counter()))
        got = drv.control(cell, 11, torch.device("cpu"), ref.mm_fp8, res.checked)
        assert any(got[k] > cell.limits[k] for k in cell.limits), (name, got)
        assert all(res.checks[k] <= cell.limits[k] for k in cell.limits), (name, res.checks)


def test_fp8_rounding_is_the_step_below_bf16():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0)) * 0.02
    e8 = ((ref.round_fp8(x) - x).norm() / x.norm()).item()
    e16 = ((x.bfloat16().float() - x).norm() / x.norm()).item()
    assert 4 * e16 < e8 < 0.1


def _stream_fault(kind):
    """A replacement for streaming.stream_frames_batched with a fault planted."""
    import infinitevl_tpu_torch.streaming as st

    real = st.stream_frames_batched

    def step(params, cfg, pv, ids, pos_base, t_off, state, grid):
        if kind == "unchanged":
            return state
        if kind == "half":  # only the first half of the streams is ingested
            B = ids.shape[0]
            h = B // 2
            sub = {k: (v[:, :h] if isinstance(v, torch.Tensor) else v) for k, v in state.items()}
            real(params, cfg, pv[: pv.shape[0] // B * h], ids[:h], pos_base, t_off, sub, grid[:h])
            state["cum_len"] = sub["cum_len"]
            return state
        if kind == "token":  # one patch of every frame altered where the step reads it
            pv = pv.clone()
            pv.view(ids.shape[0], -1, pv.shape[-1])[:, 0] += 0.5
            return real(params, cfg, pv, ids, pos_base, t_off, state, grid)
        raise ValueError(kind)

    return step


@pytest.mark.parametrize("kind", ["unchanged", "half", "token"])
def test_a_stream_fault_reads_incorrect(tiny_bench, monkeypatch, kind):
    import infinitevl_tpu_torch.streaming as st

    root, bench = tiny_bench
    monkeypatch.setattr(st, "stream_frames_batched", _stream_fault(kind))
    for seed in (3, 4):
        out, _ = run_tiny(root, bench, "stream_tiny.delta", seed=seed)
        assert not out["correct"], (kind, seed, out["checks"])


@pytest.mark.parametrize("kind", ["unchanged", "token"])
def test_a_docqa_fault_reads_incorrect(tiny_bench, monkeypatch, kind):
    import infinitevl_tpu_torch.generation as gen

    root, bench = tiny_bench
    if kind == "unchanged":  # a decode step that leaves the state as it was
        real = gen.decode_step

        def step(params, cfg, token, rope_delta, state):
            from infinitevl_tpu_torch.models.state import clone_state

            logits, _ = real(params, cfg, token, rope_delta, clone_state(state))
            return logits, state

        monkeypatch.setattr(gen, "decode_step", step)
    else:  # the third sampled token altered where it is produced
        real = gen.sample_token
        calls = {"n": 0}

        def sample(logits, *a, **kw):
            calls["n"] += 1
            tok = real(logits, *a, **kw)
            return (tok + 1) % logits.shape[-1] if calls["n"] % 5 == 3 else tok

        monkeypatch.setattr(gen, "sample_token", sample)
    out, _ = run_tiny(root, bench, "docqa_tiny.delta", seed=5)
    assert not out["correct"], (kind, out["checks"])


@pytest.mark.card
@pytest.mark.parametrize("workload", ["stream448_cam16.ivl3b", "stream448_cam16.ivl3b_m2",
                                      "docqa_8k_32k.ivl3b"])
def test_the_control_fails_at_the_cells_size(card, workload):
    """On the card: the program under its limits and the control above one of
    them, at the cell's own size, on three seeds."""
    import calibrate

    cell = resolve(read_json(ROOT / "BENCHMARK.json"), workload)
    rows = list(calibrate.readings(cell, [21, 22, 23], [21, 22, 23], 3.0, card))
    for r in rows:
        over = [k for k in cell.limits if r[k] > cell.limits[k]]
        assert bool(over) == (r["side"] == "control"), json.dumps(r)
