"""`utils/profiling.py` of the port against the JAX package's on the CPU:
the FLOPs / MFU / weight-read estimators on the 3B and tiny configs and on
tied, untied and quantize_embed trees carried across from JAX, StepTimer's
summary and text on injected times, and trace() writing a Chrome trace."""

import dataclasses
import glob
import json
import os

import jax
import numpy as np
import pytest
import torch
from torch_port_helpers import jax_compile_cache  # noqa: F401 (autouse)

import infinitevl_tpu.config as jconfig
import infinitevl_tpu.utils.profiling as jprof
import infinitevl_tpu_torch.config as tconfig
import infinitevl_tpu_torch.utils.profiling as tprof
from infinitevl_tpu.models.params import init_text_params
from infinitevl_tpu.models.quant import quantize_params
from infinitevl_tpu_torch.models.params import from_jax_numpy


@pytest.mark.parametrize("factory", ["infinitevl_3b", "tiny_config"])
def test_flops_mfu_and_floor_match_jax(factory):
    jcfg, tcfg = getattr(jconfig, factory)(), getattr(tconfig, factory)()
    assert tprof.decoder_flops_per_token(tcfg) == jprof.decoder_flops_per_token(jcfg)
    for peak in (197e12, tprof.H100_PEAK_BF16):
        assert tprof.mfu(4294.0, tcfg, peak=peak) == jprof.mfu(4294.0, jcfg, peak=peak)
    assert tprof.mfu(4294.0, tcfg) == jprof.mfu(4294.0, jcfg, peak=989e12)
    for bw in (819e9, tprof.H100_HBM_BW):
        assert tprof.decode_hbm_floor_ms(3_700_000_000, 2, bw) == \
            jprof.decode_hbm_floor_ms(3_700_000_000, 2, bw)
    assert tprof.decode_hbm_floor_ms(3_700_000_000) == \
        jprof.decode_hbm_floor_ms(3_700_000_000, bw=3.35e12)


@pytest.mark.parametrize("case", ["tied_fp32", "tied_bf16", "untied", "quantize_embed",
                                  "quantize_embed_untied"])
def test_decode_weight_read_bytes_matches_jax(case):
    """The same text tree through models/params.from_jax_numpy: the tied
    table counted once, an untied or int8 gather copy left out."""
    jcfg = jconfig.tiny_config()
    if "untied" in case:
        jcfg = dataclasses.replace(
            jcfg, text=dataclasses.replace(jcfg.text, tie_word_embeddings=False))
    dtype = jax.numpy.bfloat16 if case == "tied_bf16" else jax.numpy.float32
    jtext = init_text_params(jax.random.PRNGKey(0), jcfg.text, dtype)
    if case.startswith("quantize_embed"):
        jtext = quantize_params(jtext, min_size=1, quantize_embed=True)
    ttext = from_jax_numpy(jax.tree.map(np.asarray, jtext), "cpu")
    want = jprof.decode_weight_read_bytes(jtext)
    assert tprof.decode_weight_read_bytes(ttext) == want
    untied = "untied" in case
    gather = ("embed_q" if case.startswith("quantize_embed") else "embed")
    if untied or gather == "embed_q":  # the gather-only table is left out
        table = ttext[gather]
        assert want == sum(t.numel() * t.element_size()
                           for _, t in tprof._named_leaves(ttext)) \
            - table.numel() * table.element_size()


def test_step_timer_summary_and_text_match_jax(capsys):
    times = [41.0, 12.5, 13.25, 11.75, 30.0, 12.0]
    j, t = jprof.StepTimer(warmup=1), tprof.StepTimer("cpu", warmup=1)
    j.times_ms, t.times_ms = list(times), list(times)
    assert t.summary() == j.summary()
    j.print_summary("frames")
    want = capsys.readouterr().out
    t.print_summary("frames")
    assert capsys.readouterr().out == want
    with t:  # a timed step on the CPU appends its time
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert len(t.times_ms) == len(times) + 1 and t.times_ms[-1] >= 0.0
    one = tprof.StepTimer("cpu", warmup=1)
    one.times_ms = [5.0]  # fewer steps than the warm-up: all of them
    assert one.summary()["avg_ms"] == 5.0 == jprof.StepTimer.summary(one)["avg_ms"]


def test_step_timer_without_a_device_asks_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tprof.StepTimer()
    with pytest.raises(RuntimeError, match="cal_mfu --measure"):
        tprof.require_card("cal_mfu --measure")


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    logdir = str(tmp_path / "trace")
    with tprof.trace(logdir) as d:
        assert d == logdir
        torch.ones(32, 32) @ torch.ones(32, 32)
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
