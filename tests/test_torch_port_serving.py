"""Speculative, beam and batched decoding of the port against the JAX
package at tiny_config(), on the CPU in fp32, from the same weights
(JAX init_params -> numpy -> from_jax_numpy).

Greedy speculation must equal plain greedy token for token and equal the
JAX package's, with equal SpecStats; sampled speculation draws with numpy
on both sides, so from one seed the streams are identical where the logits
agree (they do to ~1e-6); beam search tokens identical; the in-place state
is never consumed by a verify, a preserved step or a beam reorder; rows of a
BatchingEngine batch equal single requests."""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import to_port_config
from torch_port_helpers import jax_compile_cache  # noqa: F401 (autouse)

import infinitevl_tpu.speculative as jspec
import infinitevl_tpu_torch.speculative as tspec
from infinitevl_tpu.beam import beam_search as j_beam_search
from infinitevl_tpu.config import tiny_config
from infinitevl_tpu.generation import Generator as JGenerator
from infinitevl_tpu.models.params import init_params
from infinitevl_tpu_torch.beam import _Hyps, _reorder_state_impl, beam_search
from infinitevl_tpu_torch.generation import (
    Generator,
    decode_step,
    decode_step_preserve,
    spec_commit,
    spec_verify,
)
from infinitevl_tpu_torch.models.params import from_jax_numpy
from infinitevl_tpu_torch.models.state import clone_state
from infinitevl_tpu_torch.serve.batching import BatchingEngine

torch.set_num_threads(2)

CFG = tiny_config()
TCFG = to_port_config(CFG)


def err_ratio(x, ref):
    x = np.asarray(x, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.abs(x - ref).mean() / (np.abs(ref).mean() + 1e-12)


@pytest.fixture(scope="module")
def gens():
    jp = init_params(jax.random.PRNGKey(0), CFG, jnp.float32)
    tp = from_jax_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return JGenerator(jp, CFG), Generator(tp, TCFG, device="cpu")


def _repetitive(seed, period=6, reps=5):
    base = np.random.RandomState(seed).randint(0, 400, (1, period))
    return np.tile(base, (1, reps))


def _state_equal(a, b):
    return a["cum_len"] == b["cum_len"] and all(
        torch.equal(a[k], b[k]) for k in a if isinstance(a[k], torch.Tensor))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prompt_lookup_draft_matches_jax(seed):
    rng = np.random.RandomState(seed)
    for _ in range(20):
        ctx = rng.randint(0, 6, rng.randint(1, 40))
        k = int(rng.randint(0, 8))
        np.testing.assert_array_equal(tspec.prompt_lookup_draft(ctx, k),
                                      jspec.prompt_lookup_draft(ctx, k))
    periodic = np.tile(np.arange(5), 4)
    np.testing.assert_array_equal(tspec.prompt_lookup_draft(periodic, 7),
                                  jspec.prompt_lookup_draft(periodic, 7))
    assert len(tspec.prompt_lookup_draft(periodic, 7)) == 7


@pytest.mark.parametrize("kw", [dict(temperature=0.7), dict(temperature=1.3, top_k=5),
                                dict(temperature=0.9, top_p=0.8),
                                dict(temperature=0.5, top_k=20, top_p=0.9)])
def test_processed_probs_matches_jax(kw):
    logits = np.random.RandomState(3).standard_normal(200).astype(np.float32) * 3
    got, want = tspec.processed_probs(logits, **kw), jspec.processed_probs(logits, **kw)
    np.testing.assert_array_equal(got, want)
    assert abs(got.sum() - 1.0) < 1e-12


@pytest.mark.parametrize("seed, draft_k", [(0, 4), (1, 8), (2, 2)])
def test_greedy_speculative_equals_greedy_and_jax(gens, seed, draft_k):
    jg, tg = gens
    ids = _repetitive(seed)
    plain = tg.generate(ids, max_new_tokens=20)
    tstats, jstats = tspec.SpecStats(), jspec.SpecStats()
    got = tg.generate_speculative(ids, max_new_tokens=20, draft_k=draft_k, stats=tstats)
    want = jg.generate_speculative(ids, max_new_tokens=20, draft_k=draft_k, stats=jstats)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, want)
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    assert tstats.summary() == jstats.summary()
    assert tstats.emitted == got.shape[1] - 1 and tstats.forwards > 0


def test_speculative_partial_acceptance_keeps_the_state_exact(gens):
    """Drafts from the known continuation with every third spoiled: full,
    partial and empty acceptance all occur, and the output stays greedy's.
    This is the in-place hazard: a verify that consumed the state would
    corrupt every window after a rejection."""
    _, tg = gens
    ids = np.random.RandomState(9).randint(0, 400, (1, 21))
    want = tg.generate(ids, max_new_tokens=24)
    T = ids.shape[1]

    def draft_fn(ctx, k):
        done = len(ctx) - T
        d = np.array(want[0, done:done + k], dtype=np.int64)
        d[[i for i in range(len(d)) if (done + i) % 3 == 2]] += 1
        return d

    stats = tspec.SpecStats()
    got = tspec.generate_speculative(tg, ids, max_new_tokens=24, draft_k=5, stats=stats,
                                     draft_fn=draft_fn)
    np.testing.assert_array_equal(got, want)
    assert stats.commit_steps > 0 and 0 < stats.accepted < stats.drafted
    with pytest.raises(ValueError, match="batch-1"):
        tg.generate_speculative(np.tile(ids, (2, 1)))
    with pytest.raises(ValueError, match="draft_k"):
        tg.generate_speculative(ids, draft_k=1)


def test_spec_verify_and_preserve_leave_the_state_untouched(gens):
    _, tg = gens
    ids = np.random.RandomState(4).randint(0, 400, (1, 20))  # the ring (16) has wrapped
    logits, state, delta = tg.prefill_prompt(ids)
    snap = clone_state(state)
    window = torch.as_tensor(np.random.RandomState(5).randint(0, 400, (1, 4)))
    vlogits, vstate = spec_verify(tg.params, TCFG, window, delta, state)
    assert _state_equal(state, snap) and vstate["cum_len"] == 24
    assert not torch.equal(vstate["delta_h"], state["delta_h"])
    # the window's logits are those of sequential decode steps
    seq = clone_state(state)
    for i in range(4):
        step_logits, seq = decode_step(tg.params, TCFG, window[:, i:i + 1], delta, seq)
        assert err_ratio(vlogits[:, i], step_logits) < 1e-4, i
    for key in ("swa_k", "swa_v", "delta_h", "conv_q", "conv_k", "conv_v"):
        assert err_ratio(vstate[key], seq[key]) < 1e-4, key
    # commit advances the original in place; a commit of the whole window
    # lands where verify did
    clogits, cstate = spec_commit(tg.params, TCFG, window, delta, state)
    assert cstate is state and state["cum_len"] == 24
    assert torch.equal(clogits, vlogits) and _state_equal(state, vstate)
    plogits, pstate = decode_step_preserve(tg.params, TCFG, window[:, :1], delta, snap)
    assert pstate is not snap and snap["cum_len"] == 20 and pstate["cum_len"] == 21
    assert torch.equal(plogits, vlogits[:, 0]) or err_ratio(plogits, vlogits[:, 0]) < 1e-4


@pytest.mark.parametrize("kw", [dict(temperature=0.8, seed=0),
                                dict(temperature=1.0, top_k=8, seed=3),
                                dict(temperature=0.7, top_p=0.9, seed=5)])
def test_sampled_speculative_matches_jax_from_the_same_seed(gens, kw):
    jg, tg = gens
    ids = _repetitive(7)
    tstats, jstats = tspec.SpecStats(), jspec.SpecStats()
    got = tg.generate_speculative_sampled(ids, max_new_tokens=16, draft_k=4, stats=tstats, **kw)
    want = jg.generate_speculative_sampled(ids, max_new_tokens=16, draft_k=4, stats=jstats, **kw)
    np.testing.assert_array_equal(got, want)
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    with pytest.raises(ValueError, match="temperature"):
        tg.generate_speculative_sampled(ids, temperature=0.0)


def test_batched_speculative_rows_equal_greedy_and_jax(gens):
    jg, tg = gens
    ids = np.concatenate([_repetitive(11), _repetitive(12)])
    tstats, jstats = tspec.SpecStats(), jspec.SpecStats()
    got = tspec.generate_speculative_batched(tg, ids, max_new_tokens=12, draft_k=4,
                                             stats=tstats)
    want = jspec.generate_speculative_batched(jg, ids, max_new_tokens=12, draft_k=4,
                                              stats=jstats)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tg.generate(ids, max_new_tokens=12))
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)


@pytest.mark.parametrize("kw", [dict(num_beams=2), dict(num_beams=3, length_penalty=0.5),
                                dict(num_beams=4, early_stopping=True),
                                dict(num_beams=2, early_stopping="never", length_penalty=2.0)])
def test_beam_search_matches_jax(gens, kw):
    jg, tg = gens
    ids = np.random.RandomState(kw["num_beams"]).randint(0, 400, (2, 12))
    want = j_beam_search(jg, ids, max_new_tokens=8, **kw)
    got = beam_search(tg, ids, max_new_tokens=8, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tg.generate_beam(ids, max_new_tokens=8, **kw), got)


def test_beam_eos_pool_and_rejects_single_beam(gens):
    """An eos id the model does emit: hypotheses finish into the pool on
    both sides alike."""
    jg, tg = gens
    ids = np.random.RandomState(6).randint(0, 400, (1, 10))
    eos = int(tg.generate(ids, max_new_tokens=3)[0, 2])
    want = j_beam_search(jg, ids, num_beams=3, max_new_tokens=10, eos_token_id=eos)
    got = beam_search(tg, ids, num_beams=3, max_new_tokens=10, eos_token_id=eos)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="num_beams"):
        beam_search(tg, ids, num_beams=1)
    h = _Hyps(2, 1.0, False, 8)
    h.add(np.array([1, 2]), -2.0, 2)
    h.add(np.array([3]), -0.5, 1)
    h.add(np.array([4, 5, 6]), -9.0, 3)  # worse than both: not kept
    assert len(h.beams) == 2 and h.best().tolist() == [3] and h.is_done(-100.0, 4)


def test_reorder_state_gathers_into_fresh_tensors(gens):
    _, tg = gens
    ids = np.random.RandomState(8).randint(0, 400, (3, 9))
    _, state, _ = tg.prefill_prompt(ids)
    snap = clone_state(state)
    idx = torch.tensor([2, 2, 0])
    new = _reorder_state_impl(state, idx)
    assert _state_equal(state, snap) and new["cum_len"] == state["cum_len"]
    for key, t in snap.items():
        if isinstance(t, torch.Tensor):
            assert torch.equal(new[key], t[:, idx]), key
            assert new[key].data_ptr() != state[key].data_ptr(), key


def test_batching_engine_rows_equal_single_requests(gens):
    """A burst of same-length requests plus one of another length: every
    row equals the single-request output, the odd length gets its own
    batch, and a batch is padded to the ladder by repeating a row."""
    _, tg = gens
    rng = np.random.RandomState(10)
    prompts = [rng.randint(0, 400, (14,)) for _ in range(3)] + [rng.randint(0, 400, (9,))]
    eng = BatchingEngine(tg.params, TCFG, dtype=torch.float32, batch_sizes=(4, 2, 1),
                         max_wait_ms=300.0, device="cpu")
    try:
        with ThreadPoolExecutor(4) as pool:
            outs = list(pool.map(lambda p: eng.generate(p, max_new_tokens=6, eos_token_id=-1,
                                                        timeout=300), prompts))
    finally:
        eng.shutdown()
    for p, o in zip(prompts, outs):
        want = tg.generate(p[None], max_new_tokens=6, eos_token_id=-1)[0].tolist()
        assert o == want
    assert eng.stats["requests"] == 4 and eng.stats["batches"] >= 2
    assert eng.stats["rows"] >= 4
    with pytest.raises(ValueError, match="unknown quant mode"):
        BatchingEngine(tg.params, TCFG, quant="fp8", device="cpu")


def test_batching_engine_quantizes_and_stops_at_eos(gens):
    _, tg = gens
    p = np.random.RandomState(12).randint(0, 400, (11,))
    greedy = tg.generate(p[None], max_new_tokens=8, eos_token_id=-1)[0].tolist()
    eos = greedy[3]
    eng = BatchingEngine(tg.params, TCFG, dtype=torch.float32, batch_sizes=(2, 1),
                         quant="int8", device="cpu")
    try:
        # tiny kernels are under min_size: int8 leaves the tree's values alone
        out = eng.generate(p, max_new_tokens=8, eos_token_id=eos, timeout=300)
    finally:
        eng.shutdown()
    assert out == greedy[:greedy.index(eos)]  # EOS excluded, nothing after it
