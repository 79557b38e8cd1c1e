"""The preference losses, datasets and refusals against the JAX package on
the CPU: the dpo (sigmoid, ipo, simpo, orpo), kto and pairwise reward
losses on numpy log-probs, the preference encoders and collators equal to
JAX's arrays, and the options the preference stages refuse by name."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_pref import _args
from torch_port_helpers import jax_compile_cache  # noqa: F401 (autouse)

import infinitevl_tpu.hparams as jhparams
import infinitevl_tpu.train.dpo as jdpo
import infinitevl_tpu.train.trainer as jtrainer
import infinitevl_tpu_torch.hparams as thparams
import infinitevl_tpu_torch.train.dpo as tdpo
import infinitevl_tpu_torch.train.trainer as ttrainer

torch.set_num_threads(2)


def _logps(seed, n=6):
    rng = np.random.RandomState(seed)
    return [(-rng.uniform(1.0, 40.0, n)).astype(np.float32) for _ in range(4)]



@pytest.mark.parametrize("loss_type,smoothing", [
    ("sigmoid", 0.0), ("sigmoid", 0.2), ("ipo", 0.0), ("simpo", 0.0), ("orpo", 0.0)])
def test_dpo_loss_matches_jax(loss_type, smoothing):
    pc, pr, rc, rr = _logps(0)
    pc[0] = -1e-8  # ORPO clamps log-probs near 0 before log1p(-exp)
    want = jdpo.dpo_loss(*(jnp.asarray(a) for a in (pc, pr, rc, rr)), beta=0.3,
                         loss_type=loss_type, label_smoothing=smoothing, simpo_gamma=0.7)
    got = tdpo.dpo_loss(*(torch.from_numpy(a) for a in (pc, pr, rc, rr)), beta=0.3,
                        loss_type=loss_type, label_smoothing=smoothing, simpo_gamma=0.7)
    assert abs(float(got) - float(want)) <= 1e-6 * max(abs(float(want)), 1.0)
    if tdpo.needs_reference(loss_type):
        with pytest.raises(ValueError, match="reference"):
            tdpo.dpo_loss(torch.from_numpy(pc), torch.from_numpy(pr), None, None,
                          loss_type=loss_type)


def test_kto_and_rm_losses_match_jax():
    lp, ref, _, _ = _logps(1)
    desirable = np.array([True, False, True, True, False, False])
    for kl in (0.0, 0.37):
        want = jdpo.kto_loss(jnp.asarray(lp), jnp.asarray(ref), jnp.asarray(desirable),
                             jnp.float32(kl), beta=0.2, desirable_weight=1.3,
                             undesirable_weight=0.8)
        got = tdpo.kto_loss(torch.from_numpy(lp), torch.from_numpy(ref),
                            torch.from_numpy(desirable), torch.tensor(kl), beta=0.2,
                            desirable_weight=1.3, undesirable_weight=0.8)
        assert abs(float(got) - float(want)) <= 1e-6
    rc, rr = np.random.RandomState(2).standard_normal((2, 6)).astype(np.float32) * 3
    want = jdpo.rm_pairwise_loss(jnp.asarray(rc), jnp.asarray(rr))
    got = tdpo.rm_pairwise_loss(torch.from_numpy(rc), torch.from_numpy(rr))
    assert abs(float(got) - float(want)) <= 1e-6


@pytest.mark.parametrize("name,kind", [("dpo_tiny.yaml", "pairwise"), ("kto_tiny.yaml", "kto")])
def test_preference_dataset_and_collators_equal_jax(name, kind):
    ja, ta = _args(jhparams, name), _args(thparams, name)
    jd = jtrainer.build_preference_dataset(ja, kind=kind)
    td = ttrainer.build_preference_dataset(ta, kind=kind)
    assert len(jd) == len(td) == 4
    for a, b in zip(jd, td):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    jcol = jtrainer.collate_pairwise if kind == "pairwise" else jtrainer.collate_kto
    tcol = ttrainer.collate_pairwise if kind == "pairwise" else ttrainer.collate_kto
    n = 0
    for jb, tb in zip(jcol(jd, 3, 20, seed=3, epochs=2.5), tcol(td, 3, 20, seed=3, epochs=2.5)):
        assert set(jb) == set(tb)
        for k in jb:
            a, b = np.asarray(jb[k]), np.asarray(tb[k])
            assert a.shape == b.shape and a.dtype.kind == b.dtype.kind, k
            np.testing.assert_array_equal(a, b, err_msg=k)
        n += 1
    assert n == 4  # ceil(2.5 x 4 / 3)
    with pytest.raises(ValueError, match="chosen" if kind == "kto" else "kto_tag"):
        other = "pairwise" if kind == "kto" else "kto"
        ttrainer.build_preference_dataset(ta, kind=other)


@pytest.mark.parametrize("over,match", [
    # JAX's rm, dpo and kto train the whole tree whatever finetuning_type and
    # use_dora say, and so does the port now that DoRA exists: the option runs
    (dict(use_dora=True, finetuning_type="lora", max_steps=1), None),
    # JAX's preference stages train in one process whatever data_parallel
    # says, and so does the port now that parallel/ exists: the option runs
    (dict(data_parallel=2, max_steps=1), None),
    # ported since (train/optim.py): the case now holds that the option runs
    (dict(use_optimizer="galore", max_steps=1), None),
], ids=["use_dora", "data_parallel", "use_optimizer"])
def test_preference_stages_refuse_later_options(tmp_path, over, match):
    """rm, dpo and kto refuse the options of later slices by name; an option
    a slice has ported since (match None) runs one step with a finite loss."""
    for name in ("rm_tiny.yaml", "dpo_tiny.yaml", "kto_tiny.yaml"):
        args = _args(thparams, name, tmp_path / name, **over)
        if match is None:
            ttrainer.run_exp(args, device="cpu")
            recs = [json.loads(line) for line in open(tmp_path / name / "trainer_log.jsonl")]
            assert [np.isfinite(r["loss"]) for r in recs if "loss" in r] == [True], name
            continue
        with pytest.raises(NotImplementedError, match=match):
            ttrainer.run_exp(args, device="cpu")
