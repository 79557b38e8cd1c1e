"""The training slice's recipes and loss curves against the JAX package on the
CPU in fp32: every example yaml parses to the JAX package's groups, and
`Trainer` loss curves from JAX-initialised weights carried across stay
within 1e-4 of JAX's steps (packed text rows; image and video batches)."""

import os

import jax
import jax.numpy as jnp
import pytest
import torch
from test_torch_port_trainer import YAMLS, _args
from torch_port_helpers import carry_train_state
from torch_port_helpers import jax_compile_cache  # noqa: F401 (autouse)

import infinitevl_tpu.hparams as jhparams
import infinitevl_tpu.train.step as jstep
import infinitevl_tpu.train.trainer as jtrainer
import infinitevl_tpu_torch.hparams as thparams
import infinitevl_tpu_torch.train.step as tstep
import infinitevl_tpu_torch.train.trainer as ttrainer
from infinitevl_tpu.models.params import init_params
from infinitevl_tpu_torch.utils.checkpoint import latest_step

torch.set_num_threads(2)


@pytest.mark.parametrize("path", YAMLS, ids=[os.path.basename(p) for p in YAMLS])
def test_every_example_yaml_parses_as_in_jax(path):
    import dataclasses

    want, got = jhparams.load_yaml_args(path), thparams.load_yaml_args(path)
    for group in ("model", "data", "train", "finetune", "gen", "eval"):
        assert dataclasses.asdict(getattr(got, group)) == dataclasses.asdict(
            getattr(want, group)), group
    with pytest.raises(ValueError, match="unknown config keys"):
        thparams.parse_args({"no_such_key": 1})


def _jax_losses(args, cfg, data, params, mm, n_steps):
    tx = jtrainer._make_tx(args, n_steps)
    state = tx.init(params)
    if mm:
        step = jax.jit(jstep.make_mm_sft_train_step(cfg, tx), static_argnums=(3, 4))
    else:
        step = jax.jit(jstep.make_sft_train_step(cfg.text, tx))
    losses = []
    for item in jtrainer._batches(args, data, cfg, mm):
        if len(losses) == n_steps:
            break
        batch, rest = (item[0], item[1:]) if isinstance(item, tuple) else (item, ())
        batch.pop("_n_tokens")
        params, state, loss = step(params, state, batch, *rest)
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize("name,n_steps", [("sft_tiny.yaml", 8), ("mm_sft_tiny.yaml", 4)])
def test_trainer_loss_curve_matches_jax(tmp_path, name, n_steps):
    """`Trainer` + step over the batches the port's own pipeline makes,
    from JAX-initialised weights carried across: every step's loss within
    1e-4 of the JAX step's (packed text rows; image and video batches)."""
    ja = _args(jhparams, name, num_train_epochs=8.0, max_steps=n_steps)
    ta = _args(thparams, name, tmp_path, num_train_epochs=8.0, max_steps=n_steps,
               logging_steps=1)
    jcfg = jtrainer.build_config(ja)
    tcfg = ttrainer.build_config(ta)
    jdata = jtrainer.build_dataset(ja, cfg=jcfg)
    tdata = ttrainer.build_dataset(ta, cfg=tcfg)
    mm = ttrainer.is_multimodal(tdata)
    jp = init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    if not mm:
        jp = {"text": jp["text"]}
    want = _jax_losses(ja, jcfg, jdata, jp, mm, n_steps)
    tp, _ = carry_train_state(jp)
    tx = ttrainer._make_tx(ta, n_steps)
    step = (tstep.make_mm_sft_train_step(tcfg, tx) if mm
            else tstep.make_sft_train_step(tcfg.text, tx))
    trainer = ttrainer.Trainer(step, tp, tx.init(tp), str(tmp_path), logging_steps=1,
                               save_steps=1000)
    trainer.train(ttrainer._batches(ta, tdata, tcfg, mm), max_steps=n_steps)
    got = [r["loss"] for r in trainer.log.records if "loss" in r]
    assert len(got) == len(want) == n_steps
    assert max(abs(a - b) / b for a, b in zip(got, want)) < 1e-4, (got, want)
    assert all(r["tokens_per_sec"] > 0 for r in trainer.log.records if "loss" in r)
    assert latest_step(os.path.join(str(tmp_path), "checkpoints")) == n_steps
