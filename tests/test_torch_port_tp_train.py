"""Training under tensor parallelism (the model axis of
parallel/sharding.py, composed with the data axis) against the JAX
package's `run_exp` on the same mesh, on the CPU in fp32: the port's ranks
spawned under gloo (tests/torch_port_ranks.py), JAX's on its 8-device
virtual CPU mesh, the tiny preset cut to one SWA and one DeltaNet layer,
the same weights, adapters and fresh student mixers on both sides (JAX's
optimizer with inv_freq frozen, as the port's full finetuning leaves it).

- `run_exp` at (data, model) = (1, 2) under tp: sft LoRA (the case in
  which a replicated factor's gradient, summed over the model group or
  not, would be 2x or 1/2 of JAX's) and dt stage 1; at (2, 2) sft full
  finetuning under fsdp (both axes). Every step's loss within 1e-4
  relative of JAX's, the final leaves err_ratio <= 1e-4, every rank
  returning the same whole tree;
- full finetuning at (1, 2) through the sequence-chunked layers (the chunk
  knobs of tests/test_torch_port_longctx.py, which holds the one-process
  chunked steps against JAX's: cutoff 64 > delta_seq_chunk_t 32) against
  the same run in one process, within the same bounds;
- a one-process train state resumed at (1, 2) takes each rank's slices
  and, saved again (gathered over both axes), is bit-equal;
- `cli train` on a recipe with model_parallel 2, in a world of two ranks,
  takes the steps of one process within 1e-5;
- DoRA on a column-parallel slice gives the one-process output's columns,
  a world that is not data x model raises, and create_mesh builds a model
  axis."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_ranks as ranks
from torch_port_helpers import err_ratio, freeze_inv_freq
from torch_port_helpers import jax_compile_cache  # noqa: F401 (autouse)

import infinitevl_tpu.train.lora as jlora
import infinitevl_tpu.train.trainer as jtrainer
import infinitevl_tpu_torch.parallel.sharding as tsh
from infinitevl_tpu.config import tiny_config
from infinitevl_tpu.hparams import parse_args as jparse
from infinitevl_tpu.models.params import init_text_params
from infinitevl_tpu.parallel.sharding import _path_str
from infinitevl_tpu_torch.parallel.launch import spawn_ranks

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
DEADLINE = 300.0


def _cut_cfg(chunked=False):
    cfg = tiny_config()
    return dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, num_hidden_layers=ranks.N_LAYERS,
        layer_types=cfg.text.layer_types[:ranks.N_LAYERS],
        **(ranks.CHUNKED if chunked else {})))


def _conf(name, out, **over):
    import yaml

    conf = yaml.safe_load(open(os.path.join(REPO, "examples", name)))
    conf.update(dataset_dir=os.path.join(REPO, "data"), logging_steps=1, max_steps=2,
                save_steps=1000, output_dir=str(out))
    conf.update(over)
    return conf


def _np(tree):
    return jax.tree.map(np.asarray, tree)


TP = dict(model_parallel=2, param_mode="tp")
CASES = {
    # name: (yaml, overrides on both sides, the carried numbers, world size);
    # the chunked case is held against one process, the others against JAX
    "sft_full_chunked_tp": ("sft_tiny.yaml", TP, "chunked", 2),
    "sft_lora_tp": ("sft_tiny.yaml", dict(finetuning_type="lora", **TP), "lora", 2),
    "dt1_tp": ("dt_stage1_tiny.yaml", dict(softmax_attention=[0], **TP), "dt1", 2),
    "sft_full_fsdp_2x2": ("sft_tiny.yaml", dict(data_parallel=2, model_parallel=2,
                                                param_mode="fsdp"), "full", 4),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX's run_exp of each case on its mesh (recording the adapters and the
    student it drew), then one launch of two port ranks (the (1, 2) cases
    and a resume) and one of four (the (2, 2) case)."""
    tmp = tmp_path_factory.mktemp("tp_train")
    cfg = _cut_cfg()
    text = init_text_params(jax.random.PRNGKey(0), cfg.text, jnp.float32)
    teacher_cfg = dataclasses.replace(
        cfg.text, layer_types=("full_attention",) * cfg.text.num_hidden_layers)
    teacher = init_text_params(jax.random.PRNGKey(0), teacher_cfg, jnp.float32)
    seen, jax_runs = {}, {}
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jtrainer, "_load_or_init_params", lambda args, c, mm, dtype: {
            "text": jax.tree.map(jnp.array, text)})
        mp.setattr(jtrainer, "init_text_params", lambda key, c, dtype: jax.tree.map(
            jnp.array, teacher))
        mp.setattr(jtrainer, "_make_tx", freeze_inv_freq(jtrainer._make_tx))

        def record(key, real, conv):
            def call(*a, **kw):
                out = real(*a, **kw)
                seen[key] = conv(out)
                return out

            return call

        mp.setattr(jlora, "init_lora", record("lora", jlora.init_lora, _np))
        mp.setattr(jtrainer, "convert_attention", record(
            "student", jtrainer.convert_attention, lambda out: _np(out[0])))
        mp.setattr(jtrainer, "tiny_config", lambda: cfg)
        for case, (name, over, ref, _) in CASES.items():
            if ref == "chunked":
                continue
            out = tmp / f"jax_{case}"
            final = jtrainer.run_exp(jparse(_conf(name, out, **over)))
            jax_runs[case] = {"final": {_path_str(p): np.asarray(x) for p, x in
                                        jax.tree_util.tree_flatten_with_path(final)[0]},
                              "losses": ranks.losses(str(out))}
    finally:
        mp.undo()
    params = {"text": _np(text)}
    carry = {"full": {"params": params}, "chunked": {"params": params, "chunked": True},
             "lora": {"params": params, "lora": seen["lora"]},
             "dt1": {"teacher": _np(teacher), "student": seen["student"]}}
    name, over, ref, _ = CASES["sft_full_chunked_tp"]
    jax_runs["sft_full_chunked_tp"] = ranks.run_job({"carry": carry[ref], "conf": _conf(
        name, tmp / "one_chunked", **dict(over, model_parallel=1))})
    # a one-process train state for the ranks to resume
    ranks.run_job({"conf": _conf("sft_tiny.yaml", tmp / "one", max_steps=1, save_steps=1),
                   "carry": carry["full"]})
    jobs = {2: [], 4: []}
    for case, (name, over, ref, n) in CASES.items():
        jobs[n].append({"kind": "run", "carry": carry[ref],
                        "conf": _conf(name, tmp / case, **over)})
    jobs[2].append({"kind": "run", "carry": carry["full"], "conf": _conf(
        "sft_tiny.yaml", tmp / "resume", max_steps=1, **TP,
        resume_from_checkpoint=str(tmp / "one" / "checkpoints"))})
    # `cli train` with model_parallel 2 in the two ranks, against one process
    import yaml

    for name, over in (("cli2", TP), ("cli1", {})):
        with open(tmp / f"{name}.yaml", "w") as f:
            yaml.safe_dump(_conf("sft_tiny.yaml", tmp / name, **over), f)
    jobs[2].append({"kind": "cli", "path": str(tmp / "cli2.yaml")})
    cli_one = ranks.cli_train(str(tmp / "cli1.yaml"))
    results = {n: spawn_ranks(ranks.jobs, n, (jl,), timeout=DEADLINE, threads=1,
                              workdir=str(tmp)) for n, jl in jobs.items()}
    got = {}
    for case, (_, _, _, n) in CASES.items():
        i = [c for c, v in CASES.items() if v[3] == n].index(case)
        got[case] = [r[i] for r in results[n]]
    return dict(tmp=tmp, jax=jax_runs, got=got, carry=carry, cli=(results[2][0][-1], cli_one))


# k_proj's bias has no gradient in exact arithmetic (the softmax removes a
# shift of every key's score): what it gets is rounding noise, which Adam
# turns into steps of +-lr either way, so neither side's numbers hold it
_NO_GRADIENT = ("k_proj/bias",)


@pytest.mark.parametrize("case", list(CASES))
def test_run_exp_under_tensor_parallelism_matches_jax(world, case):
    got, want = world["got"][case], world["jax"][case]
    r0 = got[0]
    assert len(r0["losses"]) == len(want["losses"]) == 2, (r0["losses"], want["losses"])
    assert max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], want["losses"])) < TOL, (
        r0["losses"], want["losses"])
    assert r0["final"].keys() == want["final"].keys()
    # every rank returns the whole trained tree, the same
    assert all(np.array_equal(r["final"][k], r0["final"][k]) for r in got for k in r0["final"])
    errs = {k: err_ratio(v, want["final"][k]) for k, v in r0["final"].items()
            if not k.endswith(_NO_GRADIENT)}
    assert max(errs.values()) < TOL, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    carry = world["carry"][CASES[case][2]]
    start = carry["student"] if "student" in carry else carry["params"]
    moved = [k for k, v in r0["final"].items() if not np.array_equal(v, _at(start, k))]
    assert moved, "no leaf trained"
    if CASES[case][2] == "chunked":  # the sequence-chunked DeltaNet layer ran, in chunks
        assert r0["delta_chunks"] >= 2


def _at(tree, path):
    for key in path.split("/"):
        tree = tree[int(key)] if isinstance(tree, (list, tuple)) else tree[key]
    return np.asarray(tree)


def test_one_process_state_resumes_in_slices_and_saves_whole(world):
    """The one-process state of step 1, resumed at (1, 2) with no step left:
    each rank copies its slices in (load_into, load_opt_state) and the state
    saved again, gathered over both axes by every rank and written by rank
    0, is bit-equal to the one read."""
    tmp = world["tmp"]
    a = torch.load(tmp / "one" / "checkpoints" / "step_1.pt", weights_only=True)
    b = torch.load(tmp / "resume" / "checkpoints" / "step_1.pt", weights_only=True)
    from infinitevl_tpu_torch.train.step import tree_leaves_with_path

    la, lb = dict(tree_leaves_with_path(a["state"])), dict(tree_leaves_with_path(b["state"]))
    assert a["step"] == b["step"] == 1 and la.keys() == lb.keys() and len(la) > 20
    assert [k for k in la if not torch.equal(la[k], lb[k])] == []


def test_dora_and_a_wrong_world_raise_and_create_mesh_takes_a_model_axis(tmp_path):
    """DoRA on a column-parallel slice of its kernel computes, in the layer,
    the one-process output's columns (its norms local, m cut to them; the
    row-parallel sum over real ranks is in
    tests/test_torch_port_sliced_updates.py); a world that is not data x
    model raises; create_mesh builds a model axis."""
    import infinitevl_tpu_torch.train.trainer as ttrainer
    from infinitevl_tpu_torch.hparams import parse_args
    from infinitevl_tpu_torch.models.text import _dense
    from infinitevl_tpu_torch.train.lora import attach_lora, init_lora

    gen = torch.Generator().manual_seed(0)
    w = torch.randn(8, 16, generator=gen)
    ad = init_lora({"q_proj": {"kernel": w}}, gen, rank=2, use_dora=True)
    with torch.no_grad():
        ad["q_proj"]["b"].normal_(generator=gen)
    x = torch.randn(3, 8, generator=gen)
    one = _dense(x, attach_lora({"q_proj": {"kernel": w}}, ad, 16.0, 2)["q_proj"])
    for r in range(2):
        part = w[:, r * 8 : (r + 1) * 8].clone()
        part._ivl_tp = tsh.ShardInfo(1, 16, 2, r, "model")
        node = attach_lora({"q_proj": {"kernel": part}}, ad, 16.0, 2)["q_proj"]
        assert "dora_m" in node
        with torch.no_grad():  # the column-parallel forward runs no collective
            got = _dense(x, node)
        assert torch.allclose(got, one[:, r * 8 : (r + 1) * 8], rtol=1e-6, atol=1e-6)
    # one process asked for model_parallel 2: the world must hold data x model ranks
    with pytest.raises(ValueError, match="data_parallel x model_parallel is 1 x 2"):
        ttrainer.run_exp(parse_args(_conf("sft_tiny.yaml", tmp_path, **TP)), device="cpu")
    assert tsh.create_mesh(1, 1) == tsh.Mesh(1, 1, 0)


def test_cli_train_with_a_model_axis(world):
    """`cli train` on a recipe with model_parallel 2 in a world of two ranks
    (the group joined first, as torchrun's processes join theirs) takes the
    steps of one process: losses within 1e-5."""
    got, want = world["cli"]
    assert len(got) == len(want) == 2
    assert max(abs(a - b) / abs(b) for a, b in zip(got, want)) < 1e-5, (got, want)
