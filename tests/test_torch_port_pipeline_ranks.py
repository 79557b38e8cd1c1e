"""Pipeline parallelism over real ranks on the CPU (gloo, spawned with
infinitevl_tpu_torch.parallel.launch.spawn_ranks; the rank bodies are in
tests/torch_port_ranks.py), fp32, the tiny preset (8 layers: 2 pattern
periods, so 2 stages), held against the port's one-process runs:

- the loss and the gradient of every trainable leaf on one global batch
  (packed rows, a few unsupervised positions), as the optimizer takes them
  (summed over the data group), gathered whole over the slices and the
  stages, and the clip's squared global norm (the stages' layers summed
  over the pipe group, the replicated leaves counted once): pipe 2 under
  gpipe, 1f1b and the sequence axis; pipe 2 x model 2 under tp;
  pipe 2 x data 2 x model 2 under fsdp. Loss within 1e-5 relative, every
  gradient within 1e-4 err_ratio, the norm within 1e-5;
- `run_exp` steps (losses within 1e-5 relative, the returned whole
  weights within 1e-4 err_ratio, every rank returning the same tree): pipe
  2 under gpipe, 1f1b and the sequence axis, pipe 2 x model 2 under tp,
  and examples/sft_pp_tiny.yaml as it is (pipe 2 x data 2 x model 2 under
  fsdp, 8 ranks), each against one process at the same global batch;
- a checkpoint written by two stages holds the whole model in the
  one-process layout (the one-process run's keys and moments, within
  1e-4); resumed by the stages it takes the uninterrupted run's second
  step, and one process resumes it too."""

import os
import shutil

import numpy as np
import pytest
import torch
import torch_port_ranks as ranks
from torch_port_helpers import err_ratio

from infinitevl_tpu_torch.config import tiny_config
from infinitevl_tpu_torch.models.params import init_text_params
from infinitevl_tpu_torch.parallel.launch import spawn_ranks
from infinitevl_tpu_torch.train.step import (
    full_finetune_leaf,
    grad_sq_norm,
    set_trainable,
    sft_loss_fn,
    trainable_leaves,
    tree_leaves_with_path,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 1e-5
TOL = 1e-4
DEADLINE = 300.0
# k_proj's bias has no gradient in exact arithmetic (the softmax removes a
# shift of every key's score): its rounding noise is held by neither side
_NO_GRADIENT = ("k_proj/bias",)
CARRY = {"layers": 8}  # the tiny preset whole: 2 pattern periods

GRAD_CASES = {
    # name: ((pipe, data, model), param_mode, schedule, rows, T)
    "gpipe": ((2, 1, 1), "fsdp", "gpipe", 4, 16),
    "1f1b": ((2, 1, 1), "fsdp", "1f1b", 4, 16),
    "sequence": ((2, 1, 1), "fsdp", "seq", 2, 64),  # 2 chunks of 2 windows
    "pipe2_model2_tp": ((2, 1, 2), "tp", "1f1b", 4, 16),
    "pipe2_data2_model2_fsdp": ((2, 2, 2), "fsdp", "gpipe", 4, 16),
}
RUN_CASES = {
    # name: (overrides of sft_pp_tiny.yaml, the one-process reference's, world)
    "gpipe": (dict(data_parallel=1, model_parallel=1), "batch", 2),
    "1f1b": (dict(data_parallel=1, model_parallel=1, pipeline_schedule="1f1b"), "batch", 2),
    "sequence": (dict(data_parallel=1, model_parallel=1, per_device_train_batch_size=2,
                      pp_microbatch_axis="sequence"), "sequence", 2),
    "pipe2_model2_tp": (dict(data_parallel=1, model_parallel=2, param_mode="tp"), "batch", 4),
    "sft_pp_tiny_8_ranks": ({}, "batch", 8),  # the recipe as it is
}


def _conf(out, **over):
    import yaml

    conf = yaml.safe_load(open(os.path.join(REPO, "examples", "sft_pp_tiny.yaml")))
    # per_device 4 at data 1 is the recipe's global batch of 4 rows (2 x data 2)
    conf.update(dataset_dir=os.path.join(REPO, "data"), logging_steps=1, max_steps=2,
                num_train_epochs=2.0, save_steps=1000, output_dir=str(out),
                per_device_train_batch_size=2 if over.get("data_parallel", 2) == 2 else 4)
    conf.update(over)
    return conf


def _batch(B, T, seed=0):
    cfg = tiny_config().text
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, cfg.vocab_size - 8, (B, T))
    labels[:, :3] = -100
    return {"input_ids": rng.randint(0, cfg.vocab_size - 8, (B, T)), "labels": labels,
            "position_ids": np.ascontiguousarray(np.broadcast_to(np.arange(T)[None, None],
                                                                 (3, B, T))),
            # a segment edge off the chunk edges
            "segment_ids": np.where(np.arange(T) < T // 2 + 3, 1, 2)[None].repeat(B, 0)
            .astype(np.int32)}


def _one_process_grads(batch):
    cfg = tiny_config().text
    text = init_text_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    set_trainable({"text": text}, full_finetune_leaf)
    named = trainable_leaves({"text": text})
    args = (torch.as_tensor(batch[k]) for k in ("input_ids", "labels", "position_ids",
                                                 "segment_ids"))
    loss = sft_loss_fn(text, cfg, *args, remat=True)
    grads = torch.autograd.grad(loss, [t for _, t in named])
    return (float(loss.detach()), {p: g.numpy() for (p, _), g in zip(named, grads)},
            float(grad_sq_norm([t for _, t in named], grads)))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """One-process references, then one launch of each world (2, 4 and 8
    ranks), each rank running its world's jobs in order."""
    tmp = tmp_path_factory.mktemp("pp_ranks")
    refs = {
        "batch": ranks.run_job({"carry": CARRY, "conf": _conf(
            tmp / "one_batch", data_parallel=1, model_parallel=1, pipeline_stages=1,
            save_steps=1)}),
        "sequence": ranks.run_job({"carry": CARRY, "conf": _conf(
            tmp / "one_sequence", data_parallel=1, model_parallel=1, pipeline_stages=1,
            per_device_train_batch_size=2)}),
    }
    jobs = {2: [], 4: [], 8: []}
    index = {}
    for case, (mesh, mode, sched, B, T) in GRAD_CASES.items():
        n = int(np.prod(mesh))
        index[("grads", case)] = (n, len(jobs[n]))
        jobs[n].append({"kind": "pp_grads", "mesh": mesh, "mode": mode, "schedule": sched,
                        "M": 2, "batch": _batch(B, T)})
    for case, (over, _, n) in RUN_CASES.items():
        index[("run", case)] = (n, len(jobs[n]))
        jobs[n].append({"kind": "run", "carry": CARRY, "conf": _conf(tmp / case, **over)})
    # the checkpoint round trip: step 1 written by two stages, resumed by two
    one_stage = dict(data_parallel=1, model_parallel=1)
    for name, over in (("ck_save", dict(max_steps=1, save_steps=1)),
                       ("ck_resume", dict(resume_from_checkpoint=str(
                           tmp / "ck_save" / "checkpoints")))):
        index[("run", name)] = (2, len(jobs[2]))
        jobs[2].append({"kind": "run", "carry": CARRY, "conf": _conf(tmp / name, **one_stage,
                                                                     **over)})
    results = {n: spawn_ranks(ranks.jobs, n, (jl,), timeout=DEADLINE, threads=1,
                              workdir=str(tmp)) for n, jl in jobs.items()}
    got = {key: [r[i] for r in results[n]] for key, (n, i) in index.items()}
    return dict(tmp=tmp, refs=refs, got=got)


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_pipelined_gradients_match_one_process(worlds, case):
    mesh, _, _, B, T = GRAD_CASES[case]
    got = worlds["got"][("grads", case)]
    loss, grads, sq = _one_process_grads(_batch(B, T))
    assert all(abs(r["loss"] - loss) <= LOSS_TOL * abs(loss) for r in got), (
        [r["loss"] for r in got], loss)
    assert all(abs(r["grad_sq_norm"] - sq) <= LOSS_TOL * sq for r in got), (
        [r["grad_sq_norm"] for r in got], sq)
    g = got[0]["grads"]
    assert g.keys() == grads.keys()
    errs = {k: err_ratio(v, grads[k]) for k, v in g.items() if not k.endswith(_NO_GRADIENT)}
    assert max(errs.values()) <= TOL, sorted(errs.items(), key=lambda kv: -kv[1])[:3]


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_pipelined_run_exp_matches_one_process(worlds, case):
    got, want = worlds["got"][("run", case)], worlds["refs"][RUN_CASES[case][1]]
    r0 = got[0]
    assert len(r0["losses"]) == len(want["losses"]) == 2, (r0["losses"], want["losses"])
    assert max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], want["losses"])) <= LOSS_TOL, (
        r0["losses"], want["losses"])
    # every rank returns the whole trained tree, the same
    assert r0["final"].keys() == want["final"].keys()
    assert all(np.array_equal(r["final"][k], r0["final"][k]) for r in got for k in r0["final"])
    errs = {k: err_ratio(v, want["final"][k]) for k, v in r0["final"].items()
            if not k.endswith(_NO_GRADIENT)}
    assert max(errs.values()) <= TOL, sorted(errs.items(), key=lambda kv: -kv[1])[:3]


def _named_state(state):
    """A train state's float leaves by name: params by path, each moment by
    its leaf's path (the lists follow the one-process trainable order)."""
    params = dict(tree_leaves_with_path(state["params"]))
    order = [p for p, t in params.items() if t.is_floating_point() and full_finetune_leaf(p)]
    out = {p: t for p, t in params.items() if t.is_floating_point()}
    for key in ("mu", "nu"):
        assert len(state["opt_state"][key]) == len(order)
        out.update({f"{key}:{p}": m for p, m in zip(order, state["opt_state"][key])})
    return out


def test_checkpoint_round_trips_the_whole_model(worlds):
    """Step 1's state written by two stages has the one-process run's
    layout and numbers; two stages resuming it take the uninterrupted run's
    step 2; one process resuming it takes its own step 2."""
    tmp, got = worlds["tmp"], worlds["got"]
    a = torch.load(tmp / "ck_save" / "checkpoints" / "step_1.pt", weights_only=True)
    b = torch.load(tmp / "one_batch" / "checkpoints" / "step_1.pt", weights_only=True)
    la, lb = (_named_state(x["state"]) for x in (a, b))
    assert a["step"] == b["step"] == 1 and la.keys() == lb.keys() and len(la) > 100
    errs = {k: err_ratio(la[k], lb[k]) for k in la if not k.endswith(_NO_GRADIENT)}
    assert max(errs.values()) <= TOL, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    resumed, whole = got[("run", "ck_resume")][0], got[("run", "gpipe")][0]
    assert resumed["losses"] == whole["losses"][1:], (resumed["losses"], whole["losses"])
    assert all(np.array_equal(v, whole["final"][k]) for k, v in resumed["final"].items())
    shutil.copytree(tmp / "ck_save" / "checkpoints", tmp / "one_resume" / "checkpoints")
    one = ranks.run_job({"carry": CARRY, "conf": _conf(
        tmp / "one_resume", data_parallel=1, model_parallel=1, pipeline_stages=1,
        resume_from_checkpoint="auto")})
    want = worlds["refs"]["batch"]["losses"][1:]
    assert len(one["losses"]) == 1 and abs(one["losses"][0] - want[0]) <= LOSS_TOL * want[0]
