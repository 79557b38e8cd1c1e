"""parallel/sharding.py and multi-rank training against the JAX package's
data axis, on the CPU: two ranks under gloo, spawned with
infinitevl_tpu_torch.parallel.launch.spawn_ranks (file:// rendezvous under
tmp_path, a deadline on every launch), the tiny preset cut to one SWA and
one DeltaNet layer, fp32.

(`param_spec` against JAX's, the environment parsing, the mesh's checks and
a failing rank are in test_torch_port_parallel_specs.py.)

- `run_exp` in two ranks (sft: fsdp and replicated, full and LoRA, packed
  rows; dt stage 1 under fsdp) matches JAX's `run_exp` with data_parallel 2
  on the 8-device CPU mesh: every step's loss and the final params within
  1e-4, from the same numbers (weights, adapters and the student's fresh
  mixers carried across);
- rows whose supervised-token counts differ between ranks give the global
  batch's CE, where a per-rank mean would not;
- a train state saved by two ranks resumes in one process and the reverse,
  bit-equal, with the same next loss."""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_port_ranks as ranks
from torch_port_helpers import err_ratio
from torch_port_helpers import jax_compile_cache  # noqa: F401 (autouse)

import infinitevl_tpu.train.lora as jlora
import infinitevl_tpu.train.trainer as jtrainer
from infinitevl_tpu.config import tiny_config
from infinitevl_tpu.hparams import parse_args as jparse
from infinitevl_tpu.models.params import init_params, init_text_params
from infinitevl_tpu.parallel.sharding import _path_str
from infinitevl_tpu.train.step import cross_entropy_loss
from infinitevl_tpu_torch.parallel.launch import spawn_ranks

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
DEADLINE = 300.0


# ---------------------------------------------------------------- param_spec


# ---------------------------------------------------------------- environment


# ---------------------------------------------------------------- two ranks against JAX


def _cut_cfg():
    cfg = tiny_config()
    return dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, num_hidden_layers=ranks.N_LAYERS,
        layer_types=cfg.text.layer_types[:ranks.N_LAYERS]))


def _conf(name, out, **over):
    import yaml

    conf = yaml.safe_load(open(os.path.join(REPO, "examples", name)))
    conf.update(dataset_dir=os.path.join(REPO, "data"), logging_steps=1, max_steps=2,
                save_steps=1000, output_dir=str(out))
    conf.update(over)
    return conf


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _freeze_inv_freq(real):
    """JAX's optimizer with rope's inv_freq frozen, as the port's full
    finetuning leaves it (train/step.full_finetune_leaf); the clip then
    reads the trainable leaves, as the port's."""

    def make_tx(args, steps):
        label = lambda tree: jax.tree_util.tree_map_with_path(
            lambda p, _: "frozen" if getattr(p[-1], "key", None) == "inv_freq" else "train",
            tree)
        return optax.multi_transform({"train": real(args, steps),
                                      "frozen": optax.set_to_zero()}, label)

    return make_tx


CASES = {
    # name: (yaml, overrides, the JAX run it is held against)
    "sft_full_fsdp": ("sft_tiny.yaml", dict(param_mode="fsdp"), "sft_full"),
    "sft_full_replicated": ("sft_tiny.yaml", dict(param_mode="replicated"), "sft_full"),
    # LoRA with a held-out split: its eval loss is the global one on every rank
    "sft_lora_fsdp": ("sft_tiny.yaml", dict(param_mode="fsdp", finetuning_type="lora",
                                            val_size=2), "sft_lora"),
    "sft_lora_replicated": ("sft_tiny.yaml", dict(param_mode="replicated",
                                                  finetuning_type="lora", val_size=2),
                            "sft_lora"),
    "dt1_fsdp": ("dt_stage1_tiny.yaml", dict(param_mode="fsdp", softmax_attention=[0]), "dt1"),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX's three runs with data_parallel 2 on the CPU mesh (recording the
    adapters and the student it drew), then one launch of two port ranks
    running every case, the CE parts and the one-to-two resume."""
    tmp = tmp_path_factory.mktemp("parallel")
    cfg = _cut_cfg()
    params = init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    teacher_cfg = dataclasses.replace(
        cfg.text, layer_types=("full_attention",) * cfg.text.num_hidden_layers)
    teacher = init_text_params(jax.random.PRNGKey(0), teacher_cfg, jnp.float32)
    seen = {}
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jtrainer, "tiny_config", lambda: cfg)
        mp.setattr(jtrainer, "_load_or_init_params", lambda args, c, mm, dtype: {
            "text": jax.tree.map(jnp.array, params["text"])})
        mp.setattr(jtrainer, "init_text_params", lambda key, c, dtype: jax.tree.map(
            jnp.array, teacher))
        mp.setattr(jtrainer, "_make_tx", _freeze_inv_freq(jtrainer._make_tx))
        def record(key, real, conv):
            def call(*a, **kw):
                out = real(*a, **kw)
                seen[key] = conv(out)
                return out

            return call

        mp.setattr(jlora, "init_lora", record("lora", jlora.init_lora, _np))
        mp.setattr(jtrainer, "convert_attention", record(
            "student", jtrainer.convert_attention, lambda out: _np(out[0])))
        jax_runs = {}
        for key, (name, over) in {"sft_full": ("sft_tiny.yaml", {}),
                                  "sft_lora": ("sft_tiny.yaml", {"finetuning_type": "lora",
                                                                 "val_size": 2}),
                                  "dt1": ("dt_stage1_tiny.yaml", {"softmax_attention": [0]})
                                  }.items():
            out = tmp / f"jax_{key}"
            final = jtrainer.run_exp(jparse(_conf(name, out, data_parallel=2, **over)))
            jax_runs[key] = {"final": {_path_str(p): np.asarray(x) for p, x in
                                       jax.tree_util.tree_flatten_with_path(final)[0]},
                             "losses": ranks.losses(str(out)),
                             "eval": ranks.losses(str(out), "eval_loss")}
    finally:
        mp.undo()
    text = {"text": _np(params["text"])}
    carry = {"sft_full": {"params": text},
             "sft_lora": {"params": text, "lora": seen["lora"]},
             "dt1": {"teacher": _np(teacher), "student": seen["student"]}}

    # the one-process run whose state two ranks resume
    one = _conf("sft_tiny.yaml", tmp / "one", per_device_train_batch_size=4, max_steps=1,
                save_steps=1)
    ranks.run_job({"conf": one, "carry": carry["sft_full"]})

    # global batch with rows of 3, 11, 0 (pads only) and 7 supervised tokens
    rng = np.random.RandomState(0)
    logits = rng.randn(4, 16, 32).astype(np.float32)
    labels = np.full((4, 16), -100, np.int64)
    for r, n in enumerate((3, 11, 0, 7)):
        labels[r, :n] = rng.randint(0, 32, n)

    job_list = []
    for case, (name, over, ref) in CASES.items():
        save = dict(save_steps=1) if case == "sft_full_fsdp" else {}
        job_list.append({"conf": _conf(name, tmp / case, data_parallel=2, **over, **save),
                         "carry": carry[ref], "kind": "run"})
    job_list.append({"kind": "ce", "rows": (logits, labels)})
    for steps in (1, 2):  # resume the one-process state: no step, then one step
        job_list.append({"kind": "run", "carry": carry["sft_full"], "conf": _conf(
            "sft_tiny.yaml", tmp / f"resume2_{steps}", data_parallel=2, max_steps=steps,
            resume_from_checkpoint=str(tmp / "one" / "checkpoints"))})
    # a stream over two ranks, against one process at the global batch
    stream = dict(streaming=True, buffer_size=8, packing=False, max_steps=2)
    job_list.append({"kind": "run", "carry": carry["sft_full"], "conf": _conf(
        "sft_tiny.yaml", tmp / "stream2", data_parallel=2, **stream)})
    ranks.run_job({"carry": carry["sft_full"], "conf": _conf(
        "sft_tiny.yaml", tmp / "stream1", per_device_train_batch_size=4, **stream)})
    # `cli train` on a recipe with data_parallel 2, in the two ranks, against
    # one process at the global batch
    import yaml

    for name, over in (("cli2", dict(data_parallel=2)),
                       ("cli1", dict(per_device_train_batch_size=4))):
        with open(tmp / f"{name}.yaml", "w") as f:
            yaml.safe_dump(_conf("sft_tiny.yaml", tmp / name, **over), f)
    job_list.append({"kind": "cli", "path": str(tmp / "cli2.yaml")})
    cli_one = ranks.cli_train(str(tmp / "cli1.yaml"))
    # multimodal rows (images, a video) mixed with text rows over two ranks
    # under fsdp, the ViT sharded too, against one process at the global
    # batch: the port's own weights from the seed on both sides
    mm = dict(dataset="mllm_demo,demo", max_steps=4)
    job_list.append({"kind": "run", "carry": {}, "conf": _conf(
        "mm_sft_tiny.yaml", tmp / "mm2", data_parallel=2, **mm)})
    mm_one = ranks.run_job({"carry": {}, "conf": _conf(
        "mm_sft_tiny.yaml", tmp / "mm1", per_device_train_batch_size=2, **mm)})
    results = spawn_ranks(ranks.jobs, 2, (job_list,), timeout=DEADLINE, threads=2,
                          workdir=str(tmp))
    return dict(tmp=tmp, jax=jax_runs, ranks=results, cases=list(CASES), carry=carry,
                ce=(logits, labels), mm_one=mm_one, cli_one=cli_one)


# k_proj's bias has no gradient in exact arithmetic (adding it to every key
# shifts each query's scores by one constant, which the softmax removes):
# what it gets is rounding noise, which Adam's g / (|g| + eps) turns into
# steps of +-lr either way, so it is held by neither side's numbers
_NO_GRADIENT = ("k_proj/bias",)


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_match_jax_data_parallel(world, case):
    i = world["cases"].index(case)
    r0, r1 = world["ranks"][0][i], world["ranks"][1][i]
    want = world["jax"][CASES[case][2]]
    got = r0["losses"]
    # two steps; one where the held-out rows leave the packed data one global batch
    assert len(got) == len(want["losses"]) == (1 if "val_size" in CASES[case][1] else 2), (
        got, want["losses"])
    assert max(abs(a - b) / abs(b) for a, b in zip(got, want["losses"])) < TOL, (got, want)
    assert len(r0["eval"]) == len(want["eval"]) == (1 if "val_size" in CASES[case][1] else 0)
    assert all(abs(a - b) < TOL * abs(b) for a, b in zip(r0["eval"], want["eval"]))
    assert r0["final"].keys() == want["final"].keys()
    # every rank returns the whole trained tree, the same
    assert all(np.array_equal(r0["final"][k], r1["final"][k]) for k in r0["final"])
    bad = {k: err_ratio(v, want["final"][k]) for k, v in r0["final"].items()
           if not k.endswith(_NO_GRADIENT)}
    assert max(bad.values()) < TOL, sorted(bad.items(), key=lambda kv: -kv[1])[:3]
    start = (world["carry"]["dt1"]["student"] if CASES[case][2] == "dt1"
             else world["carry"]["sft_full"]["params"])
    assert any(not np.array_equal(v, _at(start, k)) for k, v in r0["final"].items())


def _at(tree, path):
    for key in path.split("/"):
        tree = tree[int(key)] if isinstance(tree, (list, tuple)) else tree[key]
    return np.asarray(tree)


def test_unequal_token_counts_give_the_global_loss(world):
    """Rows of 3, 11, 0 and 7 supervised tokens over two ranks: the ranks'
    parts sum to JAX's CE of the whole batch; the mean of per-rank means
    (what dividing by each rank's own count gives) is off."""
    logits, labels = world["ce"]
    i = len(CASES)
    parts = [world["ranks"][r][i] for r in (0, 1)]
    want = float(cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels)))
    assert abs(sum(parts) - want) < 1e-6 * abs(want)
    local = [float(cross_entropy_loss(jnp.asarray(logits[s]), jnp.asarray(labels[s])))
             for s in (slice(0, 2), slice(2, 4))]
    assert abs(np.mean(local) - want) > 1e-2


def _ckpt(path):
    blob = torch.load(path, map_location="cpu", weights_only=True)
    from infinitevl_tpu_torch.train.step import tree_leaves_with_path

    return blob["step"], dict(tree_leaves_with_path(blob["state"])), blob["state"]["opt_state"]


def _bit_equal(a, b):
    (sa, la, oa), (sb, lb, ob) = _ckpt(a), _ckpt(b)
    assert sa == sb and la.keys() == lb.keys() and len(la) > 10
    assert [k for k in la if not torch.equal(la[k], lb[k])] == []
    assert oa["count"] == ob["count"]


@pytest.mark.parametrize("direction", ["two_to_one", "one_to_two"])
def test_checkpoints_cross_world_sizes(world, direction):
    """A train state saved by two ranks (gathered, written by rank 0)
    resumes in one process, and one saved by one process in two ranks:
    resumed with no step left, the state saved again is bit-equal to the
    one read; resumed for one more step, its loss is the straight run's."""
    tmp = world["tmp"]
    straight = world["ranks"][0][world["cases"].index("sft_full_fsdp")]["losses"]
    if direction == "one_to_two":
        first = len(CASES) + 1
        _bit_equal(tmp / "one" / "checkpoints" / "step_1.pt",
                   tmp / "resume2_1" / "checkpoints" / "step_1.pt")
        assert world["ranks"][0][first]["losses"] == []
        nxt = world["ranks"][0][first + 1]["losses"]
    else:
        saved = tmp / "from2"
        saved.mkdir()
        shutil.copy(tmp / "sft_full_fsdp" / "checkpoints" / "step_1.pt", saved / "step_1.pt")
        carry = world["carry"]["sft_full"]
        for steps in (1, 2):
            ranks.run_job({"carry": carry, "conf": _conf(
                "sft_tiny.yaml", tmp / f"resume1_{steps}", per_device_train_batch_size=4,
                max_steps=steps, resume_from_checkpoint=str(saved))})
        _bit_equal(saved / "step_1.pt", tmp / "resume1_1" / "checkpoints" / "step_1.pt")
        nxt = ranks.losses(str(tmp / "resume1_2"))
    assert len(nxt) == 1 and abs(nxt[0] - straight[1]) < 1e-5 * abs(straight[1]), (nxt, straight)


def test_cli_train_over_two_ranks(world):
    """`cli train` in a world of two ranks (the group joined before it, as
    torchrun's processes join theirs) trains data_parallel 2: the losses of
    one process at the same global batch, within 1e-5."""
    got, want = world["ranks"][0][-2], world["cli_one"]
    assert len(got) == len(want) == 2
    assert max(abs(a - b) / abs(b) for a, b in zip(got, want)) < 1e-5, (got, want)


def test_multimodal_rows_over_two_ranks(world):
    """mm_sft_tiny.yaml on image, video and text rows over two ranks (fsdp,
    the ViT sharded; every rank runs the ViT on the global batch's pixels
    and keeps its rows' features, none where its rows hold no media) takes
    the steps of one process at the same global batch: losses within 1e-5,
    the weights within 1e-4 but those that were zero before the steps (the
    biases: Adam's first step is g / |g| there, rounding noise where the
    gradient vanishes)."""
    from infinitevl_tpu_torch.hparams import parse_args
    from infinitevl_tpu_torch.models.params import init_params as tinit

    two, one = world["ranks"][0][-1], world["mm_one"]
    assert len(two["losses"]) == len(one["losses"]) == 4
    assert max(abs(a - b) / abs(b) for a, b in zip(two["losses"], one["losses"])) < 1e-5
    assert two["final"].keys() == one["final"].keys()
    assert any(k.startswith("visual/") for k in two["final"])
    seed = parse_args(_conf("mm_sft_tiny.yaml", world["tmp"])).train.seed
    start = ranks.leaves_np(tinit(ranks.tiny_cut(), torch.Generator().manual_seed(seed), "cpu",
                                  torch.float32))
    errs = {k: err_ratio(v, one["final"][k]) for k, v in two["final"].items()
            if np.abs(start[k]).sum() > 0}
    assert len(errs) > 30 and max(errs.values()) < TOL, sorted(
        errs.items(), key=lambda kv: -kv[1])[:3]


def test_streaming_composes_with_data_parallel(world):
    """streaming: true over two ranks takes the steps of one process at the
    same global batch (the reservoir and the rows are every rank's; each
    trains its half)."""
    got = world["ranks"][0][-3]["losses"]
    want = ranks.losses(str(world["tmp"] / "stream1"))
    assert len(got) == len(want) == 2  # the stream's 8 rows make two global batches
    assert max(abs(a - b) / abs(b) for a, b in zip(got, want)) < 1e-5, (got, want)


