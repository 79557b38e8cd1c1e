"""Whole-leaf optimizer updates and DoRA on sliced leaves, and QLoRA on the
model axis, against the JAX package, on the CPU in fp32: the port's ranks
spawned under gloo (one world of two ranks, what they run in
tests/torch_port_ranks.py), JAX's `run_exp` on its 8-device virtual CPU
mesh, the tiny preset cut to one SWA and one DeltaNet layer, the same
weights and adapters on both sides (JAX's optimizer with inv_freq frozen,
as the port's full finetuning leaves it).

- GaLore (with its projection refresh), APOLLO and Adam-mini on leaves
  sliced over the model axis (1, 2) and over the data axis under fsdp
  (2, 1): two updates on the ranks' slices, gathered, equal the same
  updates of one process on the whole leaves (err_ratio <= 1e-6), and the
  state gathered to the one-process format equals its state;
- `run_exp` on examples/sft_tiny.yaml with `use_optimizer` galore / apollo
  (JAX's own draws carried to the ranks) / adam_mini, DoRA
  (`use_dora`), at (1, 2) under tp and at (2, 1) under fsdp (one row a
  rank), and QLoRA (`quantization_bit: 8`) at (1, 2), against JAX's
  `run_exp` at (1, 2) on the same global batch: both step losses within 1e-4 relative, the trained leaves
  err_ratio <= 1e-4, every rank returning the same tree;
- DoRA's adapter gradients at (1, 2), its column norms summed over the
  model group where the kernel is row-parallel, against `jax.grad` on
  JAX's sharded params (<= 1e-4)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_port_ranks as ranks
from torch_port_helpers import err_ratio, freeze_inv_freq, to_port_config
from torch_port_helpers import jax_compile_cache  # noqa: F401 (autouse)

import infinitevl_tpu.train.lora as jlora
import infinitevl_tpu.train.trainer as jtrainer
from infinitevl_tpu.config import tiny_config
from infinitevl_tpu.hparams import parse_args as jparse
from infinitevl_tpu.models.params import init_text_params
from infinitevl_tpu.parallel.sharding import _path_str, create_mesh, shard_params
from infinitevl_tpu.train.step import sft_loss_fn
from infinitevl_tpu_torch.parallel.launch import spawn_ranks
from infinitevl_tpu_torch.train.optim import make_custom_optimizer
from infinitevl_tpu_torch.train.step import trainable_leaves

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
EXACT = 1e-6
DEADLINE = 300.0
LORA_RANK = 4
OPT = dict(optimizer_rank=2, optimizer_update_gap=2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cut_cfg():
    cfg = tiny_config()
    return dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, num_hidden_layers=ranks.N_LAYERS,
        layer_types=cfg.text.layer_types[:ranks.N_LAYERS]))


def _conf(out, **over):
    import yaml

    conf = yaml.safe_load(open(os.path.join(REPO, "examples", "sft_tiny.yaml")))
    conf.update(dataset_dir=os.path.join(REPO, "data"), logging_steps=1, max_steps=2,
                save_steps=1000, output_dir=str(out))
    conf.update(over)
    return conf


def _zero_inv_freq(real):
    """JAX's Adam-mini maps over the tree's leaves and takes no masked
    node: its inv_freq update is zeroed after it instead (with the clip
    idle on both sides, since JAX's global norm would count inv_freq's
    gradient)."""
    def make_tx(args, steps):
        def zero(updates, state, params=None):
            return jax.tree_util.tree_map_with_path(
                lambda p, u: jnp.zeros_like(u) if getattr(p[-1], "key", None) == "inv_freq"
                else u, updates), state

        return optax.chain(real(args, steps),
                           optax.GradientTransformation(lambda p: optax.EmptyState(), zero))

    return make_tx


TP = dict(model_parallel=2, param_mode="tp")
# the same global batch of two rows as JAX's run at (1, 2)
FSDP = dict(data_parallel=2, model_parallel=1, param_mode="fsdp", per_device_train_batch_size=1)
LORA = dict(finetuning_type="lora", lora_rank=LORA_RANK)
JAX_CASES = {
    # JAX's run_exp on its mesh at (1, 2), the port's cases held against it
    "galore": dict(use_optimizer="galore", **OPT, **TP),
    "apollo": dict(use_optimizer="apollo", **OPT, **TP),
    "adam_mini": dict(use_optimizer="adam_mini", max_grad_norm=1e9, **TP),
    "dora": dict(use_dora=True, **LORA, **TP),
    "qlora": dict(quantization_bit=8, **LORA, **TP),
}
CASES = {
    # name: the JAX case it is held against, the port's overrides, the carried numbers
    "galore_tp": ("galore", {}, "full"),
    "galore_fsdp": ("galore", FSDP, "full"),
    "apollo_tp": ("apollo", {}, "apollo"),
    "apollo_fsdp": ("apollo", FSDP, "apollo"),
    "adam_mini_tp": ("adam_mini", {}, "full"),
    "adam_mini_fsdp": ("adam_mini", FSDP, "full"),
    "dora_tp": ("dora", {}, "dora"),
    "dora_fsdp": ("dora", FSDP, "dora"),
    "qlora_tp": ("qlora", {}, "lora"),
}


# ---------------------------------------------------------------- updates on slices


def _leaves():
    """A few leaves shaped as the model's (q_proj in heads of 16, an MLP
    pair, a norm), every one of them 2-D but the norm, their gradients of
    two steps (the first one past the clip)."""
    rng = np.random.RandomState(0)
    n = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)  # noqa: E731
    leaves = {"layers/0/q_proj/kernel": n(32, 64), "layers/0/mlp/up/kernel": n(32, 48),
              "layers/0/mlp/down/kernel": n(48, 32), "layers/0/input_norm": n(32) + 1}
    grads = [{k: n(*v.shape) * s for k, v in leaves.items()} for s in (30.0, 0.5)]
    return leaves, grads


SLICED = {"galore": dict(rank=4, update_proj_gap=2, min_dim=8), "apollo": dict(rank=4, seed=3),
          "adam_mini": dict(head_dim=16, weight_decay=0.1)}
MESHES = {"tp": ((1, 2), "tp"), "fsdp": ((2, 1), "fsdp")}


def _one_process(name):
    leaves, grads = _leaves()
    tree = {"text": {k: torch.from_numpy(v).requires_grad_(True) for k, v in leaves.items()}}
    tx = make_custom_optimizer(name, 1e-2, **SLICED[name])
    state = tx.init(tree)
    for g in grads:
        tx.update([torch.from_numpy(g[p.split("/", 1)[1]]) for p, _ in trainable_leaves(tree)],
                  state, tree)
    return {p: t.detach().numpy() for p, t in trainable_leaves(tree)}, ranks._np_tree(state)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


# ---------------------------------------------------------------- against JAX


def _apollo_draws(text, rank, windows):
    """JAX's APOLLO projections (train/optim.py's draw: the seed folded with
    the leaf's index among the trainable leaves in JAX's order, inv_freq
    masked out, then with the window), by the port's leaf path."""
    flat = [(_path_str(p), x) for p, x in jax.tree_util.tree_flatten_with_path(
        {"text": text})[0] if _path_str(p).split("/")[-1] != "inv_freq"]
    out = {}
    for idx, (path, x) in enumerate(flat):
        if x.ndim == 2 and min(x.shape) >= 2 * rank:
            out[path] = {}
            for w in range(windows):
                key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), idx), w)
                out[path][w] = np.asarray(jax.random.normal(key, (min(x.shape), rank),
                                                            jnp.float32) / jnp.sqrt(rank))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX's run_exp of each case on its mesh (recording the adapters it
    drew) and DoRA's adapter gradients at (1, 2), then one launch of two
    port ranks for the sliced updates, the gradients and every case."""
    tmp = tmp_path_factory.mktemp("sliced")
    cfg = _cut_cfg()
    text = init_text_params(jax.random.PRNGKey(0), cfg.text, jnp.float32)
    seen, runs = {}, {}
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jtrainer, "_load_or_init_params", lambda args, c, mm, dtype: {
            "text": jax.tree.map(jnp.array, text)})
        real_tx = jtrainer._make_tx
        mp.setattr(jtrainer, "_make_tx", lambda args, steps: (
            _zero_inv_freq if args.finetune.use_optimizer == "adam_mini"
            else freeze_inv_freq)(real_tx)(args, steps))
        real_lora = jlora.init_lora

        def record(*a, **kw):
            out = real_lora(*a, **kw)
            seen.setdefault("lora", {})[bool(kw.get("use_dora"))] = _np(out)
            return out

        mp.setattr(jlora, "init_lora", record)
        mp.setattr(jtrainer, "tiny_config", lambda: cfg)
        for case, over in JAX_CASES.items():
            out = tmp / f"jax_{case}"
            final = jtrainer.run_exp(jparse(_conf(out, **over)))
            runs[case] = {"final": {_path_str(p): np.asarray(x) for p, x in
                                    jax.tree_util.tree_flatten_with_path(final)[0]},
                          "losses": ranks.losses(str(out))}
    finally:
        mp.undo()
    params = {"text": _np(text)}
    carry = {"full": {"params": params},
             "apollo": {"params": params, "apollo_draws": _apollo_draws(
                 text, OPT["optimizer_rank"], 1)},
             "lora": {"params": params, "lora": seen["lora"][False]},
             "dora": {"params": params, "lora": seen["lora"][True]}}

    # DoRA's adapter gradients at (1, 2): adapters with b and m drawn too
    rng = np.random.RandomState(2)
    dora = jax.tree.map(lambda x: (rng.randn(*x.shape) * 0.1 + 1.0 * (x.ndim == 1)).astype(
        np.float32), seen["lora"][True])
    B, T = 2, 24
    ids = rng.randint(0, cfg.text.vocab_size, (B, T)).astype(np.int64)
    pos = np.ascontiguousarray(np.broadcast_to(np.arange(T)[None, None], (3, B, T)))
    labels = np.where(rng.rand(B, T) < 0.8, rng.randint(0, cfg.text.vocab_size, (B, T)), -100)
    sp = shard_params(jax.tree.map(jnp.asarray, {"text": params["text"]}),
                      create_mesh(data=1, model=2), param_mode="tp")
    loss = lambda l, p: sft_loss_fn(jlora.apply_lora(p, l, 16.0, LORA_RANK)["text"], cfg.text,
                                    jnp.asarray(ids), jnp.asarray(labels), jnp.asarray(pos))
    flat = jax.tree_util.tree_flatten_with_path(
        jax.jit(jax.grad(loss))(jax.tree.map(jnp.asarray, dora), sp))[0]
    dora_grads = {_path_str(k): np.asarray(v) for k, v in flat}

    jobs = [{"kind": "sliced_update", "name": name, "kw": kw, "mesh": mesh, "mode": mode,
             "leaves": _leaves()[0], "grads": _leaves()[1]}
            for name, kw in SLICED.items() for mesh, mode in MESHES.values()]
    jobs.append({"kind": "tp_forwards", "mesh": (1, 2), "cfg": to_port_config(cfg),
                 "params": params, "ids": ids, "pos": pos, "labels": labels, "lora": dora,
                 "lora_rank": LORA_RANK, "stateless": False})
    for case, (jcase, over, ref) in CASES.items():
        jobs.append({"kind": "run", "carry": carry[ref],
                     "conf": _conf(tmp / case, **dict(JAX_CASES[jcase], **over))})
    got = spawn_ranks(ranks.jobs, 2, (jobs,), timeout=DEADLINE, threads=1, workdir=str(tmp))
    n = len(SLICED) * len(MESHES)
    return dict(sliced=[r[:n] for r in got], dora=[r[n] for r in got],
                runs=[r[n + 1:] for r in got], jax=runs, dora_grads=dora_grads,
                carry=carry)


@pytest.mark.parametrize("name", list(SLICED))
@pytest.mark.parametrize("axis", list(MESHES))
def test_update_on_slices_equals_the_whole_leaf_update_sliced(world, name, axis):
    """Two updates (a projection refresh and a clipped step among them) on
    the ranks' slices, gathered whole, against one process's on the whole
    leaves: the leaves and the state (the per-coordinate moments gathered,
    the projections and low-rank or block moments held whole on every
    rank) within 1e-6."""
    i = [(n, a) for n in SLICED for a in MESHES].index((name, axis))
    want_leaves, want_state = _one_process(name)
    for r in world["sliced"]:
        res = r[i]
        assert res["leaves"].keys() == want_leaves.keys()
        for k, v in want_leaves.items():
            assert err_ratio(res["leaves"][k], v) <= EXACT, (k, err_ratio(res["leaves"][k], v))
        got_state, ref_state = dict(_flat(res["state"])), dict(_flat(want_state))
        assert got_state.keys() == ref_state.keys()
        for k, v in ref_state.items():
            if isinstance(v, np.ndarray):
                assert got_state[k].shape == v.shape, k
                assert err_ratio(got_state[k], v) <= EXACT, k
            else:
                assert got_state[k] == v, k
    moved = sum(not np.array_equal(v, _leaves()[0][k.split("/", 1)[1]])
                for k, v in want_leaves.items())
    assert moved == len(want_leaves)


def test_dora_gradients_on_the_model_axis_match_jax(world):
    """DoRA's a, b and m gradients with the base sharded at (1, 2): q/k/v
    column-parallel (each rank's columns' norms, m cut to them), o_proj
    row-parallel (the squared partial norms summed over the model group),
    against jax.grad on JAX's sharded params."""
    want = world["dora_grads"]
    for res in world["dora"]:
        got = res["lora_grads"]
        assert got.keys() == want.keys() and any(k.endswith("/m") for k in got)
        errs = {k: err_ratio(v, want[k]) for k, v in got.items()}
        assert max(errs.values()) < TOL, sorted(errs.items(), key=lambda kv: -kv[1])[:3]


@pytest.mark.parametrize("case", list(CASES))
def test_run_exp_on_sliced_leaves_matches_jax(world, case):
    """Each case's run_exp on the ranks, at (1, 2) under tp or at (2, 1)
    under fsdp, against JAX's at (1, 2) with the same global batch."""
    i = list(CASES).index(case)
    got, want = [r[i] for r in world["runs"]], world["jax"][CASES[case][0]]
    r0 = got[0]
    assert len(r0["losses"]) == len(want["losses"]) == 2, (r0["losses"], want["losses"])
    assert max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], want["losses"])) < TOL, (
        r0["losses"], want["losses"])
    assert r0["final"].keys() == want["final"].keys()
    assert all(np.array_equal(r["final"][k], r0["final"][k]) for r in got for k in r0["final"])
    # k_proj's bias: no gradient in exact arithmetic (rounding noise on both sides)
    errs = {k: err_ratio(v, want["final"][k]) for k, v in r0["final"].items()
            if not k.endswith("k_proj/bias")}
    assert max(errs.values()) < TOL, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
