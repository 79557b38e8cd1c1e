"""The Mamba2 conversion mixer on the model axis (tensor parallelism of
parallel/sharding.py) against the JAX package on its 8-device virtual CPU
mesh, in fp32: the port's ranks spawned under gloo (one world of two ranks,
what they run in tests/torch_port_ranks.py), the same numpy weights on both
sides.

- `param_spec` gives JAX's axis per dim for every leaf of a converted
  student, and `shard_params` cuts each leaf to the local shape that spec
  gives (in process);
- the decoder state's Mamba2 keys: JAX holds them whole; a rank of the
  port holds its heads of `mamba_h` and its three blocks of `mamba_conv`'s
  [v | k | q] channels, and `shard_state` / `gather_state` round-trip;
- a student (one SWA layer, one Mamba2 layer, its mixer's leaves drawn from
  a seed so that every channel differs) at (data, model) = (1, 2): the
  stateless forward against JAX's jitted forward on `shard_params(...,
  "tp")` (err_ratio <= 1e-5), every leaf's gradient of the SFT loss (run_sft
  on a student) against `jax.grad` (<= 1e-4), the cached prefill and greedy
  decode steps (logits <= 1e-4, tokens equal, the state gathered whole
  <= 1e-5 of JAX's, each rank holding exactly half of both keys);
- `run_exp` with `stage: dt`, `mixer: mamba2` (stage 1 as
  examples/dt_stage1_mamba2_tiny.yaml, and stage 2) at (1, 2) against
  JAX's on the same mesh: step losses within 1e-4 relative, the trained
  leaves err_ratio <= 1e-4, every rank returning the same tree."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_ranks as ranks
from torch_port_helpers import err_ratio, freeze_inv_freq, to_port_config
from torch_port_helpers import jax_compile_cache  # noqa: F401 (autouse)

import infinitevl_tpu.train.trainer as jtrainer
import infinitevl_tpu_torch.parallel.sharding as tsh
from infinitevl_tpu.config import tiny_config
from infinitevl_tpu.hparams import parse_args as jparse
from infinitevl_tpu.models.convert import convert_attention
from infinitevl_tpu.models.infinitevl import forward as jforward
from infinitevl_tpu.models.params import init_text_params
from infinitevl_tpu.models.state import init_decoder_state as jinit_state
from infinitevl_tpu.models.text import embed_tokens, lm_head, text_forward
from infinitevl_tpu.parallel.sharding import (
    _path_str,
    create_mesh,
    param_spec,
    shard_params,
    shard_state,
)
from infinitevl_tpu.train.step import sft_loss_fn
from infinitevl_tpu_torch.models.params import from_jax_numpy
from infinitevl_tpu_torch.parallel.launch import spawn_ranks
from infinitevl_tpu_torch.train.step import tree_leaves_with_path

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
MODEL_TOL = 1e-4
DEADLINE = 300.0
DECODE_STEPS = 4
MIXER_LEAVES = ("conv_w", "conv_b", "dt_proj", "D", "o_norm", "A_log", "dt_bias", "g_proj")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cut_cfg():
    cfg = tiny_config()
    return dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, num_hidden_layers=ranks.N_LAYERS,
        layer_types=cfg.text.layer_types[:ranks.N_LAYERS]))


def _student(cfg):
    """A converted student of the cut preset (layer 0 SWA, layer 1 Mamba2)
    with its mixer's leaves drawn from a seed, and its config."""
    tcfg = dataclasses.replace(cfg.text,
                               layer_types=("full_attention",) * cfg.text.num_hidden_layers)
    teacher = init_text_params(jax.random.PRNGKey(0), tcfg, jnp.float32)
    student, scfg = convert_attention(teacher, tcfg, jax.random.PRNGKey(6),
                                      softmax_attention=(0,), mixer="mamba2")
    student = _np(student)
    rng = np.random.RandomState(4)
    lp = student["layers"][1]
    for k in MIXER_LEAVES:
        lp[k] = jax.tree.map(lambda x: (rng.randn(*x.shape) * 0.2 + (k == "D")).astype(x.dtype),
                             lp[k])
    lp["A_log"] = np.log(rng.uniform(1.0, 4.0, lp["A_log"].shape)).astype(np.float32)
    return student, dataclasses.replace(cfg, text=scfg)


# ---------------------------------------------------------------- in process


def test_param_spec_and_local_shapes_of_a_student_equal_jax():
    """Every leaf of a converted student (3B width, JAX's shapes): the port's
    spec is JAX's on (1, 2), (2, 2) and (1, 4) in each mode, so q / k / v /
    g_proj, o_proj, A_log and dt_bias are sliced and conv_w, conv_b, dt_proj,
    D and o_norm are whole on the model axis; shard_params on the tiny
    student gives every leaf the local shape of that spec."""
    from infinitevl_tpu.config import infinitevl_3b

    big = infinitevl_3b().text
    big = dataclasses.replace(big, layer_types=("full_attention",) * big.num_hidden_layers)
    shapes = jax.eval_shape(lambda: convert_attention(
        init_text_params(jax.random.PRNGKey(0), big, jnp.bfloat16), big,
        jax.random.PRNGKey(1), mixer="mamba2")[0])
    leaves = [("text/" + _path_str(p), tuple(x.shape))
              for p, x in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    assert any(p.endswith("/conv_w") for p, _ in leaves)
    for data, model in ((1, 2), (2, 2), (1, 4)):
        mesh = create_mesh(data=data, model=model)
        for mode in ("tp", "fsdp", "replicated"):
            for path, shape in leaves:
                want = tuple(param_spec(path, shape, mesh, param_mode=mode))
                want = want + (None,) * (len(shape) - len(want))
                assert tsh.param_spec(path, shape, data, model, mode) == want, (path, mode)
    student, scfg = _student(_cut_cfg())
    tree = {"text": from_jax_numpy(student, "cpu")}
    got = dict(tree_leaves_with_path(tsh.shard_params(tree, tsh.Mesh(1, 2, 1), "tp")))
    for path, t in tree_leaves_with_path(tree):
        spec = tsh.param_spec(path, t.shape, 1, 2, "tp")
        want = tuple(s // 2 if ax == "model" else s for s, ax in zip(t.shape, spec))
        assert tuple(got[path].shape) == want, path
        assert (tsh.tp_info(got[path]) is not None) == ("model" in spec), path
    lp = got
    for k in ("conv_w", "conv_b", "D", "o_norm", "dt_proj/kernel"):
        assert tsh.tp_info(lp[f"text/layers/1/{k}"]) is None, k
    for k in ("q_proj/kernel", "g_proj/kernel", "o_proj/kernel", "A_log", "dt_bias"):
        assert tsh.tp_info(lp[f"text/layers/1/{k}"]) is not None, k


def test_mamba_state_layout_is_the_ranks_heads_and_channels():
    """JAX's state rules name neither Mamba2 key (it holds both whole); a
    rank of the port holds its heads of mamba_h and, of mamba_conv's
    channels [v | k | q], its heads' columns of each third; shard_state cuts
    the whole state to that part and local_state_shape agrees."""
    from infinitevl_tpu.parallel.sharding import _STATE_RULES

    assert not any(pat.startswith("mamba") for pat, _ in _STATE_RULES)
    M, B, W, H, Dh = 2, 2, 4, 4, 3
    conv = torch.arange(M * B * W * 3 * H * Dh, dtype=torch.float32).reshape(M, B, W, 3 * H * Dh)
    h = torch.randn(M, B, H, Dh, Dh)
    third, n = H * Dh, H * Dh // 2
    for r in range(2):
        mesh = tsh.Mesh(1, 2, r)
        part = tsh.shard_state({"mamba_conv": conv, "mamba_h": h, "cum_len": 3}, mesh, H)
        cols = [c for j in range(3) for c in range(j * third + r * n, j * third + (r + 1) * n)]
        assert torch.equal(part["mamba_conv"], conv[..., cols])
        assert torch.equal(part["mamba_h"], h[:, :, r * 2 : (r + 1) * 2])
        assert part["cum_len"] == 3
        for k in ("mamba_conv", "mamba_h"):
            whole = {"mamba_conv": conv, "mamba_h": h}[k]
            assert tsh.local_state_shape(k, whole.shape, mesh, H) == tuple(part[k].shape)
    # (2, 2): the rank's batch rows too
    part = tsh.shard_state({"mamba_conv": conv}, tsh.Mesh(2, 2, 3), H)["mamba_conv"]
    cols = [c for j in range(3) for c in range(j * third + n, j * third + 2 * n)]
    assert torch.equal(part, conv[:, 1:2][..., cols])


# ---------------------------------------------------------------- against JAX


def _conf(name, out, **over):
    import yaml

    conf = yaml.safe_load(open(os.path.join(REPO, "examples", name)))
    conf.update(dataset_dir=os.path.join(REPO, "data"), logging_steps=1, max_steps=2,
                save_steps=1000, output_dir=str(out), softmax_attention=[0],
                max_grad_norm=1e9, model_parallel=2, param_mode="tp")
    conf.update(over)
    return conf


STAGES = (1, 2)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX's sharded forwards, gradients and cached steps of the student and
    its run_exp of each stage at (1, 2), then one launch of two port ranks
    for all of them."""
    tmp = tmp_path_factory.mktemp("tp_mamba2")
    cfg = _cut_cfg()
    student, scfg = _student(cfg)
    rng = np.random.RandomState(0)
    B, T = 2, 40  # past the window (16) and the chunk (8)
    ids = rng.randint(0, cfg.text.vocab_size, (B, T)).astype(np.int64)
    pos = np.ascontiguousarray(np.broadcast_to(np.arange(T)[None, None], (3, B, T)))
    labels = np.where(rng.rand(B, T) < 0.8, rng.randint(0, cfg.text.vocab_size, (B, T)), -100)
    mesh = create_mesh(data=1, model=2)
    sp = shard_params({"text": jax.tree.map(jnp.asarray, student)}, mesh, param_mode="tp")

    @jax.jit
    def fwd(p, ids, pos):
        h = text_forward(p["text"], scfg.text, embed_tokens(p["text"], ids), pos)[0]
        return h, lm_head(p["text"], scfg.text, h)

    h, lg = fwd(sp, jnp.asarray(ids), jnp.asarray(pos))
    want = {"hidden": np.asarray(h), "logits": np.asarray(lg)}
    grad = jax.jit(jax.grad(lambda p: sft_loss_fn(p["text"], scfg.text, jnp.asarray(ids),
                                                  jnp.asarray(labels), jnp.asarray(pos))))
    flat = jax.tree_util.tree_flatten_with_path(grad(sp))[0]
    want["grads"] = {_path_str(k): np.asarray(v) for k, v in flat}
    cached = jax.jit(lambda p, ids, pos, st: jforward(p, scfg, ids, pos, st, logits_to_keep=1))
    st = shard_state(jinit_state(scfg.text, B, jnp.float32), mesh)
    lg, st = cached(sp, jnp.asarray(ids), jnp.asarray(pos), st)
    steps, tokens = [np.asarray(lg[:, 0])], []
    for _ in range(DECODE_STEPS):
        tok = jnp.argmax(lg[:, 0], axis=-1)[:, None]
        tokens.append(np.asarray(tok))
        lg, st = cached(sp, tok, jnp.full((3, B, 1), int(st["cum_len"])), st)
        steps.append(np.asarray(lg[:, 0]))
    want.update(steps=steps, tokens=tokens, state={k: np.asarray(v) for k, v in st.items()})

    # run_exp of each stage on the same mesh, JAX's teacher and student drawn
    # there and carried to the port's ranks
    teacher = init_text_params(jax.random.PRNGKey(0), dataclasses.replace(
        cfg.text, layer_types=("full_attention",) * cfg.text.num_hidden_layers), jnp.float32)
    seen, runs = {}, {}
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jtrainer, "init_text_params", lambda key, c, dtype: jax.tree.map(
            jnp.array, teacher))
        mp.setattr(jtrainer, "_make_tx", freeze_inv_freq(jtrainer._make_tx))
        real = jtrainer.convert_attention

        def record(*a, **kw):
            out = real(*a, **kw)
            seen["student"] = _np(out[0])
            return out

        mp.setattr(jtrainer, "convert_attention", record)
        mp.setattr(jtrainer, "tiny_config", lambda: cfg)
        for stage in STAGES:
            out = tmp / f"jax_{stage}"
            final = jtrainer.run_exp(jparse(_conf("dt_stage1_mamba2_tiny.yaml", out,
                                                  distill_stage=stage)))
            runs[stage] = {"final": {_path_str(p): np.asarray(x) for p, x in
                                     jax.tree_util.tree_flatten_with_path(final)[0]},
                           "losses": ranks.losses(str(out)), "student": seen["student"]}
    finally:
        mp.undo()
    jobs = [{"kind": "tp_forwards", "mesh": (1, 2), "cfg": to_port_config(scfg),
             "params": {"text": student}, "ids": ids, "pos": pos, "labels": labels,
             "cached": DECODE_STEPS}]
    for stage in STAGES:
        jobs.append({"kind": "run", "carry": {"teacher": _np(teacher),
                                              "student": runs[stage]["student"]},
                     "conf": _conf("dt_stage1_mamba2_tiny.yaml", tmp / f"port_{stage}",
                                   distill_stage=stage)})
    got = spawn_ranks(ranks.jobs, 2, (jobs,), timeout=DEADLINE, threads=1, workdir=str(tmp))
    return dict(want=want, got=got, runs=runs, scfg=scfg)


def test_student_forward_and_gradients_match_jax_sharded(world):
    """The stateless forward on each rank and every leaf's gradient of the
    SFT loss (the mixer's whole leaves summed over the model group through
    tp_copy, its sliced leaves each rank's) against JAX's sharded ones."""
    want = world["want"]
    for r in world["got"]:
        res = r[0]
        assert err_ratio(res["hidden"], want["hidden"]) < TOL
        assert err_ratio(res["logits"], want["logits"]) < TOL
        got = res["grads"]
        assert got.keys() == want["grads"].keys()
        assert any("layers/1/conv_w" in k for k in got)
        errs = {k: err_ratio(v, want["grads"][k]) for k, v in got.items()
                if not k.endswith("k_proj/bias")}
        assert max(errs.values()) < MODEL_TOL, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
        sq = sum(float((v.astype(np.float64) ** 2).sum()) for v in want["grads"].values())
        assert abs(res["grad_sq_norm"] - sq) < 1e-5 * sq


def test_student_cached_prefill_and_decode_match_jax_sharded(world):
    """Prefill of 40 tokens, then greedy decode steps: logits <= 1e-4,
    tokens equal, the Mamba2 state gathered from the ranks' parts <= 1e-5
    of JAX's whole one; each rank holds exactly half of each Mamba2 key and
    its part is its heads' slice of the whole (the conv history's three
    blocks)."""
    want, scfg = world["want"], world["scfg"].text
    H, Dh = scfg.num_attention_heads, scfg.head_dim
    third, n = H * Dh, H * Dh // 2
    for r, ranks_out in enumerate(world["got"]):
        res = ranks_out[0]
        assert len(res["steps"]) == DECODE_STEPS + 1
        for a, b in zip(res["steps"], want["steps"]):
            assert err_ratio(a, b) < MODEL_TOL
        assert all(np.array_equal(a, b) for a, b in zip(res["tokens"], want["tokens"]))
        for k in ("mamba_conv", "mamba_h", "swa_k", "swa_v"):
            assert res["state"][k].shape == want["state"][k].shape, k
            assert err_ratio(res["state"][k], want["state"][k]) < TOL, k
        assert res["roundtrip"]
        part, whole = res["part"], res["state"]
        for k in ("mamba_conv", "mamba_h"):
            assert 2 * part[k].size == whole[k].size, k
        np.testing.assert_array_equal(part["mamba_h"], whole["mamba_h"][:, :, r * 2 : r * 2 + 2])
        cols = [c for j in range(3) for c in range(j * third + r * n, j * third + (r + 1) * n)]
        np.testing.assert_array_equal(part["mamba_conv"], whole["mamba_conv"][..., cols])


@pytest.mark.parametrize("stage", STAGES)
def test_run_dt_mamba2_on_the_model_axis_matches_jax(world, stage):
    """run_exp with stage dt, mixer mamba2, at (1, 2) under tp: both step
    losses within 1e-4 relative of JAX's on the same mesh, every trained
    leaf err_ratio <= 1e-4, every rank returning the same whole student."""
    want = world["runs"][stage]
    got = [r[STAGES.index(stage) + 1] for r in world["got"]]
    r0 = got[0]
    assert len(r0["losses"]) == len(want["losses"]) == 2
    assert max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], want["losses"])) < MODEL_TOL, (
        r0["losses"], want["losses"])
    assert r0["final"].keys() == want["final"].keys()
    assert all(np.array_equal(r["final"][k], r0["final"][k]) for r in got for k in r0["final"])
    errs = {k: err_ratio(v, want["final"][k]) for k, v in r0["final"].items()
            if not k.endswith("k_proj/bias")}
    assert max(errs.values()) < MODEL_TOL, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    start = {_path_str(p): np.asarray(x) for p, x in
             jax.tree_util.tree_flatten_with_path(want["student"])[0]}
    conv = next(k for k in r0["final"] if k.endswith("layers/1/conv_w"))
    assert not np.array_equal(r0["final"][conv], start[conv.split("/", 1)[-1]]
                              if conv not in start else start[conv])
