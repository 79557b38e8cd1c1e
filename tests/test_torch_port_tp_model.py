"""Tensor parallelism (the model axis of parallel/sharding.py) of the
port's forwards against the JAX package's sharded forwards, on the CPU in
fp32: the port's ranks spawned under gloo by
infinitevl_tpu_torch.parallel.launch.spawn_ranks (what they run is in
tests/torch_port_ranks.py), JAX's on its 8-device virtual CPU mesh, the
same numpy weights on both sides.

- `param_spec` gives JAX's axis per dim for every leaf of the tiny and 3B
  trees on (data, model) meshes of (1, 2), (2, 2) and (1, 4), each mode;
- `hybrid_device_order` lays out stub nodes as JAX's (and raises where
  JAX's raises);
- the stateless forward (hidden states and logits) at (1, 2), (2, 2) and
  (1, 4) against JAX's jitted `text_forward` on `shard_params(..., "tp")`,
  err_ratio <= 1e-5 (JAX's own bound for its sharded forward); at (1, 4)
  the k/v projections' split cuts a KV head;
- the ViT at (1, 2) and (1, 4), where the fused qkv's split cuts heads;
- at (1, 2) the SFT loss's gradient of every leaf, and of LoRA factors on
  the frozen sharded model, against `jax.grad` on JAX's sharded params,
  err_ratio <= 1e-4 (Adam's update does not see a leaf's gradient scale,
  so the trained weights alone would not show a factor summed over the
  model group, or not, that should not be);
- the cached prefill and 4 greedy decode steps at (1, 2) against JAX's
  jitted forward on sharded params and `shard_state`: logits <= 1e-5,
  tokens identical, the state gathered whole <= 1e-5 of JAX's; the rank's
  part cut again from the whole is bit-equal; each rank holds 1/model of
  the sharded leaves' bytes;
- the options that do not run under model_parallel > 1 raise by name."""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_ranks as ranks
from torch_port_helpers import err_ratio, to_port_config
from torch_port_helpers import jax_compile_cache  # noqa: F401 (autouse)

import infinitevl_tpu_torch.parallel.sharding as tsh
from infinitevl_tpu.config import VisionConfig, infinitevl_3b, tiny_config
from infinitevl_tpu.models.infinitevl import encode_vision as jencode
from infinitevl_tpu.models.infinitevl import forward as jforward
from infinitevl_tpu.models.params import init_params
from infinitevl_tpu.models.state import init_decoder_state as jinit_state
from infinitevl_tpu.train.lora import apply_lora, init_lora
from infinitevl_tpu.train.step import sft_loss_fn
from infinitevl_tpu.models.text import embed_tokens, lm_head, text_forward
from infinitevl_tpu.parallel.sharding import (
    _path_str,
    create_mesh,
    hybrid_device_order,
    param_spec,
    shard_params,
    shard_state,
)
from infinitevl_tpu_torch.parallel.launch import spawn_ranks

torch.set_num_threads(2)

TOL = 1e-5
GRAD_TOL = 1e-4
LORA_RANK = 4
DEADLINE = 300.0
N_LAYERS = 2  # one SWA and one DeltaNet layer
MESHES = ((1, 2), (2, 2), (1, 4))
DECODE_STEPS = 4

# a ViT small enough for the CPU (tests/test_torch_port_vision.py's): 4 heads of 8
VCFG = VisionConfig(depth=2, hidden_size=32, intermediate_size=64, num_heads=4,
                    patch_size=2, spatial_merge_size=2, temporal_patch_size=1,
                    window_size=8, out_hidden_size=64, fullatt_block_indexes=(1,))
GRID = ((1, 8, 8),)


def _cfg():
    cfg = tiny_config()
    return dataclasses.replace(cfg, vision=VCFG, text=dataclasses.replace(
        cfg.text, num_hidden_layers=N_LAYERS, layer_types=cfg.text.layer_types[:N_LAYERS]))


# ---------------------------------------------------------------- param_spec


def _shapes(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(_path_str(p), tuple(x.shape)) for p, x in flat]


@pytest.fixture(scope="module")
def trees():
    tiny = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), tiny_config(),
                                              jnp.float32))
    big = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), infinitevl_3b(),
                                             jnp.bfloat16))
    return {"tiny": _shapes(tiny), "3b": _shapes(big)}


@pytest.mark.parametrize("mode", ["tp", "fsdp", "replicated"])
@pytest.mark.parametrize("data,model", MESHES)
def test_param_spec_model_axis_equals_jax(trees, data, model, mode):
    mesh = create_mesh(data=data, model=model)
    n = sharded = 0
    for name, leaves in trees.items():
        for path, shape in leaves:
            want = tuple(param_spec(path, shape, mesh, param_mode=mode))
            want = want + (None,) * (len(shape) - len(want))
            got = tsh.param_spec(path, shape, data, model, mode)
            assert got == want, (name, path, shape)
            n += 1
            sharded += "model" in got
    assert n > 500 and (sharded > 300) == (mode != "replicated")


# ---------------------------------------------------------------- hybrid_device_order


class _Stub:
    def __init__(self, id, slice_index):
        self.id, self.slice_index = id, slice_index


LAYOUTS = {
    # name: (n devices, slice of device i, data, model)
    "one_slice": (8, lambda i: 0, 4, 2),
    "interleaved": (8, lambda i: i % 2, 4, 2),
    "blocks": (8, lambda i: i // 4, 2, 4),
    "four_slices": (8, lambda i: i % 4, 4, 2),
    "model_crosses": (8, lambda i: i % 4, 2, 4),  # 2 a slice, model 4: raises
    "rows_short": (8, lambda i: i // 4, 4, 2),  # fine
    "too_few": (6, lambda i: 0, 4, 2),  # 6 devices for 8: raises
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_hybrid_device_order_equals_jax(layout):
    n, slice_of, data, model = LAYOUTS[layout]
    devs = [_Stub(i, slice_of(i)) for i in range(n)]
    try:
        want = hybrid_device_order(devs, data, model)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tsh.hybrid_device_order(devs, data, model)
        assert str(got.value) == str(e)
        return
    got = tsh.hybrid_device_order([tsh.RankDevice(d.id, d.slice_index) for d in devs],
                                  data, model)
    assert got.shape == want.shape == (data, model)
    assert [[d.id for d in row] for row in got] == [[d.id for d in row] for row in want]
    # the model axis never leaves a slice
    assert all(len({d.slice_index for d in row}) == 1 for row in got)


def test_mesh_coordinates_and_node_index(monkeypatch):
    """Rank r sits at (r // model, r % model) under create_mesh; a hybrid
    order places it by its node, its coordinates being its places in its
    (ascending) groups; the node comes from GROUP_RANK or LOCAL_WORLD_SIZE."""
    coords = [(tsh.Mesh(2, 4, r).data_rank, tsh.Mesh(2, 4, r).model_rank) for r in range(8)]
    assert coords == [(r // 4, r % 4) for r in range(8)]
    order = ((1, 3), (5, 7), (0, 2), (4, 6))  # the interleaved layout's
    m = tsh.Mesh(4, 2, 5, order)
    assert (m.data_rank, m.model_rank) == (3, 0)  # data group (1, 5, 0, 4): 0 1 4 5
    for var in ("GROUP_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert tsh.node_index() == 0
    monkeypatch.setenv("GROUP_RANK", "3")
    assert tsh.node_index() == 3


# ---------------------------------------------------------------- forwards against JAX


def _weights(cfg):
    """JAX's weights from key 0 as numpy, every leaf the init leaves zero
    (the biases) drawn from a seed, so that each sharded leaf shows."""
    params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), cfg, jnp.float32))
    rng = np.random.RandomState(3)
    return jax.tree.map(lambda x: (rng.randn(*x.shape) * 0.1).astype(x.dtype)
                        if x.dtype == np.float32 and not np.abs(x).sum() else x, params)


@pytest.fixture(scope="module")
def world():
    """Two launches of the port's ranks, two for (1, 2) and four for (2, 2)
    and (1, 4), on a thread while JAX's sharded forwards run on each mesh
    (the ranks need only the inputs)."""
    cfg = _cfg()
    tcfg = to_port_config(cfg)
    params = _weights(cfg)
    rng = np.random.RandomState(0)
    B, T = 2, 40  # past the window (16) and the DeltaNet chunk (8): the rings wrap
    ids = rng.randint(0, cfg.text.vocab_size, (B, T)).astype(np.int64)
    pos = np.ascontiguousarray(np.broadcast_to(np.arange(T)[None, None], (3, B, T)))
    feat = VCFG.in_channels * VCFG.temporal_patch_size * VCFG.patch_size**2
    pixels = rng.randn(sum(t * h * w for t, h, w in GRID), feat).astype(np.float32)

    @jax.jit
    def fwd(p, ids, pos):
        h = text_forward(p["text"], cfg.text, embed_tokens(p["text"], ids), pos)[0]
        return h, lm_head(p["text"], cfg.text, h)

    vit = jax.jit(lambda p, px: jencode(p, cfg, px, GRID))
    labels = np.where(rng.rand(B, T) < 0.8, rng.randint(0, cfg.text.vocab_size, (B, T)), -100)
    # LoRA factors on q/k/v/o with b drawn too (b = 0 leaves a's gradient 0)
    lora = jax.tree.map(np.asarray, init_lora({"text": jax.tree.map(jnp.asarray, params["text"])},
                                              jax.random.PRNGKey(1), rank=LORA_RANK))
    lora = jax.tree.map(lambda x: (rng.randn(*x.shape) * 0.1).astype(np.float32), lora)
    loss = lambda p: sft_loss_fn(p["text"], cfg.text, jnp.asarray(ids), jnp.asarray(labels),
                                 jnp.asarray(pos))
    grad = jax.jit(jax.grad(loss))
    lora_grad = jax.jit(jax.grad(lambda l, p: loss(apply_lora(p, l, 16.0, LORA_RANK))))
    cached = jax.jit(lambda p, ids, pos, st: jforward(p, cfg, ids, pos, st, logits_to_keep=1))

    def job(mesh, **kw):
        return dict(mesh=mesh, cfg=tcfg, params=params, ids=ids, pos=pos, **kw)

    def launch():
        two = spawn_ranks(ranks.tp_forwards, 2, ([job((1, 2), pixels=pixels, grid=GRID,
                                                      cached=DECODE_STEPS, labels=labels,
                                                      lora=lora, lora_rank=LORA_RANK)],),
                          timeout=DEADLINE, threads=1)
        four = spawn_ranks(ranks.tp_forwards, 4, ([job((2, 2)), job((1, 4), pixels=pixels,
                                                                   grid=GRID)],),
                           timeout=DEADLINE, threads=1)
        return two, four

    with ThreadPoolExecutor(1) as pool:
        launched = pool.submit(launch)
        want = {}
        for data, model in MESHES:
            mesh = create_mesh(data=data, model=model)
            sp = shard_params(jax.tree.map(jnp.asarray, params), mesh, param_mode="tp")
            h, lg = fwd(sp, jnp.asarray(ids), jnp.asarray(pos))
            want[(data, model)] = {"hidden": np.asarray(h), "logits": np.asarray(lg)}
            if data == 1:
                want[(data, model)]["vit"] = np.asarray(vit(sp, jnp.asarray(pixels)))
            if (data, model) == (1, 2):
                flat = jax.tree_util.tree_flatten_with_path(grad({"text": sp["text"]}))[0]
                want[(1, 2)]["grads"] = {_path_str(k): np.asarray(v) for k, v in flat}
                flat = jax.tree_util.tree_flatten_with_path(
                    lora_grad(jax.tree.map(jnp.asarray, lora), {"text": sp["text"]}))[0]
                want[(1, 2)]["lora_grads"] = {_path_str(k): np.asarray(v) for k, v in flat}
            if (data, model) == (1, 2):
                st = shard_state(jinit_state(cfg.text, B, jnp.float32), mesh)
                lg, st = cached(sp, jnp.asarray(ids), jnp.asarray(pos), st)
                steps, tokens = [np.asarray(lg[:, 0])], []
                for _ in range(DECODE_STEPS):
                    tok = jnp.argmax(lg[:, 0], axis=-1)[:, None]
                    tokens.append(np.asarray(tok))
                    at = jnp.full((3, B, 1), int(st["cum_len"]))
                    lg, st = cached(sp, tok, at, st)
                    steps.append(np.asarray(lg[:, 0]))
                want[(1, 2)].update(steps=steps, tokens=tokens,
                                    state={k: np.asarray(v) for k, v in st.items()})
        two, four = launched.result()
    got = {(1, 2): [r[0] for r in two], (2, 2): [r[0] for r in four],
           (1, 4): [r[1] for r in four]}
    return dict(want=want, got=got, cfg=cfg)


@pytest.mark.parametrize("mesh", MESHES)
def test_stateless_forward_matches_jax_sharded(world, mesh):
    want, got = world["want"][mesh], world["got"][mesh]
    for res in got:  # every rank holds the whole hidden state and logits
        assert err_ratio(res["hidden"], want["hidden"]) < TOL
        assert err_ratio(res["logits"], want["logits"]) < TOL
    assert all(np.array_equal(r["hidden"], got[0]["hidden"]) for r in got)
    held, whole = got[0]["held"]
    assert whole == mesh[1] * held  # the sharded leaves' bytes, 1/model each


@pytest.mark.parametrize("mesh", [(1, 2), (1, 4)])
def test_vit_forward_matches_jax_sharded(world, mesh):
    """At model 2 the fused qkv [32, 96] is split into column halves (rank 0:
    all of q, half of k); at model 4 into quarters of 24: heads are cut,
    gathered and each rank attends with the heads of its proj rows."""
    want = world["want"][mesh]["vit"]
    for res in world["got"][mesh]:
        assert err_ratio(res["vit"], want) < TOL


@pytest.mark.parametrize("which", ["grads", "lora_grads"])
def test_gradients_match_jax_sharded(world, which):
    """Every leaf's gradient (full finetuning) and the replicated LoRA
    factors' (whose gradients on a sharded kernel are summed over the model
    group) against jax.grad on JAX's sharded params, each rank's whole;
    and the optimizer's squared global norm taken over the slices."""
    want = world["want"][(1, 2)][which]
    for res in world["got"][(1, 2)]:
        got = res[which]
        assert got.keys() == want.keys() and len(got) >= 16
        # k_proj's bias: no gradient in exact arithmetic (rounding noise on both sides)
        errs = {k: err_ratio(v, want[k]) for k, v in got.items()
                if not k.endswith("k_proj/bias")}
        assert max(errs.values()) < GRAD_TOL, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
        if which == "grads":  # the clip's global norm, the slices' squares summed
            sq = sum(float((v.astype(np.float64) ** 2).sum()) for v in want.values())
            assert abs(res["grad_sq_norm"] - sq) < 1e-5 * sq


def test_cached_prefill_and_decode_match_jax_sharded(world):
    want, got = world["want"][(1, 2)], world["got"][(1, 2)]
    cfg = world["cfg"].text
    for res in got:
        assert len(res["steps"]) == len(want["steps"]) == DECODE_STEPS + 1
        for a, b in zip(res["steps"], want["steps"]):
            assert err_ratio(a, b) < TOL
        assert all(np.array_equal(a, b) for a, b in zip(res["tokens"], want["tokens"]))
        assert res["cum_len"] == int(want["state"]["cum_len"])
        for k, v in res["state"].items():
            assert v.shape == want["state"][k].shape, k
            assert err_ratio(v, want["state"][k]) < TOL, k
        assert res["roundtrip"]
    # each rank's part: its KV head of the rings, half the DeltaNet heads and channels
    for r, res in enumerate(got):
        part, whole = res["part"], res["state"]
        assert part["swa_k"].shape[2] == cfg.num_key_value_heads // 2
        np.testing.assert_array_equal(part["swa_k"], whole["swa_k"][:, :, r : r + 1])
        h = cfg.num_linear_heads // 2
        np.testing.assert_array_equal(part["delta_h"], whole["delta_h"][:, :, r * h : (r + 1) * h])
        c = whole["conv_v"].shape[-1] // 2
        np.testing.assert_array_equal(part["conv_v"], whole["conv_v"][..., r * c : (r + 1) * c])


def test_state_rule_shards_the_rings_heads_not_their_capacity():
    """A deliberate departure: JAX's rule for swa_k / swa_v names dim 3,
    which in the head-major [S, B, Hkv, cap, Dh] layout is the ring's
    capacity; the port shards dim 2, Hkv, and where Hkv does not divide
    over the model axis each rank holds the KV heads its query heads read."""
    from infinitevl_tpu.parallel.sharding import _STATE_RULES

    assert dict(_STATE_RULES)[r"swa_[kv]"] == jax.sharding.PartitionSpec(
        None, "data", None, "model", None)
    assert tsh.state_spec("swa_k", (9, 4, 2, 8192, 128), 2, 2) == (
        None, "data", "model", None, None)
    cfg = infinitevl_3b().text
    shape = (9, 1, 2, 8192, 128)
    assert tsh.local_state_shape("swa_v", shape, tsh.Mesh(1, 2, 1), 16) == (9, 1, 1, 8192, 128)
    # 2 KV heads over 4 ranks: ranks 0 and 1 read KV head 0, ranks 2 and 3 KV head 1
    assert [tsh.kv_head_range(cfg.num_attention_heads, 2, 4, r) for r in range(4)] == [
        (0, 1), (0, 1), (1, 2), (1, 2)]
    whole = torch.arange(2 * 2 * 2 * 3 * 4, dtype=torch.float32).reshape(2, 2, 2, 3, 4)
    for r in range(4):
        part = tsh.shard_state({"swa_k": whole}, tsh.Mesh(1, 4, r), 4)["swa_k"]
        assert torch.equal(part, whole[:, :, r // 2 : r // 2 + 1])
    conv = torch.arange(27 * 4 * 256, dtype=torch.float32).reshape(27, 1, 4, 256)
    for r in range(2):
        part = tsh.shard_state({"conv_q": conv}, tsh.Mesh(1, 2, r), 16)["conv_q"]
        assert torch.equal(part, conv[..., r * 128 : (r + 1) * 128])


# ---------------------------------------------------------------- refusals


def test_what_does_not_run_under_model_parallel_raises_by_name(monkeypatch):
    """int4 weights raise in shard_params at model > 1; a Mamba2 layer
    shards by JAX's rules (its q / k / v / g / o_proj, A_log and dt_bias
    sliced, conv_w, conv_b, dt_proj and D whole:
    tests/test_torch_port_tp_mamba2.py runs it); GaLore, APOLLO and
    Adam-mini update a model-axis slice as the whole leaf's update sliced
    (the gradient's gather stood in for; over real ranks in
    tests/test_torch_port_sliced_updates.py); LoRA+ and BAdam run on the
    slices; DoRA runs too (tests/test_torch_port_tp_train.py)."""
    from torch_port_helpers import slice_update_err

    from infinitevl_tpu_torch.train.optim import make_custom_optimizer

    monkeypatch.setattr(tsh, "_TP", tsh._TP)  # this process's flag, restored after
    mesh = tsh.Mesh(1, 2, 0)
    layer = {"conv_w": torch.zeros(4, 24), "dt_proj": {"kernel": torch.zeros(8, 2)},
             "A_log": torch.zeros(2), "q_proj": {"kernel": torch.zeros(8, 8)}}
    out = tsh.shard_params({"text": {"layers": [layer]}}, mesh, "tp")["text"]["layers"][0]
    assert out["conv_w"] is layer["conv_w"] and out["dt_proj"]["kernel"] is layer["dt_proj"][
        "kernel"]
    assert tuple(out["A_log"].shape) == (1,) and tuple(out["q_proj"]["kernel"].shape) == (8, 4)
    q4 = {"o_proj": {"kernel_q4": torch.zeros(8, 4, dtype=torch.uint8)}}
    with pytest.raises(NotImplementedError, match="int4 weights under model_parallel"):
        tsh.shard_params({"text": {"layers": [q4]}}, mesh, "tp")
    # the rule table itself, with nothing to refuse, shards a kernel in place
    out = tsh.shard_params({"text": {"layers": [{"q_proj": {"kernel": torch.ones(8, 8)}}]}},
                           mesh, "tp")
    assert tsh.tp_info(out["text"]["layers"][0]["q_proj"]["kernel"]) == tsh.ShardInfo(
        1, 8, 2, 0, "model")
    for name, kw in (("galore", dict(rank=4, update_proj_gap=1, min_dim=8)),
                     ("apollo", dict(rank=4)), ("adam_mini", dict(head_dim=16))):
        for info in (tsh.ShardInfo(1, 64, 2, 1, "model"), tsh.ShardInfo(0, 32, 2, 0, "model")):
            err, whole = slice_update_err(name, "_ivl_tp", info, monkeypatch, kw)
            assert err == 0.0 and whole == (32, 64), (name, info, err)
    w = torch.zeros(4, 32, requires_grad=True)
    with tsh.use_mesh(mesh):
        for name in ("loraplus", "badam"):
            assert make_custom_optimizer(name, 1e-3).init({"text": {"w": w}})["count"] == 0
