"""The data axis's rules and launch checks against the JAX package on the
CPU: `param_spec` equal to JAX's on four meshes and three modes, the
launchers' environment parsing, `create_mesh`'s checks, the refusals
that remain, and a failing rank failing its launch."""

import jax
import jax.numpy as jnp
import pytest
import torch
import torch_port_ranks as ranks
from test_torch_port_parallel import _conf
from torch_port_helpers import jax_compile_cache  # noqa: F401 (autouse)

import infinitevl_tpu_torch.parallel.sharding as tsh
from infinitevl_tpu.config import infinitevl_3b, tiny_config
from infinitevl_tpu.models.params import init_params
from infinitevl_tpu.models.quant import quantize_params
from infinitevl_tpu.parallel.sharding import _path_str
from infinitevl_tpu.parallel.sharding import create_mesh, param_spec
from infinitevl_tpu_torch.parallel.launch import spawn_ranks

torch.set_num_threads(2)


def _shapes(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(_path_str(p), tuple(x.shape)) for p, x in flat]



@pytest.fixture(scope="module")
def trees():
    tiny = init_params(jax.random.PRNGKey(0), tiny_config(), jnp.float32)
    big = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), infinitevl_3b(),
                                             jnp.bfloat16))
    # the 3B student of distillation and the int8 base of QLoRA, by shape
    q = jax.eval_shape(lambda: quantize_params(init_params(jax.random.PRNGKey(0),
                                                           infinitevl_3b(), jnp.bfloat16)))
    return {"tiny": _shapes(tiny), "3b": _shapes(big), "3b_int8": _shapes(q),
            "3b_text_tree": _shapes(big["text"])}


@pytest.mark.parametrize("mode", ["tp", "fsdp", "replicated"])
@pytest.mark.parametrize("data,model", [(2, 1), (4, 1), (8, 1), (4, 2)])
def test_param_spec_equals_jax(trees, data, model, mode):
    mesh = create_mesh(data=data, model=model)
    n = 0
    for name, leaves in trees.items():
        for path, shape in leaves:
            want = tuple(param_spec(path, shape, mesh, param_mode=mode))
            want = want + (None,) * (len(shape) - len(want))
            assert tsh.param_spec(path, shape, data, model, mode) == want, (name, path, shape)
            n += 1
    assert n > 1000


def test_maybe_init_distributed_env_parsing(monkeypatch):
    """JAX's names or torchrun's resolve to one init_process_group over tcp;
    no environment or a world of 1 is a no-op; a world above 1 without an
    address raises (nothing falls back to one process)."""
    calls = []
    monkeypatch.setattr(tsh.dist, "init_process_group", lambda *a, **kw: calls.append((a, kw)))
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: calls.append(("set", dev)))
    monkeypatch.setattr(tsh, "_distributed_initialized", False)
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "MASTER_ADDR",
                "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)

    assert tsh.maybe_init_distributed(device="cpu") is False and not calls

    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    assert tsh.maybe_init_distributed(device="cpu") is True
    assert calls == [(("gloo",), {"init_method": "tcp://10.0.0.1:1234", "world_size": 4,
                                  "rank": 2})]
    assert tsh.maybe_init_distributed(device="cpu") is True and len(calls) == 1  # idempotent

    # JAX's names win over torchrun's; the default device is cuda:LOCAL_RANK under nccl
    monkeypatch.setattr(tsh, "_distributed_initialized", False)
    monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.9:8476")
    monkeypatch.setenv("NUM_PROCESSES", "2")
    monkeypatch.setenv("PROCESS_ID", "0")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert tsh.maybe_init_distributed() is True
    assert calls[-2:] == [("set", torch.device("cuda", 1)),
                          (("nccl",), {"init_method": "tcp://10.0.0.9:8476", "world_size": 2,
                                       "rank": 0})]

    # a world of one is a no-op
    calls.clear()
    monkeypatch.setattr(tsh, "_distributed_initialized", False)
    monkeypatch.setenv("NUM_PROCESSES", "1")
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var)
    assert tsh.maybe_init_distributed(device="cpu") is False and not calls

    # a world above one without its address raises
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(var)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        tsh.maybe_init_distributed(device="cpu")
    assert not calls


def test_create_mesh_checks_the_world_and_refuses_tp():
    """The world must hold data x model ranks, the model axis included (a
    one-process world refuses model 2 as it refuses data 2; tensor
    parallelism itself is held by tests/test_torch_port_tp_*.py)."""
    assert tsh.create_mesh(1, 1) == tsh.Mesh(1, 1, 0)
    with pytest.raises(ValueError, match="data_parallel"):
        tsh.create_mesh(2, 1)
    with pytest.raises(ValueError, match="1 x 2"):
        tsh.create_mesh(1, 2)


def test_whole_leaf_updates_and_tp_refuse_by_name(tmp_path, monkeypatch):
    """GaLore, APOLLO and Adam-mini read each whole leaf: on an FSDP slice
    their update is the whole-leaf update sliced (the rank's slice of two
    updates of the whole leaf, the gradient's gather stood in for;
    tests/test_torch_port_sliced_updates.py gathers over real ranks); LoRA+
    and BAdam run elementwise on the slices; DoRA on an FSDP slice computes
    its scale in the layer, from the kernel gathered there, as one process
    does; pipeline_stages > 1
    with LoRA raises JAX's ValueError (a pipeline trains full finetuning
    only); model_parallel 2 in a world of one process raises for the world
    (tensor parallelism needs data x model ranks)."""
    import infinitevl_tpu_torch.train.trainer as ttrainer
    from infinitevl_tpu_torch.hparams import parse_args
    from infinitevl_tpu_torch.train.optim import make_custom_optimizer
    from torch_port_helpers import slice_update_err

    info = tsh.ShardInfo(0, 32, 2, 1)
    for name, kw in (("galore", dict(rank=4, update_proj_gap=1, min_dim=8)),
                     ("apollo", dict(rank=4)), ("adam_mini", dict(head_dim=16))):
        err, whole = slice_update_err(name, "_ivl_shard", info, monkeypatch, kw)
        assert err == 0.0 and whole == (32, 64), (name, err)
    shard = torch.zeros(4, 32, requires_grad=True)
    shard._ivl_shard = tsh.ShardInfo(0, 8, 2, 0)
    for name in ("loraplus", "badam"):  # elementwise on the slices
        assert make_custom_optimizer(name, 1e-3).init({"text": {"w": shard}})["count"] == 0
    # DoRA on an FSDP slice of its kernel: the node carries m, and the layer,
    # which holds the kernel gathered, computes the one-process output
    from infinitevl_tpu_torch.models.text import _dense
    from infinitevl_tpu_torch.train.lora import attach_lora, init_lora

    gen = torch.Generator().manual_seed(0)
    w = torch.randn(16, 8, generator=gen)
    ad = init_lora({"q_proj": {"kernel": w}}, gen, rank=2, use_dora=True)
    with torch.no_grad():
        ad["q_proj"]["b"].normal_(generator=gen)
    part = w[8:].clone()
    part._ivl_shard = tsh.ShardInfo(0, 16, 2, 1)
    node = attach_lora({"q_proj": {"kernel": part}}, ad, 16.0, 2)["q_proj"]
    assert "dora_m" in node
    x = torch.randn(3, 16, generator=gen)
    one = _dense(x, attach_lora({"q_proj": {"kernel": w}}, ad, 16.0, 2)["q_proj"])
    assert torch.allclose(_dense(x, dict(node, kernel=w)), one, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="finetuning_type: full"):
        ttrainer.run_exp(parse_args(_conf("sft_tiny.yaml", tmp_path, pipeline_stages=2,
                                          finetuning_type="lora")), device="cpu")
    with pytest.raises(ValueError, match="data_parallel x model_parallel is 1 x 2"):
        ttrainer.run_exp(parse_args(_conf("sft_tiny.yaml", tmp_path, model_parallel=2)),
                         device="cpu")


def test_a_failing_rank_fails_the_launch(tmp_path):
    """Rank 0 raises while rank 1 waits in an all_reduce that never
    completes: the launch raises, naming the rank, well inside its
    deadline, and leaves no rank running."""
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 0 of 2 exited"):
        spawn_ranks(ranks.raise_on_rank0, 2, timeout=120.0, workdir=str(tmp_path))
    assert time.monotonic() - t0 < 60
