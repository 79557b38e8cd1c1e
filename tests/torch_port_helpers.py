"""Helpers shared by the tests of the PyTorch port (tests/test_torch_port_*.py)."""

import dataclasses
import os
import tempfile

import pytest


def to_port_config(jcfg):
    """The JAX package's config as the port's own dataclasses."""
    import infinitevl_tpu_torch.config as tconfig

    d = dataclasses.asdict(jcfg)
    return tconfig.InfiniteVLConfig(
        text=tconfig.TextConfig(**d.pop("text")),
        vision=tconfig.VisionConfig(**d.pop("vision")), **d)


def err_ratio(x, ref):
    import numpy as np

    as_np = lambda a: np.asarray(a.detach().numpy() if hasattr(a, "detach") else a,
                                 dtype=np.float64)
    x, ref = as_np(x), as_np(ref)
    return np.abs(x - ref).mean() / (np.abs(ref).mean() + 1e-12)


def jax_adam_state(opt_state):
    """The ScaleByAdamState inside an optax state (chain, MultiSteps)."""
    import jax
    import optax

    is_adam = lambda x: isinstance(x, optax.ScaleByAdamState)
    found = [x for x in jax.tree_util.tree_leaves(opt_state, is_leaf=is_adam) if is_adam(x)]
    assert len(found) == 1, found
    return found[0]


def carry_train_state(tree_jax, opt_state_jax=None, trainable=True):
    """A JAX tree that is being optimised (model params or a LoRA adapter
    tree) and, when given, its optax AdamW state, carried across as numpy:
    returns (port tree with trainable leaves, port optimizer state or None),
    so both sides take the same steps from the same numbers."""
    import jax
    import numpy as np

    from infinitevl_tpu_torch.models.params import (
        adamw_state_from_jax_numpy,
        from_jax_numpy,
    )

    to_np = lambda t: jax.tree.map(np.asarray, t)
    tree = from_jax_numpy(to_np(tree_jax), "cpu", trainable=trainable)
    if opt_state_jax is None:
        return tree, None
    adam = jax_adam_state(opt_state_jax)
    state = adamw_state_from_jax_numpy(tree, to_np(adam.mu), to_np(adam.nu),
                                       int(adam.count), "cpu")
    return tree, state


def tree_err(port_tree, jax_tree):
    """Largest err_ratio over the leaves of a port tree against the JAX
    tree of the same structure (leaves matched by path)."""
    import jax
    import numpy as np

    from infinitevl_tpu_torch.train.step import tree_leaves_with_path

    def jpaths(t, prefix=""):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from jpaths(v, f"{prefix}/{k}" if prefix else str(k))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                yield from jpaths(v, f"{prefix}/{i}" if prefix else str(i))
        elif t is not None:
            yield prefix, np.asarray(t)

    want = dict(jpaths(jax_tree))
    got = dict(tree_leaves_with_path(port_tree))
    assert set(got) == set(want), set(got) ^ set(want)
    return max(err_ratio(got[p], want[p]) if np.abs(want[p]).sum() > 0
               else float(np.abs(got[p].detach().numpy()).max()) for p in want)


def slice_update_err(name, attr, info, monkeypatch, kw=None):
    """The largest difference between two updates of the optimizer `name`
    (train/optim.py, no clip) on one rank's slice of a leaf, tagged
    `attr` = `info` (a parallel/sharding.ShardInfo), and the rank's slice
    of the same updates on the whole leaf, in one process: the gather of
    the whole gradient (`whole_like`) is stood in for by the whole gradient
    itself."""
    import numpy as np
    import torch

    import infinitevl_tpu_torch.train.optim as toptim
    from infinitevl_tpu_torch.parallel import sharding as tsh

    rng = np.random.RandomState(0)
    shape = [32, 64]
    w = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.1)
    grads = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for _ in range(2)]
    kw = dict(grad_clip=None, **(kw or {}))
    monkeypatch.setattr(toptim, "whole_like", tsh.whole_like)
    whole = {"text": {"layers": [{"q_proj": {"kernel": w.clone().requires_grad_(True)}}]}}
    tx = toptim.make_custom_optimizer(name, 1e-2, **kw)
    state = tx.init(whole)
    for g in grads:
        tx.update([g], state, whole)
    n = info.full // info.world
    part = w.narrow(info.dim, info.rank * n, n).clone().requires_grad_(True)
    setattr(part, attr, info)
    sliced = {"text": {"layers": [{"q_proj": {"kernel": part}}]}}
    tx = toptim.make_custom_optimizer(name, 1e-2, **kw)
    state = tx.init(sliced)
    for g in grads:
        monkeypatch.setattr(toptim, "whole_like", lambda m, t, g=g: g.to(m.dtype))
        tx.update([g.narrow(info.dim, info.rank * n, n).clone()], state, sliced)
    want = whole["text"]["layers"][0]["q_proj"]["kernel"].detach()
    want = want.narrow(info.dim, info.rank * n, n)
    assert not torch.equal(want, w.narrow(info.dim, info.rank * n, n))
    return float((part.detach() - want).abs().max()), tsh.whole_shape(part)


def freeze_inv_freq(real):
    """JAX's `_make_tx` factory `real` with rope's inv_freq masked out of the
    optimizer (optax.multi_transform), as the port's full finetuning leaves
    it frozen."""
    import jax
    import optax

    def make_tx(args, steps):
        label = lambda tree: jax.tree_util.tree_map_with_path(  # noqa: E731
            lambda p, _: "frozen" if getattr(p[-1], "key", None) == "inv_freq" else "train",
            tree)
        return optax.multi_transform({"train": real(args, steps),
                                      "frozen": optax.set_to_zero()}, label)

    return make_tx


_CACHE_OPTIONS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
                  "jax_persistent_cache_min_entry_size_bytes")


@pytest.fixture(scope="module", autouse=True)
def jax_compile_cache():
    """JAX's persistent compilation cache while a port test module runs
    (autouse in every module that imports it), in one directory for all the
    run's workers: the port's modules compile many of the same JAX references
    (the tiny model's forwards, steps and gradients), and each is then
    compiled once a run. JAX's settings are restored after the module."""
    import jax
    from jax.experimental.compilation_cache import compilation_cache

    run = os.environ.get("PYTEST_XDIST_TESTRUNUID", str(os.getpid()))
    saved = {name: getattr(jax.config, name) for name in _CACHE_OPTIONS}
    for name, value in zip(_CACHE_OPTIONS, (
            os.path.join(tempfile.gettempdir(), f"ivl_jax_cache_{run}"), 0.0, 0)):
        jax.config.update(name, value)
    compilation_cache.reset_cache()
    yield
    for name, value in saved.items():
        jax.config.update(name, value)
    compilation_cache.reset_cache()
