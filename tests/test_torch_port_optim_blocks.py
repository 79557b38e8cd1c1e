"""BAdam and each leaf's treatment by the custom optimizers, against the JAX
package on the CPU: BAdam's steps against JAX's with the inactive blocks
bit-unchanged, and on the tiny model's own trees each leaf's block / rule /
label / low-rank treatment as JAX gives it."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from test_torch_port_optim import CLIP, TOL, _jax_paths, _jchain, _run_both, _tree
from torch_port_helpers import jax_compile_cache  # noqa: F401 (autouse)

import infinitevl_tpu.train.optim as joptim
import infinitevl_tpu_torch.train.optim as toptim
from infinitevl_tpu.config import tiny_config
from infinitevl_tpu.models.params import init_params
from infinitevl_tpu.parallel.sharding import _path_str
from infinitevl_tpu.train.lora import init_lora
from infinitevl_tpu_torch.models.params import from_jax_numpy
from infinitevl_tpu_torch.train.step import tree_leaves_with_path

torch.set_num_threads(2)


def _model_trees():
    """The tiny model's text tree and its LoRA adapter tree, as JAX makes
    them, with the port's copies."""
    jp = init_params(jax.random.PRNGKey(0), tiny_config(), jnp.float32)
    text = {"text": jp["text"]}
    lora = init_lora(text, jax.random.PRNGKey(1), rank=4)
    return text, lora


def test_badam_matches_jax_and_leaves_inactive_blocks_bit_unchanged():
    """BAdam, 2 blocks switching every 2 steps, over 6 steps (blocks 0, 1,
    0): parity, and after the first two steps every leaf of block 1 (odd
    layers, and the embedding, norms outside the layers) bit-unchanged."""
    tree = _tree()
    kw = dict(num_blocks=2, switch_interval=2)
    errs, _, _, _ = _run_both(_jchain(joptim.badam(1e-2, **kw)),
                           toptim.BAdam(1e-2, grad_clip=CLIP, **kw), tree, 6)
    assert max(errs) <= TOL, errs
    _, _, tp, _ = _run_both(_jchain(joptim.badam(1e-2, **kw)),
                         toptim.BAdam(1e-2, grad_clip=CLIP, **kw), tree, 2)
    before = dict(tree_leaves_with_path(from_jax_numpy(tree, "cpu")))
    for path, t in tree_leaves_with_path(tp):
        moved = not torch.equal(t.detach(), before[path])
        assert moved == (toptim.badam_block(path, 2) == 0), path


def test_each_leaf_gets_jax_block_rule_label_and_treatment():
    """On the tiny model's own trees, leaf by leaf: BAdam's block (read
    from which leaves JAX's first update moves), Adam-mini's rule (the
    shape of JAX's second moment), LoRA+'s label (JAX's inner state per
    group), and GaLore's / APOLLO's low-rank treatment (their state's
    shapes) are the port's."""
    text, lora = _model_trees()
    ones = jax.tree.map(jnp.ones_like, text)
    paths = _jax_paths(text)
    port_text = from_jax_numpy(jax.tree.map(np.asarray, text), "cpu")
    assert {p for p, _ in tree_leaves_with_path(port_text)} == set(paths)
    # BAdam, 4 blocks: the leaves JAX moves at step 1 are block 0
    upd, _ = joptim.badam(1e-2, num_blocks=4).update(ones, joptim.badam(1e-2).init(text), text)
    moved = {p: bool(np.abs(np.asarray(u)).sum() > 0)
             for p, u in zip(paths, jax.tree.leaves(upd))}
    assert any(moved.values()) and not all(moved.values())
    for path in paths:
        assert moved[path] == (toptim.badam_block(path, 4) == 0), path
    # Adam-mini: per coordinate keeps the leaf's shape, per head [heads], per column [d_out]
    v = joptim.adam_mini(1e-2).init(text)["v"]
    for (path, x), vs in zip(jax.tree_util.tree_flatten_with_path(text)[0], jax.tree.leaves(v)):
        rule = toptim.adam_mini_rule(_path_str(path), torch.zeros(x.shape))
        want = {toptim.PER_COORD: x.shape, toptim.PER_HEAD: (x.shape[-1] // 128,),
                toptim.PER_COL: (x.shape[-1],)}[rule]
        assert tuple(vs.shape) == tuple(want), _path_str(path)
    # LoRA+: the leaves of group 'b' in JAX's multi_transform state
    st = joptim.loraplus(1e-2).init(lora)
    b_state = st.inner_states["b"].inner_state[0].mu
    for (path, _), mu in zip(jax.tree_util.tree_flatten_with_path(lora)[0],
                             jax.tree.leaves(b_state, is_leaf=lambda x: x is None
                                             or isinstance(x, optax.MaskedNode))):
        want = "a" if isinstance(mu, optax.MaskedNode) else "b"
        assert toptim.loraplus_label(_path_str(path)) == want, _path_str(path)
    # GaLore (rank 8) and APOLLO: which leaves are low-rank
    gal = toptim.GaLore(1e-2)
    apo = toptim.Apollo(1e-2)
    jg = joptim.galore(1e-2).init(text)["leaves"]
    ja = joptim.apollo(1e-2).init(text)["mv"]
    is_tuple = lambda x: isinstance(x, tuple)  # noqa: E731
    for x, g_st, a_st in zip(jax.tree.leaves(text), jax.tree.leaves(jg, is_leaf=is_tuple),
                             jax.tree.leaves(ja, is_leaf=is_tuple)):
        t = torch.zeros(x.shape)
        assert gal.is_galore(t) == (len(g_st) == 3)
        assert apo.is_low_rank(t) == (tuple(a_st[0].shape) != tuple(x.shape))
