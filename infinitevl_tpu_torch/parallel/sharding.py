"""Data-parallel and FSDP training over torch.distributed (torch port of the
data axis of infinitevl_tpu/parallel/sharding.py).

One process per rank. Every rank builds the same global batch from the
same seed and trains its own rows of it (`rank_rows`); losses divide by
the count of the GLOBAL batch (`global_sum` of the local count, one
all_reduce), so the gradients summed over the ranks are those of the
global batch's loss and no rank divides twice.

The parameter layout follows JAX's rule table (`param_spec`, copied from
the JAX package with its `_fit` and warn-once fallback):
- `replicated` (and `tp` while `model_parallel` is 1): every leaf whole on
  every rank; the trainable leaves' gradients are summed by all_reduce
  (`sync_gradients`, called by train/step.Optimizer.update);
- `fsdp` (ZeRO-3): each leaf the rules shard over `data` lives on each rank
  as a contiguous slice along that dim (`shard_params`); the optimizer's
  moments are made from the slices and follow them. A layer's full weights
  exist only while it runs: `gather_tree` all-gathers them through an
  autograd Function whose backward reduce-scatters (sums) the gradient into
  the slice. The models call it per layer inside the per-layer checkpoint
  (models/text.py, models/vision.py) and once per forward for the top-level
  leaves (`gather_top`); with no shard in the process both return their
  argument, so the one-process path computes what it computed before.

A shard carries its layout as the tensor attribute `_ivl_shard`
(`ShardInfo`): the optimizer updates leaves in place, so a leaf keeps it
for its life; a clone must copy it (`copy_shard_info`). rope's `inv_freq`
stays whole: a constant of the config that the tied forward reads on
every rank.

The collectives are `all_gather_into_tensor`, `reduce_scatter_tensor` and
`all_reduce` on the tensors' own device: NCCL on CUDA, gloo on the CPU,
and gloo on CUDA tensors too (two ranks sharing one card, where NCCL
refuses a second rank on the same GPU; torch's gloo stages them through
the host itself).

Tensor parallelism (`model_parallel` > 1: the TP rules' model axis, the
decoder state's rules, `hybrid_device_order`) is not ported yet."""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import re
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.checkpoint import tree_map

DATA = "data"
MODEL = "model"

Spec = Tuple[Optional[str], ...]

_distributed_initialized = False


def _tp_later() -> NotImplementedError:
    return NotImplementedError(
        "tensor parallelism (model_parallel > 1: the TP rules' model axis, "
        "state_shardings, hybrid_device_order) is not ported to torch yet")


def maybe_init_distributed(backend: Optional[str] = None, device=None) -> bool:
    """Env-driven bootstrap of the process group, a no-op at world size 1.

    Reads JAX's names: COORDINATOR_ADDRESS, NUM_PROCESSES and PROCESS_ID
    (all three together), or torchrun's MASTER_ADDR [+ MASTER_PORT, default
    1234], WORLD_SIZE and RANK; the first set wins where both are present.
    Above world size 1 it calls `torch.distributed.init_process_group` over
    tcp://<address> on `device` (default cuda:LOCAL_RANK, made current) with
    `backend` (default nccl on a CUDA device, gloo on the CPU). A world
    above 1 whose address or rank is missing raises: nothing falls back to
    one process. Returns True iff the group exists (idempotent)."""
    global _distributed_initialized
    if _distributed_initialized:
        return True
    env = os.environ
    coord, nproc, pid = (env.get("COORDINATOR_ADDRESS"), env.get("NUM_PROCESSES"),
                         env.get("PROCESS_ID"))
    if not coord and env.get("MASTER_ADDR"):
        coord = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '1234')}"
        nproc = nproc or env.get("WORLD_SIZE")
        pid = pid if pid is not None else env.get("RANK")
    world = int(nproc or env.get("WORLD_SIZE") or 1)
    if world <= 1:
        return False
    if not coord or pid is None:
        raise ValueError(
            f"a world of {world} processes needs COORDINATOR_ADDRESS and PROCESS_ID (or "
            "torchrun's MASTER_ADDR and RANK) in the environment; launch with torchrun")
    dev = (torch.device(device) if device is not None
           else torch.device("cuda", int(env.get("LOCAL_RANK", "0"))))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=f"tcp://{coord}", world_size=world, rank=int(pid))
    _distributed_initialized = True
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The world's (data, model) layout; this process is rank `rank`."""

    data: int = 1
    model: int = 1
    rank: int = 0


def create_mesh(data: int = 1, model: int = 1) -> Mesh:
    """The (data, model) mesh over the process group's ranks; the world
    size must be data x model."""
    if model > 1:
        raise _tp_later()
    world = world_size()
    if world != data * model:
        raise ValueError(
            f"the world holds {world} process(es) but data_parallel x model_parallel is "
            f"{data} x {model}: launch data_parallel ranks (torchrun --nproc_per_node "
            f"{data * model}) or set data_parallel to the world size")
    return Mesh(data, model, world_rank())


# ---------------------------------------------------------------- the rules

# (path regex, spec) -- first match wins; JAX's table, axes by name
_COLWISE = (None, MODEL)
_ROWWISE = (MODEL, None)
_RULES: Tuple[Tuple[str, Spec], ...] = (
    # --- text decoder ---
    (r"text/layers/\d+/(q_proj|k_proj|v_proj|a_proj|b_proj|g_proj)/kernel(_q)?", _COLWISE),
    (r"text/layers/\d+/(q_proj|k_proj|v_proj|a_proj|b_proj|g_proj)/scale", (MODEL,)),
    (r"text/layers/\d+/(q_proj|k_proj|v_proj)/bias", (MODEL,)),
    (r"text/layers/\d+/o_proj/kernel(_q)?", _ROWWISE),
    (r"text/layers/\d+/mlp/(gate|up)/kernel(_q)?", _COLWISE),
    (r"text/layers/\d+/mlp/(gate|up)/scale", (MODEL,)),
    (r"text/layers/\d+/mlp/down/kernel(_q)?", _ROWWISE),
    (r"text/layers/\d+/conv_[qkv]_w", (None, MODEL)),
    (r"text/layers/\d+/conv_[qkv]_b", (MODEL,)),
    (r"text/layers/\d+/(A_log|dt_bias)", (MODEL,)),
    (r"text/embed", (None, MODEL)),
    (r"text/lm_head", _ROWWISE),
    # --- vision ---
    (r"visual/blocks/\d+/qkv/kernel(_q)?", _COLWISE),
    (r"visual/blocks/\d+/qkv/(bias|scale)", (MODEL,)),
    (r"visual/blocks/\d+/proj/kernel(_q)?", _ROWWISE),
    (r"visual/blocks/\d+/mlp/(gate|up)/kernel(_q)?", _COLWISE),
    (r"visual/blocks/\d+/mlp/(gate|up)/(bias|scale)", (MODEL,)),
    (r"visual/blocks/\d+/mlp/down/kernel(_q)?", _ROWWISE),
    (r"visual/patch_embed", (None, MODEL)),
    (r"visual/merger/fc1/kernel", _COLWISE),
    (r"visual/merger/fc1/bias", (MODEL,)),
    (r"visual/merger/fc2/kernel", _ROWWISE),
)

_FIT_WARNED: set = set()


def _match(path: str) -> Optional[Spec]:
    for pat, spec in _RULES:
        if re.fullmatch(pat, path):
            return spec
    return None


def _fit(spec: Spec, shape: Sequence[int], axes: Dict[str, int]) -> Spec:
    """Drop the sharded axes that do not divide their dimension."""
    if len(spec) > len(shape):
        return ()
    padded = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(ax if ax is None or dim % axes[ax] == 0 else None
                 for dim, ax in zip(shape, padded))


def param_spec(path: str, shape: Sequence[int], data: int = 1, model: int = 1,
               param_mode: str = "tp") -> Spec:
    """The mesh axis (DATA, MODEL or None) of each dim of the leaf at `path`
    (`text/layers/3/q_proj/kernel`), as JAX's param_spec gives it on a
    (data, model) mesh, padded with None to the leaf's rank:
    - "tp": the rule table's model axis only;
    - "fsdp": besides, the largest dim still free that `data` divides goes
      on the data axis (ZeRO-3);
    - "replicated": nothing sharded.
    A rule that does not divide its dim falls back to replication there,
    with one warning per distinct (layer-number-erased) path."""
    shape = tuple(int(s) for s in shape)
    axes = {DATA: data, MODEL: model}
    spec = _match(path) if param_mode != "replicated" else None
    spec = spec if spec is not None else ()
    fitted = _fit(spec, shape, axes)
    if tuple(a for a in fitted if a is not None) != tuple(a for a in spec if a is not None):
        key = (re.sub(r"\d+", "#", path), spec, shape)
        if key not in _FIT_WARNED:
            _FIT_WARNED.add(key)
            logging.getLogger(__name__).warning(
                "sharding rule %s does not divide %s for %s; falling back to %s "
                "(replicated on the dropped axes)", spec, shape, path, fitted)
    dims = list(fitted) + [None] * (len(shape) - len(fitted))
    if param_mode == "fsdp" and data > 1 and len(shape) >= 1 and DATA not in dims:
        for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
            if dims[i] is None and shape[i] % data == 0:
                dims[i] = DATA
                break
    return tuple(dims)


# ---------------------------------------------------------------- the run's mesh

_ACTIVE: Optional[Mesh] = None
_SPLIT_BATCH = True
_SHARDED = False  # set once this process holds a shard: the gathers' fast path


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Run the enclosed training under `mesh` (None: one process, no-op)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, mesh
    try:
        yield mesh
    finally:
        _ACTIVE = prev


@contextlib.contextmanager
def whole_batch():
    """Every rank holds the whole batch in the enclosed code (the eval
    pass): counts are not summed over the ranks."""
    global _SPLIT_BATCH
    prev, _SPLIT_BATCH = _SPLIT_BATCH, False
    try:
        yield
    finally:
        _SPLIT_BATCH = prev


def data_parallel() -> bool:
    """True where the batch's rows are split over more than one rank."""
    return _ACTIVE is not None and _ACTIVE.data > 1 and _SPLIT_BATCH


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """A detached copy of `x` summed over every rank (one all_reduce)."""
    y = x.detach().contiguous().clone()
    dist.all_reduce(y)
    return y


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """A count (or any non-differentiated value) summed over the data ranks:
    one all_reduce; `x` itself where the batch is not split."""
    return all_reduce_sum(x) if data_parallel() else x


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of `x` over the global batch's elements (x.mean() on one
    rank): this rank's sum over the global count."""
    if not data_parallel():
        return x.mean()
    return x.sum() / global_sum(torch.tensor(float(x.numel()), device=x.device))


# ---------------------------------------------------------------- collectives

# torch renames the two collectives (the old names warn from 2.13 on)
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _gather_raw(shard: torch.Tensor, info: "ShardInfo") -> torch.Tensor:
    x = (shard if info.dim == 0 else shard.movedim(info.dim, 0)).contiguous()
    out = x.new_empty((x.shape[0] * info.world,) + tuple(x.shape[1:]))
    _all_gather(out, x)
    return out if info.dim == 0 else out.movedim(0, info.dim).contiguous()


def _reduce_scatter_raw(grad: torch.Tensor, info: "ShardInfo") -> torch.Tensor:
    x = (grad if info.dim == 0 else grad.movedim(info.dim, 0)).contiguous()
    out = x.new_empty((x.shape[0] // info.world,) + tuple(x.shape[1:]))
    _reduce_scatter(out, x)
    return out if info.dim == 0 else out.movedim(0, info.dim).contiguous()


@dataclasses.dataclass(frozen=True)
class ShardInfo:
    """A leaf's slice on this rank: `full` entries along `dim` over `world`
    ranks, this rank's starting at rank x full / world."""

    dim: int
    full: int
    world: int
    rank: int


def shard_info(t: torch.Tensor) -> Optional[ShardInfo]:
    return getattr(t, "_ivl_shard", None)


def copy_shard_info(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    info = shard_info(src)
    if info is not None:
        dst._ivl_shard = info
    return dst


class _GatherShard(torch.autograd.Function):
    """Forward: the full leaf from every rank's slice (all_gather). Backward:
    the full gradient summed over the ranks, this rank's slice kept
    (reduce_scatter). The losses are already over the global count, so the
    sum is the global batch's gradient."""

    @staticmethod
    def forward(ctx, shard, info):
        ctx.info = info
        return _gather_raw(shard, info)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter_raw(grad, ctx.info), None


def gather_leaf(t: torch.Tensor) -> torch.Tensor:
    info = shard_info(t)
    if info is None:
        return t
    if t.requires_grad and torch.is_grad_enabled():
        return _GatherShard.apply(t, info)
    with torch.no_grad():
        return _gather_raw(t, info)


def gather_tree(tree, memo: Optional[Dict[int, torch.Tensor]] = None):
    """The tree with every shard replaced by its full leaf (differentiable in
    the shard), a shard reached twice (a teacher's leaf its student shares)
    gathered once; the tree itself where this process holds no shard."""
    if not _SHARDED:
        return tree
    memo = {} if memo is None else memo
    if isinstance(tree, dict):
        return {k: gather_tree(v, memo) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_tree(v, memo) for v in tree)
    if isinstance(tree, torch.Tensor):
        if id(tree) not in memo:
            memo[id(tree)] = gather_leaf(tree)
        return memo[id(tree)]
    return tree


_PER_UNIT = ("layers", "blocks", "layer_stacks")


def gather_top(tree):
    """A text or vision tree with its top-level leaves gathered (embed and
    the tied head, the final norm, the patch embedding, the merger); the
    layers and blocks stay sharded, each gathered where it runs."""
    if not _SHARDED or not isinstance(tree, dict):
        return tree
    return {k: v if k in _PER_UNIT else gather_tree(v) for k, v in tree.items()}


@torch.no_grad()
def gather_full(tree):
    """A copy of the tree with every leaf whole and detached (for saving and
    export): every rank must call it, each gets the full tree. The tree
    itself where this process holds no shard."""
    if not _SHARDED:
        return tree
    return tree_map(lambda t: gather_leaf(t).detach() if shard_info(t) else t, tree)


# ---------------------------------------------------------------- sharding

_WHOLE = ("inv_freq",)


def _path(prefix: str, key) -> str:
    return f"{prefix}/{key}" if prefix else str(key)


def shard_params(tree, mesh: Optional[Mesh], param_mode: str = "fsdp",
                 memo: Optional[Dict[int, Any]] = None, prefix: str = ""):
    """The tree with each leaf that `param_spec` shards over `data` replaced
    by this rank's contiguous slice along that dim (trainable where the leaf
    was); other leaves are kept as they are. New containers, the leaves'
    tensors shared where whole. A leaf reached twice, in this tree or in
    another sharded with the same `memo` (a student sharing its teacher's
    tensors), becomes ONE shard. Without a mesh, or at one data rank, or
    under `replicated` / `tp`, the tree itself."""
    global _SHARDED
    if mesh is None or mesh.data <= 1 or param_mode not in ("fsdp",):
        if param_mode not in ("fsdp", "tp", "replicated"):
            raise ValueError(f"unknown param_mode {param_mode!r} (tp | fsdp | replicated)")
        return tree
    memo = {} if memo is None else memo
    if isinstance(tree, dict):
        return {k: shard_params(v, mesh, param_mode, memo, _path(prefix, k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_params(v, mesh, param_mode, memo, _path(prefix, i))
                          for i, v in enumerate(tree))
    if not isinstance(tree, torch.Tensor):
        return tree
    if id(tree) in memo:
        return memo[id(tree)][1]
    spec = param_spec(prefix, tree.shape, mesh.data, mesh.model, param_mode)
    out = tree
    if DATA in spec and prefix.rsplit("/", 1)[-1] not in _WHOLE:
        dim = spec.index(DATA)
        n = tree.shape[dim] // mesh.data
        out = tree.detach().narrow(dim, mesh.rank * n, n).clone(
            memory_format=torch.contiguous_format)
        out.requires_grad_(tree.requires_grad)
        out._ivl_shard = ShardInfo(dim, int(tree.shape[dim]), mesh.data, mesh.rank)
        _SHARDED = True
    memo[id(tree)] = (tree, out)  # the source kept alive: ids stay unique
    return out


def local_bytes(tree) -> Tuple[int, int]:
    """(bytes this rank holds, bytes of the same leaves whole) over the
    sharded leaves of `tree`, each tensor counted once."""
    seen, held, whole = set(), 0, 0
    for t in _tensors(tree):
        info = shard_info(t)
        if info is None or id(t) in seen:
            continue
        seen.add(id(t))
        held += t.numel() * t.element_size()
        whole += t.numel() // t.shape[info.dim] * info.full * t.element_size()
    return held, whole


def _tensors(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


# ---------------------------------------------------------------- gradients

def sync_gradients(leaves: Sequence[torch.Tensor], grads: List[torch.Tensor]
                   ) -> List[torch.Tensor]:
    """The gradients of the global batch: each replicated leaf's summed over
    the data ranks (one all_reduce a leaf); a shard's is already summed (its
    gather's backward). Unchanged where the batch is not split."""
    if not data_parallel():
        return grads
    out = []
    for t, g in zip(leaves, grads):
        out.append(all_reduce_sum(g) if shard_info(t) is None else g)
    return out


def grad_sq_norm(leaves: Sequence[torch.Tensor], grads) -> torch.Tensor:
    """The squared global norm of the gradients: the shards' sums of squares
    summed over the ranks (one all_reduce), each replicated leaf counted
    once."""
    sharded = [g for t, g in zip(leaves, grads) if shard_info(t) is not None]
    whole = [g for t, g in zip(leaves, grads) if shard_info(t) is None]
    total = sum((g.float() ** 2).sum() for g in whole) if whole else None
    if sharded:  # every rank shards the same leaves: all or none of them reduce
        part = all_reduce_sum(sum((g.float() ** 2).sum() for g in sharded))
        total = part if total is None else total + part
    return total


# ---------------------------------------------------------------- batches

def rank_rows(batch: Dict[str, Any], mesh: Optional[Mesh]) -> Dict[str, Any]:
    """This rank's rows of a global text batch: rows [r B/n, (r+1) B/n) of
    every per-row array (position_ids along its dim 1), `_n_tokens`
    recounted from the rows' segment ids. The batch itself without a mesh."""
    if mesh is None or mesh.data <= 1:
        return batch
    B = batch["input_ids"].shape[0] if "input_ids" in batch else None
    if B is None:
        raise ValueError("rank_rows needs the batch's input_ids")
    if B % mesh.data:
        raise ValueError(f"global batch of {B} rows over {mesh.data} data ranks")
    n = B // mesh.data
    rows = slice(mesh.rank * n, (mesh.rank + 1) * n)
    out = {}
    for k, v in batch.items():
        if k == "position_ids":
            out[k] = v[:, rows]
        elif k in ("pixel_values", "pixel_values_videos"):
            raise ValueError(f"{k}: split a multimodal batch with rank_rows_mm")
        elif isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim >= 1 and v.shape[0] == B:
            out[k] = v[rows]
        else:
            out[k] = v
    if "segment_ids" in out and "_n_tokens" in batch:
        out["_n_tokens"] = np.int64((np.asarray(out["segment_ids"]) > 0).sum())
    return out


def rank_rows_mm(item: tuple, mesh: Optional[Mesh], cfg) -> tuple:
    """This rank's rows of a multimodal (batch, image_grids, video_grids):
    the text rows as `rank_rows`; the packed pixels and the grids stay
    whole, as JAX replicates them, so every rank runs the same ViT (the
    same gathers, in the same order, where its weights are sharded), and
    `image_rows` / `video_rows` name the slice of the ViT's features whose
    placeholder tokens lie in this rank's rows (the collator packs them in
    row order)."""
    if mesh is None or mesh.data <= 1:
        return item
    batch, grids = item[0], item[1:]
    ids = np.asarray(batch["input_ids"])
    n = ids.shape[0] // mesh.data
    lo, hi = mesh.rank * n, (mesh.rank + 1) * n
    out = rank_rows({k: v for k, v in batch.items()
                     if k not in ("pixel_values", "pixel_values_videos")}, mesh)
    for key, rows, token in (("pixel_values", "image_rows", cfg.image_token_id),
                             ("pixel_values_videos", "video_rows", cfg.video_token_id)):
        if key in batch:
            per_row = (ids == token).sum(axis=1)
            out[key] = batch[key]
            out[rows] = (int(per_row[:lo].sum()), int(per_row[:hi].sum()))
    return (out, *grids)


# ---------------------------------------------------------------- optimizer state

_PER_LEAF_KEYS = ("mu", "nu", "m", "v", "acc")


def _per_leaf(state: Dict[str, Any], n: int):
    for k, v in state.items():
        if k in _PER_LEAF_KEYS and isinstance(v, list) and len(v) == n:
            yield k, v


@torch.no_grad()
def gather_opt_state(state: Dict[str, Any], leaves: Sequence[torch.Tensor],
                     keys: Sequence[str] = _PER_LEAF_KEYS) -> Dict[str, Any]:
    """The optimizer state with each per-leaf moment (of `keys`) of a
    sharded leaf made whole (the one-process format); every rank must call
    it."""
    out = dict(state)
    for k, v in _per_leaf(state, len(leaves)):
        if k not in keys:
            continue
        out[k] = [_gather_raw(m, shard_info(t)) if shard_info(t) is not None else m
                  for m, t in zip(v, leaves)]
    return out


def _slice_for(full: torch.Tensor, t: torch.Tensor, info: Optional[ShardInfo]) -> torch.Tensor:
    if info is not None and tuple(full.shape) != tuple(t.shape):
        n = t.shape[info.dim]
        full = full.narrow(info.dim, info.rank * n, n)
    if tuple(full.shape) != tuple(t.shape):
        raise ValueError(f"a saved leaf of shape {tuple(full.shape)} for one of "
                         f"{tuple(t.shape)}")
    return full


@torch.no_grad()
def load_into(dst, src) -> None:
    """Copy a one-process tree (`src`, whole leaves) into `dst` in place:
    a sharded leaf takes its rank's slice, a whole one the whole leaf."""
    if isinstance(dst, dict):
        for k, v in dst.items():
            load_into(v, src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            load_into(d, s)
    elif isinstance(dst, torch.Tensor):
        dst.copy_(_slice_for(src, dst, shard_info(dst)))


@torch.no_grad()
def load_opt_state(dst: Dict[str, Any], src: Dict[str, Any],
                   leaves: Sequence[torch.Tensor]) -> None:
    """Copy a one-process optimizer state into `dst` in place, each per-leaf
    moment of a sharded leaf cut to the rank's slice."""
    per = dict(_per_leaf(dst, len(leaves)))
    for k, v in src.items():
        if k in per:
            for m, s, t in zip(per[k], v, leaves):
                m.copy_(_slice_for(s, m, shard_info(t)))
        elif isinstance(dst.get(k), (dict, list, tuple, torch.Tensor)):
            load_into(dst[k], v)
        else:
            dst[k] = v


def refuse_whole_leaf_optimizer(name: str, leaves: Sequence[torch.Tensor]) -> None:
    """Optimizers whose update reads a whole leaf (an SVD, a projection, a
    per-head block mean) raise under fsdp where a trainable leaf is a shard."""
    if any(shard_info(t) is not None for t in leaves):
        raise NotImplementedError(
            f"use_optimizer: {name} under param_mode fsdp (its update needs each whole "
            "leaf) is not ported to torch yet; use param_mode: replicated")
