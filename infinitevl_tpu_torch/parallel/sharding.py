"""Data parallelism, FSDP and tensor parallelism over torch.distributed
(torch port of infinitevl_tpu/parallel/sharding.py).

One process per rank. The world is a (data, model) mesh: rank r sits at
(r // model, r % model), the model axis innermost, as JAX reshapes its
devices (`create_mesh`; `create_hybrid_mesh` keeps each model group
inside one node). Each data row of the mesh is a model group and each
model column a data group, every one a process group of its own. A
pipelined run (parallel/pipeline.py) puts a pipe axis outermost
(`create_pp_mesh`): rank r is stage r // (data x model), and each stage
keeps the (data, model) groups over its own ranks; one pipe group a
(data, model) position joins the stages (the replicated leaves'
gradients are summed there), and a two-rank group per pair of adjacent
stages carries the activations and their gradients (`pipe_handoff`).

Every rank builds the same global batch from the same seed and trains the
rows of its DATA coordinate (`rank_rows`): the ranks of one model group
hold the same rows. Losses divide by the count of the GLOBAL batch
(`global_sum` of the local count over the data group), so the gradients
summed over the data group are those of the global batch's loss.

The parameter layout follows JAX's rule table (`param_spec`, copied from
the JAX package with its `_fit` and warn-once fallback). A leaf the rules
shard holds on each rank the contiguous slice of its coordinate along the
sharded dim (`shard_params`), tagged with its layout (`ShardInfo`):
- the model axis (`tp`, and `fsdp`, at model_parallel > 1; tag `_ivl_tp`)
  is explicit Megatron-style tensor parallelism. The slices stay slices:
  the forwards of models/text.py and models/vision.py compute with them
  and place the collectives themselves, over the model group, as
  autograd Functions: `tp_copy` (identity forward, all_reduce backward)
  where a replicated input enters column-parallel kernels, `tp_sum`
  (all_reduce forward, identity backward) after a row-parallel kernel's
  partial output, `tp_gather` (all_gather forward; slice or
  reduce_scatter backward) where a rule cuts a dim the next op needs whole
  (the embedding's D, a fused qkv whose split cuts a head). The hidden
  state is whole on every rank between blocks. A replicated leaf read
  inside a head-parallel region (a LoRA factor on a sharded kernel, the
  DeltaNet's per-head gated norm) goes through `tp_copy` too, so its
  gradient arrives summed over the model group;
- the data axis (`fsdp`; tag `_ivl_shard`) is ZeRO-3: a layer's full
  weights (over data) exist only while it runs: `gather_tree` all-gathers
  them through an autograd Function whose backward reduce-scatters (sums)
  the gradient into the slice. The models call it per layer inside the
  per-layer checkpoint and once per forward for the top-level leaves
  (`gather_top`); a gathered leaf keeps its model-axis tag. With no shard
  in the process both return their argument, so the one-process path
  computes what it computed before.
Under `replicated` every leaf is whole on every rank; the trainable leaves'
gradients are summed over the data group (`sync_gradients`, called by
train/step.Optimizer.update); so are a model-axis slice's (its data group
holds the same slice). The global gradient norm sums the slices' squares
over their axes' groups and counts a replicated leaf once (`grad_sq_norm`).

The optimizer updates leaves in place, so a leaf keeps its tags for its
life; a clone must copy them (`copy_shard_info`). rope's `inv_freq` stays
whole: a constant of the config that the forward reads on every rank.

The decoder state follows `_STATE_RULES` (`shard_state`, `gather_state`;
`models/state.init_decoder_state(mesh=...)` makes the local state): batch
rows on data, heads on model. JAX's rule for the SWA rings names dim 3,
which in the head-major [S, B, Hkv, cap, Dh] layout is the ring's
capacity (GSPMD's numbers do not depend on it); the port shards Hkv, the
dim its comment names and the one the attention kernels read per rank,
and where Hkv does not divide over the model axis each rank holds the KV
heads its query heads read (`kv_head_range`). JAX's table names neither
Mamba2 key, so JAX holds both whole; a rank of the port holds its heads of
`mamba_h` and, of `mamba_conv`'s [v | k | q] channels, its heads' columns
of each third (the layout differs, the numbers do not: `gather_state`
gives JAX's whole state).

The collectives are `all_gather_into_tensor`, `reduce_scatter_tensor` and
`all_reduce` on the tensors' own device: NCCL on CUDA, gloo on the CPU,
and gloo on CUDA tensors too (ranks sharing one card, where NCCL refuses a
second rank on the same GPU; torch's gloo stages them through the host
itself)."""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
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
PIPE = "pipe"

Spec = Tuple[Optional[str], ...]

_distributed_initialized = False


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


# ---------------------------------------------------------------- the mesh

@dataclasses.dataclass(frozen=True)
class Mesh:
    """The world's (data, model) layout; this process is world rank `rank`.
    `order[d][m]` is the world rank at mesh position (d, m); None is the
    row-major order of `create_mesh` (rank d x model + m). With `pipe` > 1
    (`create_pp_mesh`) the (data, model) layout repeats once a stage, the
    pipe axis outermost: rank p x data x model + d x model + m."""

    data: int = 1
    model: int = 1
    rank: int = 0
    order: Optional[Tuple[Tuple[int, ...], ...]] = None
    pipe: int = 1

    @property
    def pipe_rank(self) -> int:
        """This rank's stage (its coordinate on the pipe axis)."""
        return self.rank // (self.data * self.model)

    def pipe_ranks(self) -> Tuple[int, ...]:
        """The world ranks of this rank's (data, model) position, stage by stage."""
        n = self.data * self.model
        return tuple(p * n + self.rank % n for p in range(self.pipe))

    def _position(self) -> Tuple[int, int]:
        if self.order is None:
            return divmod(self.rank % (self.data * self.model), self.model)
        for d, row in enumerate(self.order):
            if self.rank in row:
                return d, row.index(self.rank)
        raise ValueError(f"rank {self.rank} is not in the mesh {self.order}")

    @property
    def data_rank(self) -> int:
        """This rank's place in its data group (torch.distributed orders a
        group's ranks ascending; the data coordinate of `create_mesh`)."""
        m = self._position()[1]
        return sorted(row[m] for row in self.rows()).index(self.rank)

    @property
    def model_rank(self) -> int:
        """This rank's place in its model group (its model coordinate)."""
        return sorted(self.rows()[self._position()[0]]).index(self.rank)

    def rows(self) -> Tuple[Tuple[int, ...], ...]:
        """order[d][m], the row-major order of this rank's stage where none
        was given."""
        base = self.pipe_rank * self.data * self.model
        return self.order or tuple(tuple(base + d * self.model + m for m in range(self.model))
                                   for d in range(self.data))


# the process groups of this process's data column, model row and pipe
# column (None: the whole world), the axes' sizes (None: no mesh made, the
# world), and the two-rank groups of this process's adjacent stages
# (_PAIRS[s]: stages s and s + 1)
_GROUPS: Dict[str, Any] = {DATA: None, MODEL: None, PIPE: None}
_AXIS_SIZE: Dict[str, Optional[int]] = {DATA: None, MODEL: None, PIPE: None}
_PAIRS: Dict[int, Any] = {}
_MODEL_RANK = 0


def _make_groups(mesh: Mesh) -> None:
    """One process group per model row and one per data column (of every
    stage), and with a pipe axis one per pipe column and per pair of
    adjacent stages in it, every rank creating every group in the same
    order (torch.distributed's rule). An axis that spans the whole world
    uses the default group."""
    global _MODEL_RANK
    _GROUPS[DATA] = _GROUPS[MODEL] = _GROUPS[PIPE] = None
    _PAIRS.clear()
    _AXIS_SIZE[DATA], _AXIS_SIZE[MODEL], _AXIS_SIZE[PIPE] = mesh.data, mesh.model, mesh.pipe
    _MODEL_RANK = mesh.model_rank
    n = mesh.data * mesh.model
    for p in range(mesh.pipe):
        rows = dataclasses.replace(mesh, rank=p * n).rows()
        if mesh.model > 1 and (mesh.data > 1 or mesh.pipe > 1):
            for row in rows:
                g = dist.new_group(sorted(row))
                if mesh.rank in row:
                    _GROUPS[MODEL] = g
        if mesh.data > 1 and (mesh.model > 1 or mesh.pipe > 1):
            for m in range(mesh.model):
                col = sorted(row[m] for row in rows)
                g = dist.new_group(col)
                if mesh.rank in col:
                    _GROUPS[DATA] = g
    if mesh.pipe > 1:
        for pos in range(n):
            col = [p * n + pos for p in range(mesh.pipe)]
            if n > 1:
                g = dist.new_group(col)
                if mesh.rank in col:
                    _GROUPS[PIPE] = g
            for p in range(mesh.pipe - 1):
                g = dist.new_group(col[p : p + 2])
                if mesh.rank in col:
                    _PAIRS[p] = g


def _check_world(data: int, model: int) -> int:
    world = world_size()
    if world != data * model:
        raise ValueError(
            f"the world holds {world} process(es) but data_parallel x model_parallel is "
            f"{data} x {model}: launch data_parallel x model_parallel ranks (torchrun "
            f"--nproc_per_node {data * model}) or set them to the world size")
    return world


def create_mesh(data: int = 1, model: int = 1) -> Mesh:
    """The (data, model) mesh over the process group's ranks, the model
    axis innermost (rank r at (r // model, r % model), as JAX reshapes its
    devices); the world size must be data x model. Makes the mesh's process
    groups (collective: every rank calls it)."""
    _check_world(data, model)
    mesh = Mesh(data, model, world_rank())
    _make_groups(mesh)
    return mesh


def create_pp_mesh(pipe: int, data: int = 1, model: int = 1) -> Mesh:
    """The (pipe, data, model) mesh of a pipelined run, the pipe axis
    outermost as JAX's create_pp_mesh lays out its devices: rank r runs
    stage r // (data x model) at the (data, model) position of r within
    its stage. The world size must be pipe x data x model. Makes the
    mesh's process groups (collective: every rank calls it)."""
    n, world = pipe * data * model, world_size()
    if world != n:
        raise ValueError(f"need {n} ranks (pipe x data x model = {pipe} x {data} x {model}), "
                         f"have {world}")
    mesh = Mesh(data, model, world_rank(), pipe=pipe)
    _make_groups(mesh)
    return mesh


def pipe_handoff(x: torch.Tensor, pair: int, src: int) -> torch.Tensor:
    """Stage `src` (`pair` or `pair` + 1) hands `x` to the other stage of
    the pair: one broadcast in the pair's two-rank group; on the receiving
    rank `x` is a buffer of the right shape, filled and returned. Every
    backend takes it as it is: gloo's send / recv take CPU tensors only,
    its broadcast CUDA tensors too (staged through the host by gloo
    itself), which ranks sharing one card need, and NCCL's broadcast runs
    between cards."""
    x = x.detach().contiguous()
    dist.broadcast(x, src=_ACTIVE.pipe_ranks()[src], group=_PAIRS[pair])
    return x


def pipe_broadcast(x: torch.Tensor, stage: int) -> torch.Tensor:
    """`x` from stage `stage` to every stage of this rank's pipe group (one
    broadcast; elsewhere `x` is a buffer, filled and returned)."""
    dist.broadcast(x, src=_ACTIVE.pipe_ranks()[stage], group=_GROUPS[PIPE])
    return x


def hybrid_device_order(devices, data: int, model: int):
    """Device layout for a multi-slice (multi-node) topology, JAX's rule:
    the model axis (a collective in every layer) stays INSIDE a slice; the
    data axis (one gradient reduction a step) is the only one allowed to
    cross slices. Devices (objects with `slice_index` and `id`) are grouped
    by slice_index; each slice contributes whole model groups; the data
    axis is slice-major. Returns a [data, model] object array; raises where
    the model axis would straddle slices."""
    devices = list(devices)
    if data * model != len(devices):
        raise ValueError(f"need {data * model} devices, have {len(devices)}")
    slices: dict = {}
    for d in devices:
        slices.setdefault(getattr(d, "slice_index", 0), []).append(d)
    if len(slices) == 1:
        return np.asarray(devices, dtype=object).reshape(data, model)
    rows = []
    for sidx in sorted(slices):
        devs = sorted(slices[sidx], key=lambda d: getattr(d, "id", 0))
        if len(devs) % model:
            raise ValueError(
                f"slice {sidx} has {len(devs)} devices, not a multiple of "
                f"model={model}: the model axis would cross the DCN boundary")
        rows.extend(devs[i : i + model] for i in range(0, len(devs), model))
    if len(rows) != data:
        raise ValueError(f"slices supply {len(rows)} data rows, expected data={data}")
    out = np.empty((len(rows), model), dtype=object)
    for i, row in enumerate(rows):
        out[i, :] = row
    return out


@dataclasses.dataclass(frozen=True)
class RankDevice:
    """A rank as `hybrid_device_order` reads a device: its world rank and
    its node (the slice)."""

    id: int
    slice_index: int


def node_index() -> int:
    """This process's node: torchrun's GROUP_RANK, else its rank over
    LOCAL_WORLD_SIZE, else 0 (one node)."""
    env = os.environ
    if env.get("GROUP_RANK") is not None:
        return int(env["GROUP_RANK"])
    if env.get("LOCAL_WORLD_SIZE"):
        return world_rank() // int(env["LOCAL_WORLD_SIZE"])
    return 0


def create_hybrid_mesh(data: int = 1, model: int = 1) -> Mesh:
    """The mesh for one or several nodes: each model group inside one node,
    the data axis across nodes (`hybrid_device_order` over the ranks, each
    rank's node from `node_index`, shared by one all_gather). On one node
    it is `create_mesh`'s layout. Collective: every rank calls it."""
    world = _check_world(data, model)
    nodes = [0] * world
    if world > 1:
        dist.all_gather_object(nodes, node_index())
    order = hybrid_device_order([RankDevice(r, n) for r, n in enumerate(nodes)], data, model)
    mesh = Mesh(data, model, world_rank(),
                tuple(tuple(int(d.id) for d in row) for row in order))
    _make_groups(mesh)
    return mesh


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

# decoder state: batch on data, heads on model (the SWA rings on their Hkv
# dim, 2; JAX's table names dim 3, the ring's capacity: see the docstring).
# JAX's table names neither Mamba2 key and holds both whole; the port holds
# a rank's heads of the SSM state and its channels of the fused conv's
# history (three blocks of [v | k | q], `_state_slice`)
_STATE_RULES: Tuple[Tuple[str, Spec], ...] = (
    (r"swa_[kv]", (None, DATA, MODEL, None, None)),
    (r"delta_h", (None, DATA, MODEL, None, None)),
    (r"conv_[qkv]", (None, DATA, None, MODEL)),
    (r"mamba_h", (None, DATA, MODEL, None, None)),
    (r"mamba_conv", (None, DATA, None, MODEL)),
    (r"cum_len", ()),
)

_FIT_WARNED: set = set()


def _match(path: str, rules=_RULES) -> Optional[Spec]:
    for pat, spec in rules:
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
_SHARDED = False  # set once this process holds a data-axis shard: the gathers' fast path
_TP = False  # set once this process holds a model-axis slice


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
    """True where the batch's rows are split over more than one data rank."""
    return _ACTIVE is not None and _ACTIVE.data > 1 and _SPLIT_BATCH


def model_parallel() -> bool:
    """True under a mesh with more than one rank on the model axis."""
    return _ACTIVE is not None and _ACTIVE.model > 1


def all_reduce_sum(x: torch.Tensor, axis: str = DATA) -> torch.Tensor:
    """A detached copy of `x` summed over this rank's group of `axis` (the
    data group by default; one all_reduce)."""
    y = x.detach().contiguous().clone()
    if _AXIS_SIZE[axis] != 1:
        dist.all_reduce(y, group=_GROUPS[axis])
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


@dataclasses.dataclass(frozen=True)
class ShardInfo:
    """A leaf's slice on this rank along one mesh axis: `full` entries along
    `dim` over the axis's `world` ranks, this rank's (coordinate `rank` on
    the axis) starting at rank x full / world."""

    dim: int
    full: int
    world: int
    rank: int
    axis: str = DATA


def _gather_raw(shard: torch.Tensor, info: ShardInfo) -> torch.Tensor:
    x = (shard if info.dim == 0 else shard.movedim(info.dim, 0)).contiguous()
    out = x.new_empty((x.shape[0] * info.world,) + tuple(x.shape[1:]))
    _all_gather(out, x, group=_GROUPS[info.axis])
    return out if info.dim == 0 else out.movedim(0, info.dim).contiguous()


def _reduce_scatter_raw(grad: torch.Tensor, info: ShardInfo) -> torch.Tensor:
    x = (grad if info.dim == 0 else grad.movedim(info.dim, 0)).contiguous()
    out = x.new_empty((x.shape[0] // info.world,) + tuple(x.shape[1:]))
    _reduce_scatter(out, x, group=_GROUPS[info.axis])
    return out if info.dim == 0 else out.movedim(0, info.dim).contiguous()


def shard_info(t: torch.Tensor) -> Optional[ShardInfo]:
    """The leaf's data-axis (FSDP) layout, None where it is whole over data."""
    return getattr(t, "_ivl_shard", None)


def tp_info(t) -> Optional[ShardInfo]:
    """The leaf's model-axis (tensor-parallel) layout, None where it is
    whole over the model axis."""
    return getattr(t, "_ivl_tp", None)


def copy_shard_info(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    for attr in ("_ivl_shard", "_ivl_tp", "_ivl_pipe"):
        info = getattr(src, attr, None)
        if info is not None:
            setattr(dst, attr, info)
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
    """The leaf whole over the data axis (its model-axis slice kept, and
    its tag with it)."""
    info = shard_info(t)
    if info is None:
        return t
    if t.requires_grad and torch.is_grad_enabled():
        out = _GatherShard.apply(t, info)
    else:
        with torch.no_grad():
            out = _gather_raw(t, info)
    tp = tp_info(t)
    if tp is not None:
        out._ivl_tp = tp
    return out


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
def _whole(t: torch.Tensor) -> torch.Tensor:
    """A leaf whole over both axes (every rank of its groups must call)."""
    t = gather_leaf(t)
    info = tp_info(t)
    return _gather_raw(t, info) if info is not None else t


@torch.no_grad()
def gather_full(tree):
    """A copy of the tree with every leaf whole over both axes and detached
    (for saving and export): every rank must call it, each gets the full
    tree. The tree itself where this process holds no slice."""
    if not (_SHARDED or _TP):
        return tree
    return tree_map(lambda t: _whole(t).detach() if shard_info(t) or tp_info(t) else t, tree)


# ---------------------------------------------------------------- tensor parallelism

class _Copy(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=_GROUPS[MODEL])
        return g


class _Sum(torch.autograd.Function):
    """The partial results summed over the model group; identity backward."""

    @staticmethod
    def forward(ctx, x):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=_GROUPS[MODEL])
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad


class _Gather(torch.autograd.Function):
    """The model group's slices along the last dim, whole. Backward: the
    rank's slice of the gradient (`summed` False: the whole tensor feeds
    computation every rank repeats, so each holds the whole gradient) or
    the gradient summed over the group, then sliced (`summed` True: each
    rank reads its own part of the whole tensor)."""

    @staticmethod
    def forward(ctx, x, summed):
        ctx.summed, ctx.n = summed, x.shape[-1]
        m = _AXIS_SIZE[MODEL]
        return _gather_raw(x, ShardInfo(x.ndim - 1, x.shape[-1] * m, m, _MODEL_RANK, MODEL))

    @staticmethod
    def backward(ctx, grad):
        info = ShardInfo(grad.ndim - 1, grad.shape[-1], _AXIS_SIZE[MODEL], _MODEL_RANK, MODEL)
        if ctx.summed:
            return _reduce_scatter_raw(grad, info), None
        return grad.narrow(-1, _MODEL_RANK * ctx.n, ctx.n).contiguous(), None


def tp_copy(x: torch.Tensor) -> torch.Tensor:
    """Where a replicated tensor enters column-parallel work (or a
    replicated leaf is read inside a head-parallel region): identity
    forward, all_reduce of the gradient over the model group."""
    return _Copy.apply(x)


def tp_sum(x: torch.Tensor) -> torch.Tensor:
    """A row-parallel kernel's partial output summed over the model group
    (all_reduce forward, identity backward)."""
    return _Sum.apply(x)


def tp_gather(x: torch.Tensor, summed: bool = False) -> torch.Tensor:
    """The model group's slices of `x` along its last dim, whole (all_gather
    forward; backward as `_Gather`)."""
    return _Gather.apply(x, summed)


def kv_head_range(hq: int, hkv: int, model: int, rank: int) -> Tuple[int, int]:
    """The KV heads [kv0, kv1) that model rank `rank`'s query heads read
    (GQA: query head h reads KV head h // (hq / hkv)); the rank holds query
    heads [rank hq / model, (rank + 1) hq / model)."""
    if hq % model:
        raise NotImplementedError(
            f"tensor parallelism over {model} ranks with {hq} query heads (a split "
            "that cuts a query head) is not ported to torch")
    nq, g = hq // model, hq // hkv
    return rank * nq // g, ((rank + 1) * nq - 1) // g + 1


# ---------------------------------------------------------------- sharding

_WHOLE = ("inv_freq",)
# leaves that no model-sharded path takes
_TP_REFUSED = (
    (re.compile(r".*/(kernel_q4|kernel_q4f|scale4)$"),
     "int4 weights under model_parallel > 1 (no JAX trainer path reaches them)"),
)


def _path(prefix: str, key) -> str:
    return f"{prefix}/{key}" if prefix else str(key)


def _narrow(t: torch.Tensor, dim: int, n_ranks: int, rank: int) -> torch.Tensor:
    n = t.shape[dim] // n_ranks
    return t.narrow(dim, rank * n, n)


def shard_params(tree, mesh: Optional[Mesh], param_mode: str = "fsdp",
                 memo: Optional[Dict[int, Any]] = None, prefix: str = ""):
    """The tree with each leaf that `param_spec` shards replaced by this
    rank's contiguous slice: along the model axis (tensor parallelism,
    `tp` and `fsdp` at model > 1) and, under `fsdp`, along the data axis
    (trainable where the leaf was; tagged `_ivl_tp` / `_ivl_shard`); other
    leaves are kept as they are. New containers, the leaves' tensors shared
    where whole. A leaf reached twice, in this tree or in another sharded
    with the same `memo` (a student sharing its teacher's tensors), becomes
    ONE shard. Without a mesh, or where neither axis shards anything, the
    tree itself. int4 weights raise at model > 1."""
    global _SHARDED, _TP
    if param_mode not in ("fsdp", "tp", "replicated"):
        raise ValueError(f"unknown param_mode {param_mode!r} (tp | fsdp | replicated)")
    if mesh is None or param_mode == "replicated" or (
            mesh.model <= 1 and (mesh.data <= 1 or param_mode != "fsdp")):
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
    if mesh.model > 1:
        for pat, what in _TP_REFUSED:
            if pat.fullmatch(prefix):
                raise NotImplementedError(f"{what} is not ported to torch yet ({prefix})")
    spec = param_spec(prefix, tree.shape, mesh.data, mesh.model, param_mode)
    out = tree
    if prefix.rsplit("/", 1)[-1] not in _WHOLE:
        out = tree.detach()
        tags = {}
        for axis, attr, n, r in ((MODEL, "_ivl_tp", mesh.model, mesh.model_rank),
                                 (DATA, "_ivl_shard", mesh.data, mesh.data_rank)):
            if axis in spec and n > 1:  # an axis of one rank holds the leaf whole
                dim = spec.index(axis)
                tags[attr] = ShardInfo(dim, int(tree.shape[dim]), n, r, axis)
                out = _narrow(out, dim, n, r)
        if tags:
            out = out.clone(memory_format=torch.contiguous_format)
            out.requires_grad_(tree.requires_grad)
            for attr, info in tags.items():
                setattr(out, attr, info)
            _TP = _TP or "_ivl_tp" in tags
            _SHARDED = _SHARDED or "_ivl_shard" in tags
        else:
            out = tree
    memo[id(tree)] = (tree, out)  # the source kept alive: ids stay unique
    return out


def _infos(t: torch.Tensor) -> List[ShardInfo]:
    return [i for i in (shard_info(t), tp_info(t)) if i is not None]


def local_bytes(tree) -> Tuple[int, int]:
    """(bytes this rank holds, bytes of the same leaves whole) over the
    sharded leaves of `tree` (either axis), each tensor counted once."""
    seen, held, whole = set(), 0, 0
    for t in _tensors(tree):
        infos = _infos(t)
        if not infos or id(t) in seen:
            continue
        seen.add(id(t))
        n = t.numel() * t.element_size()
        held += n
        for info in infos:
            n = n // t.shape[info.dim] * info.full
        whole += n
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


# ---------------------------------------------------------------- the decoder state

def state_spec(key: str, shape: Sequence[int], data: int = 1, model: int = 1) -> Spec:
    """The mesh axis of each dim of the decoder state's `key`
    (`_STATE_RULES`, with `_fit`'s fallback)."""
    spec = _match(key, _STATE_RULES) or ()
    fitted = _fit(spec, tuple(shape), {DATA: data, MODEL: model})
    return tuple(fitted) + (None,) * (len(shape) - len(fitted))


Ranges = Tuple[Tuple[int, int], ...]


def _state_slice(key: str, shape, mesh: Mesh, hq: int) -> Dict[int, Ranges]:
    """{dim: ((start, stop), ...)} of this rank's part of the state's `key`:
    one range a dim, but three along the Mamba2 conv history's channels
    (this rank's heads' columns of v, of k and of q)."""
    spec = state_spec(key, shape, mesh.data, mesh.model)
    out = {}
    for dim, ax in enumerate(spec):
        if ax == DATA:
            n = shape[dim] // mesh.data
            out[dim] = ((mesh.data_rank * n, (mesh.data_rank + 1) * n),)
        elif ax == MODEL:
            n = shape[dim] // mesh.model
            out[dim] = ((mesh.model_rank * n, (mesh.model_rank + 1) * n),)
    if key.startswith("swa_") and mesh.model > 1 and 2 not in out:
        # Hkv does not divide over the model axis: the KV heads that this
        # rank's query heads read
        out[2] = (kv_head_range(hq, shape[2], mesh.model, mesh.model_rank),)
    if key == "mamba_conv" and 3 in out:
        third = shape[3] // 3
        if third % mesh.model:
            del out[3]  # the heads do not divide over the model axis: whole
        else:
            n, r = third // mesh.model, mesh.model_rank
            out[3] = tuple((j * third + r * n, j * third + (r + 1) * n) for j in range(3))
    return out


def _blocks(sl: Dict[int, Ranges]) -> Iterator[List[Tuple[int, int, int, int]]]:
    """Each block of a slice: per sliced dim (dim, start in the whole,
    length, start in the part)."""
    dims = sorted(sl)
    for idx in itertools.product(*(range(len(sl[d])) for d in dims)):
        block = []
        for d, i in zip(dims, idx):
            a, b = sl[d][i]
            block.append((d, a, b - a, sum(y - x for x, y in sl[d][:i])))
        yield block


def _view(t: torch.Tensor, block, whole: bool) -> torch.Tensor:
    for d, a, n, off in block:
        t = t.narrow(d, a if whole else off, n)
    return t


def local_state_shape(key: str, shape: Sequence[int], mesh: Optional[Mesh], hq: int
                      ) -> Tuple[int, ...]:
    """The shape of this rank's part of the state's `key` (whole `shape`)."""
    shape = tuple(int(s) for s in shape)
    if mesh is None:
        return shape
    out = list(shape)
    for dim, ranges in _state_slice(key, shape, mesh, hq).items():
        out[dim] = sum(b - a for a, b in ranges)
    return tuple(out)


def shard_state(state, mesh: Optional[Mesh], hq: int):
    """This rank's part of a whole decoder state (`hq`: the config's query
    heads, which place the SWA rings' KV heads): copies of the slices;
    cum_len as it is."""
    if mesh is None:
        return state
    out = {}
    for k, v in state.items():
        if isinstance(v, torch.Tensor):
            sl = _state_slice(k, v.shape, mesh, hq)
            part = v.new_empty(local_state_shape(k, v.shape, mesh, hq))
            for block in _blocks(sl):
                _view(part, block, False).copy_(_view(v, block, True))
            v = part
        out[k] = v
    return out


@torch.no_grad()
def gather_state(state, mesh: Optional[Mesh], hq: int, whole_shapes: Dict[str, tuple]):
    """The whole decoder state from every rank's part (every rank calls it
    and gets the whole state): the parts all-gathered over the world and
    placed at their slices (a KV head several ranks hold is taken from the
    first)."""
    if mesh is None:
        return state
    out = {}
    world = mesh.data * mesh.model
    for k, v in state.items():
        if not isinstance(v, torch.Tensor):
            out[k] = v
            continue
        parts = [torch.empty_like(v) for _ in range(world)]
        dist.all_gather(parts, v.contiguous())
        whole = v.new_empty(whole_shapes[k])
        for r, part in enumerate(parts):
            sl = _state_slice(k, whole_shapes[k], Mesh(mesh.data, mesh.model, r, mesh.order), hq)
            for block in _blocks(sl):
                _view(whole, block, True).copy_(_view(part, block, False))
        out[k] = whole
    return out


# ---------------------------------------------------------------- gradients

def sync_gradients(leaves: Sequence[torch.Tensor], grads: List[torch.Tensor]
                   ) -> List[torch.Tensor]:
    """The gradients of the global batch: each leaf that is whole over the
    data axis (replicated, or a model-axis slice) has its gradient summed
    over the data group (one all_reduce a leaf); a data-axis shard's is
    already summed (its gather's backward). Unchanged where the batch is
    not split."""
    if not data_parallel():
        return grads
    out = []
    for t, g in zip(leaves, grads):
        out.append(all_reduce_sum(g) if shard_info(t) is None else g)
    return out


def _sum_axes(t: torch.Tensor) -> Tuple[str, ...]:
    """The axes over whose groups a leaf's squares are summed: the model
    and data axes it is sliced on, and the pipe axis for a stage's layer."""
    return tuple(ax for ax, on in ((MODEL, tp_info(t) is not None),
                                   (DATA, shard_info(t) is not None),
                                   (PIPE, getattr(t, "_ivl_pipe", False))) if on)


def grad_sq_norm(leaves: Sequence[torch.Tensor], grads) -> torch.Tensor:
    """The squared global norm of the gradients: each slice's sum of squares
    summed over its axes' groups (the model group, the data group, or both),
    a stage's layers' over the pipe group (one all_reduce an axis), each
    replicated leaf counted once. With no slice in the process, the plain
    sum."""
    parts: Dict[Tuple[str, ...], list] = {}
    for t, g in zip(leaves, grads):
        parts.setdefault(_sum_axes(t), []).append(g)
    sq = {k: sum((g.float() ** 2).sum() for g in v) for k, v in parts.items()}
    # every rank of a group holds leaves of the same kinds (the same rules on
    # the same shapes; each stage the same layers' structure): all or none
    # of them reduce, the same kinds in the same order
    for axis in (MODEL, DATA, PIPE):
        keys = sorted(k for k in sq if axis in k)
        if keys:
            v = all_reduce_sum(torch.stack([sq[k] for k in keys]), axis)
            sq.update({k: v[i] for i, k in enumerate(keys)})
    return sum(sq.values())


# ---------------------------------------------------------------- batches

def rank_rows(batch: Dict[str, Any], mesh: Optional[Mesh]) -> Dict[str, Any]:
    """This rank's rows of a global text batch: the rows of its data
    coordinate, [d B/n, (d+1) B/n), of every per-row array (position_ids
    along its dim 1), `_n_tokens` recounted from the rows' segment ids. The
    batch itself without a mesh or with one data rank."""
    if mesh is None or mesh.data <= 1:
        return batch
    B = batch["input_ids"].shape[0] if "input_ids" in batch else None
    if B is None:
        raise ValueError("rank_rows needs the batch's input_ids")
    if B % mesh.data:
        raise ValueError(f"global batch of {B} rows over {mesh.data} data ranks")
    n = B // mesh.data
    rows = slice(mesh.data_rank * n, (mesh.data_rank + 1) * n)
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
    lo, hi = mesh.data_rank * n, (mesh.data_rank + 1) * n
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

# the optimizers' per-leaf state: a list with one entry a trainable leaf, the
# entry a tensor (AdamW's mu / nu, Adam-mini's m / v, the accumulator) or a
# list of tensors (GaLore's `leaves`, APOLLO's `mv`)
_PER_LEAF_KEYS = ("mu", "nu", "m", "v", "acc", "leaves", "mv")


def _per_leaf(state: Dict[str, Any], n: int):
    for k, v in state.items():
        if k in _PER_LEAF_KEYS and isinstance(v, list) and len(v) == n:
            yield k, v


def hold_whole(t: torch.Tensor) -> torch.Tensor:
    """Mark an optimizer state tensor of a sliced leaf that every rank holds
    whole (a whole-leaf update's projection, its low-rank moments, a block
    second moment): the state's gather and load leave it as it is."""
    t._ivl_whole = True
    return t


def _held_whole(m: torch.Tensor) -> bool:
    return getattr(m, "_ivl_whole", False)


def whole_shape(t: torch.Tensor) -> Tuple[int, ...]:
    """The shape of the leaf `t` whole over the axes it is sliced on."""
    shape = list(t.shape)
    for info in _infos(t):
        shape[info.dim] = info.full
    return tuple(shape)


@torch.no_grad()
def whole_like(m: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """A tensor shaped as this rank's slice of leaf `t` (its gradient, a
    moment), whole over the axes `t` is sliced on: all-gathered over the
    data group, then over the model group (every rank of those groups must
    call it, for the same leaves in the same order); `m` itself where `t`
    is whole."""
    info = shard_info(t)
    if info is not None:
        m = _gather_raw(m, info)
    info = tp_info(t)
    return _gather_raw(m, info) if info is not None else m


def _map_entry(entry, fn):
    return [fn(m) for m in entry] if isinstance(entry, list) else fn(entry)


@torch.no_grad()
def gather_opt_state(state: Dict[str, Any], leaves: Sequence[torch.Tensor],
                     keys: Sequence[str] = _PER_LEAF_KEYS) -> Dict[str, Any]:
    """The optimizer state with each per-leaf tensor (of `keys`) of a sliced
    leaf made whole (the one-process format), those held whole as they
    are; every rank must call it."""
    out = dict(state)
    for k, v in _per_leaf(state, len(leaves)):
        if k in keys:
            out[k] = [_map_entry(e, lambda m, t=t: m if _held_whole(m) else whole_like(m, t))
                      for e, t in zip(v, leaves)]
    return out


def _slice_for(full: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """This rank's slice of the whole `full` for the leaf (or moment) `t`."""
    for info in (tp_info(t), shard_info(t)):
        if info is not None and full.shape[info.dim] == info.full:
            full = _narrow(full, info.dim, info.world, info.rank)
    if tuple(full.shape) != tuple(t.shape):
        raise ValueError(f"a saved leaf of shape {tuple(full.shape)} for one of "
                         f"{tuple(t.shape)}")
    return full


def slice_like(full: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """This rank's slice of `full`, a tensor shaped as the leaf `t` whole
    (the inverse of `whole_like`; `full` itself where `t` is whole)."""
    return _slice_for(full, t) if _infos(t) else full


@torch.no_grad()
def load_into(dst, src) -> None:
    """Copy a one-process tree (`src`, whole leaves) into `dst` in place:
    a sharded leaf takes its rank's slices, a whole one the whole leaf."""
    if isinstance(dst, dict):
        for k, v in dst.items():
            load_into(v, src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            load_into(d, s)
    elif isinstance(dst, torch.Tensor):
        dst.copy_(_slice_for(src, dst))


@torch.no_grad()
def load_opt_state(dst: Dict[str, Any], src: Dict[str, Any],
                   leaves: Sequence[torch.Tensor]) -> None:
    """Copy a one-process optimizer state into `dst` in place, each per-leaf
    tensor of a sliced leaf cut to the rank's slices (those held whole
    copied whole)."""
    per = dict(_per_leaf(dst, len(leaves)))

    def put(m, s, t):
        m.copy_(s if _held_whole(m) else _slice_for(s, copy_shard_info(m.detach(), t)))

    for k, v in src.items():
        if k in per:
            for e, s, t in zip(per[k], v, leaves):
                for m, sm in (zip(e, s) if isinstance(e, list) else ((e, s),)):
                    put(m, sm, t)
        elif isinstance(dst.get(k), (dict, list, tuple, torch.Tensor)):
            load_into(dst[k], v)
        else:
            dst[k] = v
