"""Pipeline parallelism: the GPipe and 1F1B schedules over a pipe axis
(torch port of infinitevl_tpu/parallel/pipeline.py).

Stages are cut at hybrid-period granularity (`stack_stage_params`): with
the decoder's L = G x period layers (the deployed config repeats
(sliding, linear, linear, linear), so 36 layers are 9 periods and S must
divide 9), stage s holds periods [s G / S, (s + 1) G / S), so every stage
has the same parameter structure. The port keeps a per-layer list:
`stage_layers[s]` is stage s's list of layer trees (JAX stacks them on a
stage axis, which the Python layer loop does not need).

A pipelined run (`train/trainer.run_sft` with `pipeline_stages` > 1) is
one process per rank of `create_pp_mesh`'s (pipe, data, model) world:
rank (p, d, m) runs stage p on its data coordinate's rows under its model
group's tensor parallelism. It holds its stage's layers only: its text
tree keeps the one-process shape with every other stage's layers empty
(`shard_stage`), so a leaf's path is its one-process path (the sharding
rules, the optimizers and the checkpoints key on it). Embed, final norm,
lm_head and inv_freq are held by every stage (sliced by the data and
model rules only), as JAX replicates them over the pipe axis; stage 0
reads the embedding, the last stage the final norm and the head (the tied
embedding); their gradients are summed over the pipe group, so every
stage's update of them is the same. A stage's layers are tagged
`_ivl_pipe`: the clip's global norm sums their squares over the pipe group
(parallel/sharding.grad_sq_norm).

Schedules (microbatch m is rows [m B/M, (m + 1) B/M) of the rank's rows):
- GPipe (`pp_sft_value_and_grad_gpipe`): each microbatch's forward through
  the stage (a checkpoint a layer under remat), handed to the next stage;
  then the backwards in reverse order, each from the gradient the next
  stage hands back. Its activation memory grows with M;
- 1F1B (`pp_sft_value_and_grad_1f1b`): JAX's tick plan, u = 0 .. M + 2S - 3:
  stage s runs the forward of microbatch u - s (saving its input), the
  last stage the head of u - (S - 1), stage s the backward of u - (2S - 2 -
  s), recomputing its forward from the saved input; a stage holds at most
  2S - 1 inputs, whatever M.
Both return the plain run's loss (sum NLL over the supervised tokens of the
batch, the global batch's count under data parallelism) and the gradients
of the trainable leaves. rope's inv_freq stays frozen, as in every full
finetune of the port (JAX's 1F1B gives it a gradient). Without a pipe mesh
(one process) the same functions run every stage in turn, each stage's
input cut from the previous stage's graph as on a rank; `pp_sft_loss_fn`
is then the differentiable loss (JAX's with mesh=None).

Hand-offs between stages are one broadcast each in the adjacent stages'
two-rank group (parallel/sharding.pipe_handoff): gloo's send / recv take
CPU tensors only while its broadcast takes CUDA tensors (staging them
through the host itself), and ranks sharing one card must use gloo (NCCL
refuses a second rank on a GPU), so the same call runs on gloo (CPU or
CUDA) and on NCCL with no host copy written here. Both ends of a pair call
its broadcasts in one order: GPipe hands microbatches on in their order
(forward) and in reverse (backward); 1F1B exchanges at the end of each
tick, pair by pair in stage order, the activation before the gradient, so
no two blocking hand-offs wait on each other. Every rank of a data or
model group is at the same stage and issues the same collectives in the
same order."""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..config import TextConfig
from ..models.text import _run_layers, embed_tokens
from ..ops.norms import rms_norm
from ..ops.rope import mrope_cos_sin
from ..utils.checkpoint import tree_map
from .sharding import (  # noqa: F401  (create_pp_mesh re-exported: JAX's module has it)
    PIPE,
    Mesh,
    all_reduce_sum,
    copy_shard_info,
    create_pp_mesh,
    gather_full,
    gather_opt_state,
    gather_tree,
    global_sum,
    load_into,
    load_opt_state,
    pipe_broadcast,
    pipe_handoff,
    shard_params,
    use_mesh,
)

Params = Dict[str, Any]


# ---------------------------------------------------------------- the stage cut

def detect_period(layer_types: Sequence[str]) -> Optional[int]:
    """Smallest p with layer_types == layer_types[:p] * (L / p), or None."""
    L = len(layer_types)
    for p in range(1, L + 1):
        if L % p == 0 and tuple(layer_types) == tuple(layer_types[:p]) * (L // p):
            return p
    return None


def stack_stage_params(text_params: Params, cfg: TextConfig, n_stages: int) -> Params:
    """The stage cut: the text tree with `layers` replaced by
    `stage_layers`, stage s's list of layer trees (periods [s G / S,
    (s + 1) G / S) of the G pattern periods). The trees are shared, not
    copied. Raises where the layer pattern has no period or S does not
    divide G."""
    roles = tuple(cfg.layer_role(i) for i in range(len(text_params["layers"])))
    period = detect_period(roles)
    if period is None:
        raise ValueError(f"layer pattern {roles} has no period")
    L = len(roles)
    G = L // period
    if G % n_stages:
        raise ValueError(f"{n_stages} stages must divide the {G} pattern periods "
                         f"({L} layers, period {period})")
    n = L // n_stages
    out = {k: v for k, v in text_params.items() if k != "layers"}
    out["stage_layers"] = [list(text_params["layers"][s * n : (s + 1) * n])
                           for s in range(n_stages)]
    return out


def _map_np(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_np(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_np(fn, v) for v in tree)
    return tree if tree is None else fn(tree)


def unstack_stage_params(pp_params: Params) -> Params:
    """Inverse of stack_stage_params: the per-layer `layers` list back. A
    JAX stage-stacked tree in numpy (`stage_stacks`: one tree a period
    position, leaves [S, G / S, ...]) comes out with its per-layer layers
    as numpy (layer (s G / S + l) x period + j is stack j's [s, l])."""
    out = {k: v for k, v in pp_params.items() if k not in ("stage_layers", "stage_stacks")}
    if "stage_stacks" not in pp_params:
        out["layers"] = [lp for stage in pp_params["stage_layers"] for lp in stage]
        return out
    stacks = pp_params["stage_stacks"]
    period = len(stacks)
    lead = next(iter(_leaves_np(stacks[0]))).shape
    S, local = int(lead[0]), int(lead[1])
    layers: List[Any] = [None] * (S * local * period)
    for j, tree in enumerate(stacks):
        for s in range(S):
            for i in range(local):
                layers[(s * local + i) * period + j] = _map_np(
                    lambda x, s=s, i=i: np.asarray(x)[s, i], tree)
    out["layers"] = layers
    return out


def _leaves_np(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves_np(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves_np(v)
    elif tree is not None:
        yield tree


def shard_stage(text_params: Params, cfg: TextConfig, n_stages: int, mesh: Optional[Mesh],
                param_mode: str = "fsdp") -> Params:
    """This rank's text tree of a pipelined run: with a pipe mesh, the
    layers of every other stage replaced by empty trees ({}), the rest
    sliced by the data and model rules (parallel/sharding.shard_params) and
    the stage's layer leaves tagged `_ivl_pipe`; without one, the tree as
    shard_params leaves it. The stage cut is checked first."""
    n = len(stack_stage_params(text_params, cfg, n_stages)["stage_layers"][0])
    if mesh is None or mesh.pipe <= 1:
        return shard_params({"text": text_params}, mesh, param_mode)["text"]
    p = mesh.pipe_rank
    own = {k: v for k, v in text_params.items() if k != "layers"}
    own["layers"] = [lp if i // n == p else {} for i, lp in enumerate(text_params["layers"])]
    own = shard_params({"text": own}, mesh, param_mode)["text"]
    for lp in own["layers"]:
        tree_map(lambda t: setattr(t, "_ivl_pipe", True), lp)
    return own


def _layers_per_stage(text: Params) -> int:
    """Layers a stage, read from a rank's tree (its held layers)."""
    return sum(1 for lp in text["layers"] if lp)


def _fill_stages(tree: Params, mesh: Mesh, n: int) -> Params:
    """`tree` ({"text": {..., "layers": [...]}}, a rank's stage held, every
    other stage's layers empty) with every stage's layers, broadcast over
    the pipe group stage by stage (every rank of the group calls it; a
    stage's layers have the shapes of this rank's at the same position)."""
    p = mesh.pipe_rank
    layers = list(tree["text"]["layers"])
    for s in range(mesh.pipe):
        for i in range(s * n, (s + 1) * n):
            mine = layers[p * n + i % n]
            got = tree_map(lambda t: t.detach() if s == p else torch.empty_like(t), mine)
            flat: List[torch.Tensor] = []
            tree_map(flat.append, got)
            for t in flat:
                pipe_broadcast(t, s)
            layers[i] = got
    return {**tree, "text": {**tree["text"], "layers": layers}}


def gather_stages(tree: Params, mesh: Optional[Mesh]) -> Params:
    """The whole model of a pipelined run in the one-process layout:
    `tree` ({"text": ...}) whole over the data and model axes
    (gather_full) with every stage's layers (collective: every rank calls
    it and gets the whole tree, detached)."""
    whole = gather_full(tree)
    if mesh is None or mesh.pipe <= 1:
        return whole
    n = _layers_per_stage(tree["text"])
    out = _fill_stages(whole, mesh, n)
    return tree_map(lambda t: t.detach(), out)


def _trainable_paths(tree) -> List[str]:
    """The paths a one-process full finetune trains, in its order."""
    from ..train.step import full_finetune_leaf, tree_leaves_with_path

    return [p for p, t in tree_leaves_with_path(tree)
            if t.is_floating_point() and full_finetune_leaf(p)]


def _tree_at(params: Params, by_path: Dict[str, torch.Tensor], prefix: str = ""):
    """`params`' structure with each leaf replaced by by_path[its path]
    (None where absent)."""
    if isinstance(params, dict):
        return {k: _tree_at(v, by_path, f"{prefix}/{k}" if prefix else str(k))
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(_tree_at(v, by_path, f"{prefix}/{i}" if prefix else str(i))
                            for i, v in enumerate(params))
    return by_path.get(prefix)


def pipeline_state(params: Params, opt_state: Dict[str, Any], mesh: Optional[Mesh]
                   ) -> Dict[str, Any]:
    """The train state of a pipelined run in the one-process layout (what
    every other run of the port writes): the params whole (gather_stages)
    and each per-leaf optimizer list (mu, nu, acc, ...) whole, in the
    one-process trainable order. Collective: every rank calls it."""
    from ..train.step import trainable_leaves, tree_leaves_with_path

    named = trainable_leaves(params)
    whole = gather_stages(params, mesh)
    opt = gather_opt_state(opt_state, [t for _, t in named])
    order = _trainable_paths(whole)
    out = dict(opt)
    for k, v in opt.items():
        if not (isinstance(v, list) and len(v) == len(named)):
            continue
        moments = _tree_at(whole, {p: m for (p, _), m in zip(named, v)})
        if mesh is not None and mesh.pipe > 1:
            moments = _fill_stages(moments, mesh, _layers_per_stage(params["text"]))
        full = dict(tree_leaves_with_path(moments))
        out[k] = [full[p] for p in order]
    return {"params": whole, "opt_state": out}


def load_pipeline_state(params: Params, opt_state: Dict[str, Any], state: Dict[str, Any]
                        ) -> None:
    """Copy a one-process train state into this rank's stage in place: its
    layers and the replicated leaves, each cut to the rank's data and model
    slices, and their optimizer moments, matched by path."""
    from ..train.step import trainable_leaves

    load_into(params, state["params"])
    named = trainable_leaves(params)
    order = _trainable_paths(state["params"])
    src = {}
    for k, v in state["opt_state"].items():
        if isinstance(v, list) and len(v) == len(order):
            by_path = dict(zip(order, v))
            src[k] = [by_path[p] for p, _ in named]
        else:
            src[k] = v
    load_opt_state(opt_state, src, [t for _, t in named])


# ---------------------------------------------------------------- the stage

def _stage_fn(layers, cfg: TextConfig, first: int, x, cos, sin, segment_ids,
              tail_pads_only: bool, remat: bool):
    """One stage: its layers in order (global indices first, first + 1, ...),
    each a checkpoint under remat when differentiated (the plain run's
    per-layer checkpoint); a sharded layer is gathered inside it."""
    roles = [cfg.layer_role(first + i) for i in range(len(layers))]
    if remat and torch.is_grad_enabled():
        for lp, role in zip(layers, roles):
            x = checkpoint(_run_layers, [lp], cfg, [role], x, cos, sin, segment_ids,
                           tail_pads_only, use_reentrant=False)
        return x
    return _run_layers(layers, cfg, roles, x, cos, sin, segment_ids, tail_pads_only)


def _ce_chunk(T: int) -> int:
    # the plain SFT path's rule: each fp32 logits chunk is chunk x V x 4 bytes
    return 512 if T >= 16384 else 1024


def _mesh_scope(mesh: Optional[Mesh]):
    return use_mesh(mesh) if mesh is not None else contextlib.nullcontext()


class _Run:
    """One pipelined loss-and-gradient evaluation on this process's stages:
    the microbatches (pieces of the rank's batch along `axis`: 0 rows, 1
    sequence chunks), the hand-offs between stages, stage 0's embedding
    (cut from each microbatch's stage input and differentiated once at the
    end), the last stage's final norm, head and CE (per microbatch, on
    detached copies of the head's leaves, their gradients summed and pulled
    back once at the end), and the gradients' sums."""

    def __init__(self, pp: Params, cfg: TextConfig, input_ids, labels, position_ids, M: int,
                 segment_ids, segment_layout, mesh: Optional[Mesh], remat: bool, axis: int):
        from ..train.step import IGNORE_INDEX, _layer_segments, head_weight, trainable_leaves

        self.pp, self.cfg, self.M, self.remat, self.axis = pp, cfg, M, remat, axis
        self.S = len(pp["stage_layers"])
        self.pipe = mesh is not None and mesh.pipe > 1
        if self.pipe and mesh.pipe != self.S:
            raise ValueError(f"{self.S} stages on a pipe axis of {mesh.pipe} ranks")
        self.stages = [mesh.pipe_rank] if self.pipe else list(range(self.S))
        self.per_stage = len(pp["stage_layers"][0])
        if pp["inv_freq"].requires_grad:
            raise ValueError("the pipelined schedules keep rope's inv_freq frozen (the port's "
                             "full finetuning): mark it untrainable")
        B, T = input_ids.shape
        n = input_ids.shape[axis]
        if n % M:
            raise ValueError(f"batch {B} not divisible by {M} microbatches")
        self.size, self.T = n // M, T
        seg, self.tail_pads_only, labels = _layer_segments(segment_ids, segment_layout, labels)
        self.seg, self.labels = seg, labels
        dtype = pp["embed"].dtype
        with torch.no_grad():
            self.cos, self.sin = mrope_cos_sin(position_ids, pp["inv_freq"], cfg.mrope_section,
                                               cfg.attention_scaling, dtype=dtype)
        self.count = global_sum((labels != IGNORE_INDEX).sum()).clamp(min=1)
        shape = list(input_ids.shape) + [cfg.hidden_size]
        shape[axis] = self.size
        self.buffer = lambda: torch.empty(shape, dtype=dtype, device=input_ids.device)
        self.leaves = {s: [t for _, t in trainable_leaves(pp["stage_layers"][s])]
                       for s in self.stages}
        top = {k: v for k, v in pp.items() if k != "stage_layers"}
        self.top_leaves = [t for _, t in trainable_leaves(top)]
        self.grads: Dict[int, torch.Tensor] = {}
        self.inbox_act: Dict[int, Dict[int, torch.Tensor]] = {s: {} for s in range(self.S)}
        self.inbox_ct: Dict[int, Dict[int, torch.Tensor]] = {s: {} for s in range(self.S)}
        self.loss = torch.zeros((), dtype=torch.float32, device=input_ids.device)
        memo: Dict[int, torch.Tensor] = {}  # FSDP: a leaf gathered once (the tied embedding)
        self.embeds = self.head_src = None
        if 0 in self.stages:
            E = gather_tree(pp["embed"], memo)
            self.embeds = embed_tokens({"embed": E}, input_ids)
            self.d_emb: List[Optional[torch.Tensor]] = [None] * M
        if self.S - 1 in self.stages:
            w, self.tied = head_weight(pp)
            self.head_src = [gather_tree(pp["final_norm"], memo), gather_tree(w, memo)]
            self.head = [copy_shard_info(t.detach().requires_grad_(t.requires_grad), t)
                         for t in self.head_src]

    def piece(self, t: torch.Tensor, m: int) -> torch.Tensor:
        return t.narrow(self.axis, m * self.size, self.size)

    def pieces(self, m: int):
        """Microbatch m's (cos, sin, segment ids)."""
        return (self.piece(self.cos, m), self.piece(self.sin, m),
                None if self.seg is None else self.piece(self.seg, m))

    def forward(self, s: int, m: int, x: torch.Tensor) -> torch.Tensor:
        cos, sin, seg = self.pieces(m)
        return _stage_fn(self.pp["stage_layers"][s], self.cfg, s * self.per_stage, x, cos, sin,
                         seg, self.tail_pads_only, self.remat)

    def head_nll(self, m: int, y: torch.Tensor) -> torch.Tensor:
        """Microbatch m's sum NLL over the batch's count (the loss's part),
        differentiable in y and the head's copies."""
        from ..train.step import chunked_logprobs

        f, w = self.head
        h = rms_norm(y, f, self.cfg.rms_norm_eps)
        nll = -chunked_logprobs(h, w, self.piece(self.labels, m), _ce_chunk(self.T), self.tied)
        return nll.sum() / self.count

    def head_cotangent(self, m: int, y: torch.Tensor) -> None:
        """1F1B's head: the loss's part, the head's gradients and the
        cotangent of y (for the last stage's backward of m)."""
        with torch.enable_grad():
            yq = y.detach().requires_grad_(True)
            part = self.head_nll(m, yq)
        self.inbox_ct[self.S - 1][m], = self.backward([part], [None], [yq], self.head_leaves())
        self.loss += part.detach().float()

    def head_leaves(self) -> List[torch.Tensor]:
        return [t for t in self.head if t.requires_grad]

    def backward(self, outs, cts, inputs, leaves) -> List[Optional[torch.Tensor]]:
        """The gradients of `outs` (cotangents `cts`; None for a scalar)
        with respect to `inputs` (returned; None where one needs none) and
        `leaves` (added to the run's sums)."""
        wrt = [t for t in inputs if t.requires_grad]
        grads = torch.autograd.grad(outs, wrt + leaves, cts, allow_unused=True)
        for t, g in zip(leaves, grads[len(wrt):]):
            if g is not None:
                k = id(t)
                self.grads[k] = g if k not in self.grads else self.grads[k] + g
        it = iter(grads[: len(wrt)])
        return [next(it) if t.requires_grad else None for t in inputs]

    # -- hand-offs: a dict in one process, a pair broadcast on a pipe mesh

    def stage_input(self, s: int, m: int, grad: bool) -> torch.Tensor:
        """Stage s's input of microbatch m, cut from the graph (requiring
        grad when its gradient goes back: stage s > 0, or a trainable
        embedding)."""
        if s == 0:
            x = self.piece(self.embeds, m).detach()
            need = self.embeds.requires_grad
        elif self.pipe and m not in self.inbox_act[s]:
            x, need = pipe_handoff(self.buffer(), s - 1, s - 1), True
        else:
            x, need = self.inbox_act[s].pop(m), True
        return x.requires_grad_(need and grad)

    def hand_act(self, s: int, m: int, y: torch.Tensor) -> None:
        if self.pipe:
            pipe_handoff(y, s, s)
        else:
            self.inbox_act[s + 1][m] = y.detach()

    def take_ct(self, s: int, m: int) -> torch.Tensor:
        if self.pipe and m not in self.inbox_ct[s]:
            return pipe_handoff(self.buffer(), s, s + 1)
        return self.inbox_ct[s].pop(m)

    def hand_ct(self, s: int, m: int, dx: Optional[torch.Tensor]) -> None:
        if s == 0:
            self.d_emb[m] = dx
        elif self.pipe:
            pipe_handoff(dx, s - 1, s)
        else:
            self.inbox_ct[s - 1][m] = dx

    def end_tick(self, u: int, done) -> None:
        """1F1B's exchange after tick u; `done` holds (stage, forward
        microbatch, output, backward microbatch, input gradient) of each of
        this process's stages. On a pipe mesh, pair (p - 1, p) first, then
        (p, p + 1), each the activation before the gradient."""
        S, M = self.S, self.M
        if not self.pipe:
            for s, fm, y, bm, dx in done:
                if y is not None and s < S - 1:
                    self.hand_act(s, fm, y)
                if dx is not None or (s == 0 and 0 <= bm < M):
                    self.hand_ct(s, bm, dx)
            return
        (p, fm, y, bm, dx), = done
        if p > 0:
            m = u - (p - 1)
            if 0 <= m < M:
                self.inbox_act[p][m] = pipe_handoff(self.buffer(), p - 1, p - 1)
            if 0 <= bm < M:
                pipe_handoff(dx, p - 1, p)
        elif 0 <= bm < M:
            self.d_emb[bm] = dx
        if p < S - 1:
            if y is not None:
                pipe_handoff(y, p, p)
            m = u - (2 * S - 2 - (p + 1))
            if 0 <= m < M:
                self.inbox_ct[p][m] = pipe_handoff(self.buffer(), p, p + 1)

    def finish(self):
        """(loss, gradients): the loss summed over the pipe group, and one
        gradient a trainable leaf of `pp` (trainable_leaves' order): a
        stage's layers' from its backwards, the embedding's, final norm's
        and head's pulled back through their gathers once and summed over
        the pipe group."""
        from ..train.step import trainable_leaves

        outs, cts = [], []
        if self.embeds is not None and self.embeds.requires_grad:
            outs.append(self.embeds)
            cts.append(torch.cat(self.d_emb, dim=self.axis))
        if self.head_src is not None:
            for src, cp in zip(self.head_src, self.head):
                g = self.grads.pop(id(cp), None)
                if g is not None:
                    outs.append(src)
                    cts.append(g)
        top: Dict[int, torch.Tensor] = {}
        if outs and self.top_leaves:
            grads = torch.autograd.grad(outs, self.top_leaves, cts, allow_unused=True)
            top = {id(t): g for t, g in zip(self.top_leaves, grads) if g is not None}
        loss = self.loss
        if self.pipe:
            loss = all_reduce_sum(loss, PIPE)
            for t in self.top_leaves:
                top[id(t)] = all_reduce_sum(top.get(id(t), torch.zeros_like(t)), PIPE)
        out = []
        for _, t in trainable_leaves(self.pp):
            g = top.get(id(t), self.grads.get(id(t)))
            out.append(torch.zeros_like(t) if g is None else g)
        return loss, out


# ---------------------------------------------------------------- the schedules

def pipeline_decoder_forward(
    stage_layers: Sequence[Sequence[Params]],
    cfg: TextConfig,
    x_mb: torch.Tensor,  # [M, mB, T, D] microbatched embeddings
    cos_mb: torch.Tensor,  # [M, mB, T, head_dim]
    sin_mb: torch.Tensor,
    segment_ids_mb: Optional[torch.Tensor] = None,  # [M, mB, T]
    mesh: Optional[Mesh] = None,
    remat: bool = True,
    tail_pads_only: bool = False,
) -> torch.Tensor:
    """GPipe over the decoder trunk in one process, differentiable: at tick
    t stage s runs microbatch t - s on stage s - 1's output of the tick
    before. Returns [M, mB, T, D] hidden states (pre-final-norm). On a pipe
    mesh a rank holds one stage: the schedules with their backward
    (pp_sft_value_and_grad_gpipe / _1f1b) run there."""
    if mesh is not None and mesh.pipe > 1:
        raise ValueError("pipeline_decoder_forward runs every stage in one process; on a pipe "
                         "mesh use pp_sft_value_and_grad_gpipe or pp_sft_value_and_grad_1f1b")
    S, M = len(stage_layers), x_mb.shape[0]
    n = len(stage_layers[0])
    state: List[Optional[torch.Tensor]] = [None] * S
    out: List[Optional[torch.Tensor]] = [None] * M
    for t in range(M + S - 1):
        nxt: List[Optional[torch.Tensor]] = [None] * S
        for s in range(S):
            m = t - s
            if 0 <= m < M:
                seg = None if segment_ids_mb is None else segment_ids_mb[m]
                y = _stage_fn(stage_layers[s], cfg, s * n, x_mb[m] if s == 0 else state[s],
                              cos_mb[m], sin_mb[m], seg, tail_pads_only, remat)
                if s == S - 1:
                    out[m] = y
                else:
                    nxt[s + 1] = y
        state = nxt
    return torch.stack(out)


def pp_sft_loss_fn(
    pp_text_params: Params,
    cfg: TextConfig,
    input_ids: torch.Tensor,  # [B, T]
    labels: torch.Tensor,  # [B, T]
    position_ids: torch.Tensor,  # [3, B, T]
    n_microbatches: int,
    segment_ids: Optional[torch.Tensor] = None,
    mesh: Optional[Mesh] = None,
    remat: bool = True,
    segment_layout: Optional[str] = None,
) -> torch.Tensor:
    """SFT loss over the pipelined decoder in one process, differentiable.
    Microbatches split the batch dimension: B % n_microbatches == 0."""
    from ..train.step import _layer_segments, fused_linear_cross_entropy, head_weight

    B, T = input_ids.shape
    M = n_microbatches
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    mB = B // M
    seg, tail_pads_only, labels = _layer_segments(segment_ids, segment_layout, labels)
    embeds = embed_tokens(pp_text_params, input_ids)
    cos, sin = mrope_cos_sin(position_ids, pp_text_params["inv_freq"], cfg.mrope_section,
                             cfg.attention_scaling, dtype=embeds.dtype)
    mb = lambda a: a.reshape((M, mB) + tuple(a.shape[1:]))
    hidden = pipeline_decoder_forward(
        pp_text_params["stage_layers"], cfg, mb(embeds), mb(cos), mb(sin),
        None if seg is None else mb(seg), mesh=mesh, remat=remat,
        tail_pads_only=tail_pads_only)
    hidden = rms_norm(hidden.reshape(B, T, -1), pp_text_params["final_norm"], cfg.rms_norm_eps)
    w, tied = head_weight(pp_text_params)
    return fused_linear_cross_entropy(hidden, w, labels, chunk=_ce_chunk(T), w_is_vd=tied)


def pp_sft_value_and_grad_gpipe(
    pp_text_params: Params,
    cfg: TextConfig,
    input_ids: torch.Tensor,
    labels: torch.Tensor,
    position_ids: torch.Tensor,
    n_microbatches: int,
    segment_ids: Optional[torch.Tensor] = None,
    mesh: Optional[Mesh] = None,
    remat: bool = True,
    segment_layout: Optional[str] = None,
):
    """GPipe with its backward: (loss, gradients of trainable_leaves(
    pp_text_params) in that order). Every microbatch's forward through this
    process's stages first (their graphs kept: activation memory grows with
    M), then the backwards in reverse microbatch order, each stage's from
    the gradient of its output that the next stage hands back."""
    with _mesh_scope(mesh):
        run = _Run(pp_text_params, cfg, input_ids, labels, position_ids, n_microbatches,
                   segment_ids, segment_layout, mesh, remat, axis=0)
        S, kept = run.S, {}
        with torch.enable_grad():
            for m in range(run.M):
                for s in run.stages:
                    x = run.stage_input(s, m, grad=True)
                    y = run.forward(s, m, x)
                    if s == S - 1:
                        y = run.head_nll(m, y)
                        run.loss += y.detach().float()
                    else:
                        run.hand_act(s, m, y)
                    kept[(s, m)] = (x, y)
        for m in reversed(range(run.M)):
            for s in reversed(run.stages):
                x, y = kept.pop((s, m))
                last = s == S - 1
                ct = None if last else run.take_ct(s, m)
                dx, = run.backward([y], [ct], [x],
                                   run.leaves[s] + (run.head_leaves() if last else []))
                run.hand_ct(s, m, dx)
        return run.finish()


def pp_sft_value_and_grad_1f1b(
    pp_text_params: Params,
    cfg: TextConfig,
    input_ids: torch.Tensor,
    labels: torch.Tensor,
    position_ids: torch.Tensor,
    n_microbatches: int,
    segment_ids: Optional[torch.Tensor] = None,
    mesh: Optional[Mesh] = None,
    remat: bool = True,
    segment_layout: Optional[str] = None,
):
    """1F1B (PipeDream-flush) on JAX's tick plan: (loss, gradients of
    trainable_leaves(pp_text_params)), GPipe's numbers with bounded
    activation memory. At tick u (0 .. M + 2S - 3) stage s runs the forward
    of microbatch u - s without a graph and saves its input; the last stage
    takes the head of u - (S - 1) (its loss part and the cotangent of its
    output); stage s runs the backward of u - (2S - 2 - s), recomputing its
    forward from the saved input (per-layer checkpoints inside under remat).
    Stage s holds an input for 2 (S - 1 - s) ticks: at most 2S - 1 at once,
    whatever M. Activations move down and cotangents up at the tick's end."""
    with _mesh_scope(mesh):
        run = _Run(pp_text_params, cfg, input_ids, labels, position_ids, n_microbatches,
                   segment_ids, segment_layout, mesh, remat, axis=0)
        S, M = run.S, run.M
        saved: Dict[int, Dict[int, torch.Tensor]] = {s: {} for s in run.stages}
        for u in range(M + 2 * S - 2):
            done = []
            for s in run.stages:
                fm, bm = u - s, u - (2 * S - 2 - s)
                y = dx = None
                if 0 <= fm < M:
                    x = run.stage_input(s, fm, grad=False)
                    with torch.no_grad():
                        y = run.forward(s, fm, x)
                    saved[s][fm] = x
                    if len(saved[s]) > 2 * S - 1:
                        raise RuntimeError(f"stage {s} holds {len(saved[s])} inputs")
                    if s == S - 1:
                        run.head_cotangent(fm, y)
                if 0 <= bm < M:
                    x = saved[s].pop(bm)
                    x.requires_grad_(s > 0 or run.embeds.requires_grad)
                    ct = run.inbox_ct[s].pop(bm)
                    with torch.enable_grad():
                        yb = run.forward(s, bm, x)
                    dx, = run.backward([yb], [ct], [x], run.leaves[s])
                done.append((s, fm, y, bm, dx))
            run.end_tick(u, done)
        return run.finish()


def make_pp_sft_train_step(
    cfg: TextConfig,
    tx,
    n_microbatches: int,
    n_stages: int,
    mesh: Optional[Mesh] = None,
    remat: bool = True,
    schedule: str = "gpipe",
):
    """Pipelined (params, opt_state, batch) -> (params, opt_state, loss),
    params and the optimizer state updated in place. params = {"text": the
    rank's tree} (`shard_stage`), cut into `n_stages` stages at each step
    (the port's tree has no stage axis to read S from). schedule "gpipe" or
    "1f1b"."""
    from ..train.step import batch_to_device, tree_device

    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown pipeline schedule {schedule!r} (gpipe | 1f1b)")
    value_and_grad = (pp_sft_value_and_grad_1f1b if schedule == "1f1b"
                      else pp_sft_value_and_grad_gpipe)

    def step(params, opt_state, batch):
        batch = batch_to_device(batch, tree_device(params))
        pp = stack_stage_params(params["text"], cfg, n_stages)
        loss, grads = value_and_grad(
            pp, cfg, batch["input_ids"], batch["labels"], batch["position_ids"],
            n_microbatches, segment_ids=batch.get("segment_ids"), mesh=mesh, remat=remat,
            segment_layout=batch.get("segment_layout"))
        apply_pipeline_grads(pp, grads, params, tx, opt_state)
        return params, opt_state, loss

    return step


def apply_pipeline_grads(pp: Params, grads, params: Params, tx, opt_state) -> None:
    """The optimizer's update of `params` from the gradients of the stage
    cut `pp` (trainable_leaves(pp)'s order), matched by tensor."""
    from ..train.step import trainable_leaves

    by_id = {id(t): g for (_, t), g in zip(trainable_leaves(pp), grads)}
    tx.update([by_id[id(t)] for _, t in trainable_leaves(params)], opt_state, params)
