"""Custom optimizers: GaLore, APOLLO, LoRA+, BAdam, Adam-mini (torch port of
infinitevl_tpu/train/optim.py, the optimizers `use_optimizer` selects).

Each is a `train/step.Optimizer`: clip by the global norm first, gradient
accumulation through its `accumulation_steps`, then the update below on
the trainable leaves, in place; the state lives on the leaves' device. The
update maths are the JAX package's number for number; a leaf's path (as
`train/step.tree_leaves_with_path` spells it, `text/layers/3/q_proj/kernel`)
picks its treatment where JAX's path does.

- GaLore (arXiv:2403.03507): 2-D gradients projected onto the top-r
  singular vectors of the gradient, refreshed every `update_proj_gap`
  steps; Adam in the rank-r subspace, projected back.
- APOLLO (arXiv:2412.05270): the same memory shape with a random Gaussian
  projection redrawn every gap; the projected Adam update's per-channel
  norm scales the full-rank gradient.
- LoRA+ (arXiv:2402.12354): AdamW with the adapters' `b` matrices at
  lr x ratio.
- BAdam (arXiv:2404.02827): block-coordinate Adam over the layers, one
  block active per `switch_interval` steps.
- Adam-mini (arXiv:2406.16793): one second moment per Hessian block (a
  head of q/k, an output column elsewhere, a coordinate for embeddings
  and 1-D leaves).

Under data parallelism every one of them sees the global batch's gradients
(train/step.Optimizer.update). On a leaf sliced over the data axis (fsdp)
or the model axis (tensor parallelism) LoRA+, BAdam and every plain-Adam
leaf update the slice elementwise, as on the whole leaf. Where GaLore,
APOLLO and Adam-mini read a whole leaf (an SVD, a projection, a block
mean), the rank gathers the leaf's gradient over the axes it is sliced on
(`parallel/sharding.whole_like`, leaf by leaf in the same order on every
rank), runs the whole-leaf update as every rank of its groups does (the
same numbers: GaLore's SVD of the same gradient, APOLLO's draw from the
same seed) and keeps its slice of the result (`slice_like`). The state
that update needs stays whole on every rank (`hold_whole`): GaLore's
projection and low-rank moments, APOLLO's low-rank moments, Adam-mini's
block second moments; the per-coordinate moments are the slice's."""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from ..parallel.sharding import hold_whole, slice_like, whole_like, whole_shape
from .step import Optimizer, bias_corrections

LR = Union[float, Callable[[int], float]]


def _lr(learning_rate: LR, count: int) -> float:
    return float(learning_rate(count) if callable(learning_rate) else learning_rate)


def _project(g, proj, left: bool):
    # left: project rows ([m, n] -> [r, n]); else columns ([m, n] -> [m, r])
    return proj.T @ g if left else g @ proj


def _project_back(gp, proj, left: bool):
    return proj @ gp if left else gp @ proj.T


def _left(shape) -> bool:
    return shape[0] <= shape[1]


def _low_rank_shape(shape, rank: int):
    return (rank, shape[1]) if _left(shape) else (shape[0], rank)


def _adam_leaf(p, g, m, v, b1, b2, eps, lr, c1, c2) -> None:
    """Plain Adam on one leaf, moments in the leaf's dtype (JAX's zeros_like)."""
    g = g.to(m.dtype)
    m.mul_(b1).add_(g * (1 - b1))
    v.mul_(b2).add_(g * g * (1 - b2))
    p.add_((-lr * (m / c1) / (torch.sqrt(v / c2) + eps)).to(p.dtype))


def _low_rank_adam(gp, m, v, b1, b2, eps, c1, c2):
    """Adam's update in the projected space (fp32 moments, in place)."""
    m.mul_(b1).add_(gp * (1 - b1))
    v.mul_(b2).add_(gp * gp * (1 - b2))
    return (m / c1) / (torch.sqrt(v / c2) + eps)


class GaLore(Optimizer):
    """GaLore over every 2-D leaf whose smaller side is at least
    max(2 rank, min_dim); other leaves take plain Adam. Per GaLore leaf the
    state is (proj [d, r], m, v) in fp32, d the smaller side: O(r max(m,
    n)) instead of O(m n). The projection is the top-r singular vectors of
    the gradient at steps 1, 1 + gap, ... (torch.linalg.svd in fp32, the
    default routine). A sliced leaf is judged, projected and updated whole
    (the module's docstring)."""

    def __init__(self, learning_rate: LR, rank: int = 8, update_proj_gap: int = 200,
                 scale: float = 0.25, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 min_dim: int = 2 * 8, grad_clip: Optional[float] = 1.0,
                 accumulation_steps: int = 1):
        super().__init__(grad_clip, accumulation_steps)
        self.lr, self.rank, self.gap, self.scale = learning_rate, rank, update_proj_gap, scale
        self.b1, self.b2, self.eps, self.min_dim = b1, b2, eps, min_dim

    def is_galore(self, x) -> bool:
        shape = whole_shape(x)
        return len(shape) == 2 and min(shape) >= max(self.rank * 2, self.min_dim)

    def _init(self, named) -> Dict[str, Any]:
        leaves = []
        for _, x in named:
            if not self.is_galore(x):
                leaves.append([torch.zeros_like(x), torch.zeros_like(x)])
                continue
            whole = whole_shape(x)
            shape = _low_rank_shape(whole, self.rank)
            f32 = dict(dtype=torch.float32, device=x.device)
            leaves.append([hold_whole(torch.zeros((min(whole), self.rank), **f32)),
                           hold_whole(torch.zeros(shape, **f32)),
                           hold_whole(torch.zeros(shape, **f32))])
        return {"leaves": leaves}

    def svd_proj(self, g, left: bool):
        """Top-r singular vectors of the gradient (the GaLore paper's
        algorithm 2): U's first r columns for a row projection, V's else."""
        u, _, vh = torch.linalg.svd(g.float(), full_matrices=False)
        return (u[:, : self.rank] if left else vh[: self.rank].T).contiguous()

    def _apply(self, named, grads, state) -> None:
        step = state["count"] + 1
        lr = _lr(self.lr, step)
        c1, c2 = bias_corrections(self.b1, self.b2, step)
        refresh = (step - 1) % self.gap == 0
        for (_, p), g, st in zip(named, grads, state["leaves"]):
            if not self.is_galore(p):
                _adam_leaf(p, g, st[0], st[1], self.b1, self.b2, self.eps, lr, c1, c2)
                continue
            proj, m, v = st
            g = whole_like(g, p)
            left = _left(g.shape)
            if refresh:
                proj.copy_(self.svd_proj(g, left))
            gp = _project(g.float(), proj, left)
            upd = _project_back(_low_rank_adam(gp, m, v, self.b1, self.b2, self.eps, c1, c2),
                                proj, left)
            p.add_((-lr * self.scale * slice_like(upd, p)).to(g.dtype).to(p.dtype))


def apollo_projection(seed: int, index: int, window: int, d: int, rank: int,
                      device) -> torch.Tensor:
    """APOLLO's random projection [d, rank] / sqrt(rank) for trainable leaf
    `index` in the projection window `window` (= (step - 1) // gap), drawn
    on the CPU by a torch.Generator seeded from (seed, index, window), so a
    CPU run and a card run draw the same numbers. (The JAX package's draws
    come from jax.random.fold_in, whose bits torch cannot reproduce.)"""
    mixed = int(np.random.SeedSequence([seed, index, window]).generate_state(1, np.uint64)[0])
    gen = torch.Generator().manual_seed(mixed & ((1 << 63) - 1))
    return (torch.randn((d, rank), generator=gen) / rank**0.5).to(device)


class Apollo(Optimizer):
    """APOLLO: Adam moments in a random rank-r projection of each 2-D leaf
    whose smaller side is at least 2 rank; the update is the full-rank
    gradient scaled per channel (the side not projected) by
    ||projected Adam update|| / (||projected gradient|| + eps). Other
    leaves take plain Adam. `projection(path, index, window, d, rank,
    device)` draws the projection; the default is `apollo_projection`. A
    sliced leaf is judged, projected and scaled whole (the module's
    docstring)."""

    def __init__(self, learning_rate: LR, rank: int = 8, update_proj_gap: int = 200,
                 scale: float = 1.0, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 seed: int = 0, projection: Optional[Callable] = None,
                 grad_clip: Optional[float] = 1.0, accumulation_steps: int = 1):
        super().__init__(grad_clip, accumulation_steps)
        self.lr, self.rank, self.gap, self.scale = learning_rate, rank, update_proj_gap, scale
        self.b1, self.b2, self.eps, self.seed = b1, b2, eps, seed
        self.projection = projection or (
            lambda path, index, window, d, rank, device:
            apollo_projection(self.seed, index, window, d, rank, device))

    def is_low_rank(self, x) -> bool:
        shape = whole_shape(x)
        return len(shape) == 2 and min(shape) >= self.rank * 2

    def _init(self, named) -> Dict[str, Any]:
        mv = []
        for _, x in named:
            if self.is_low_rank(x):
                shape = _low_rank_shape(whole_shape(x), self.rank)
                mv.append([hold_whole(torch.zeros(shape, dtype=torch.float32, device=x.device))
                           for _ in range(2)])
            else:
                mv.append([torch.zeros_like(x), torch.zeros_like(x)])
        return {"mv": mv}

    def _apply(self, named, grads, state) -> None:
        step = state["count"] + 1
        lr = _lr(self.lr, step)
        c1, c2 = bias_corrections(self.b1, self.b2, step)
        window = (step - 1) // self.gap
        for idx, ((path, p), g, (m, v)) in enumerate(zip(named, grads, state["mv"])):
            if not self.is_low_rank(p):
                _adam_leaf(p, g, m, v, self.b1, self.b2, self.eps, lr, c1, c2)
                continue
            gf = whole_like(g, p).float()
            left = _left(gf.shape)
            proj = self.projection(path, idx, window, min(gf.shape), self.rank, g.device)
            gp = _project(gf, proj, left)
            up = _low_rank_adam(gp, m, v, self.b1, self.b2, self.eps, c1, c2)
            ax = 0 if left else 1  # the projected axis; the channels are the other
            s = torch.linalg.vector_norm(up, dim=ax) / (
                torch.linalg.vector_norm(gp, dim=ax) + self.eps)
            s = s[None, :] if left else s[:, None]
            p.add_(slice_like(-lr * self.scale * gf * s, p).to(g.dtype).to(p.dtype))


def loraplus_label(path: str) -> str:
    """'b' for an adapter's B matrix (the path's last component is `b`),
    'a' for everything else (conv_b, conv_q_b ... end in the letter only)."""
    return "b" if path.split("/")[-1] == "b" else "a"


class LoraPlus(Optimizer):
    """LoRA+: AdamW (weight decay on every leaf, as optax.adamw) with the
    leaves labelled 'b' (loraplus_label) at lr x lr_ratio."""

    def __init__(self, learning_rate: LR, lr_ratio: float = 16.0, weight_decay: float = 0.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 grad_clip: Optional[float] = 1.0, accumulation_steps: int = 1):
        super().__init__(grad_clip, accumulation_steps)
        self.lr, self.ratio, self.weight_decay = learning_rate, lr_ratio, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps

    def _init(self, named) -> Dict[str, Any]:
        return {"mu": [torch.zeros_like(t) for _, t in named],
                "nu": [torch.zeros_like(t) for _, t in named]}

    def _apply(self, named, grads, state) -> None:
        c1, c2 = bias_corrections(self.b1, self.b2, state["count"] + 1)
        base = _lr(self.lr, state["count"])
        for (path, p), g, mu, nu in zip(named, grads, state["mu"], state["nu"]):
            g = g.to(mu.dtype)
            mu.mul_(self.b1).add_(g * (1.0 - self.b1))
            nu.mul_(self.b2).add_(g * g * (1.0 - self.b2))
            upd = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if self.weight_decay:
                upd = upd + self.weight_decay * p
            lr = base * self.ratio if loraplus_label(path) == "b" else base
            p.add_((upd * -lr).to(p.dtype))


def badam_block(path: str, num_blocks: int) -> int:
    """A leaf's block: its layer index (`layers/<i>` in the path) modulo
    num_blocks; leaves outside the layers join the last block."""
    m = re.search(r"layers/(\d+)", path)
    return num_blocks - 1 if m is None else int(m.group(1)) % num_blocks


class BAdam(Optimizer):
    """Block-coordinate Adam: block ((step - 1) // switch_interval) %
    num_blocks is active; only its leaves' moments advance and only they
    move (a leaf of another block is left bit-unchanged)."""

    def __init__(self, learning_rate: LR, num_blocks: int = 4, switch_interval: int = 50,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 grad_clip: Optional[float] = 1.0, accumulation_steps: int = 1):
        super().__init__(grad_clip, accumulation_steps)
        self.lr, self.num_blocks, self.switch = learning_rate, num_blocks, switch_interval
        self.b1, self.b2, self.eps = b1, b2, eps

    def active_block(self, step: int) -> int:
        return ((step - 1) // self.switch) % self.num_blocks

    def _init(self, named) -> Dict[str, Any]:
        return {"m": [torch.zeros_like(t) for _, t in named],
                "v": [torch.zeros_like(t) for _, t in named]}

    def _apply(self, named, grads, state) -> None:
        step = state["count"] + 1
        lr = _lr(self.lr, step)
        c1, c2 = bias_corrections(self.b1, self.b2, step)
        active = self.active_block(step)
        for (path, p), g, m, v in zip(named, grads, state["m"], state["v"]):
            if badam_block(path, self.num_blocks) == active:
                _adam_leaf(p, g, m, v, self.b1, self.b2, self.eps, lr, c1, c2)


PER_COORD, PER_HEAD, PER_COL = 0, 1, 2


def adam_mini_rule(path: str, x: torch.Tensor, head_dim: int = 128) -> int:
    """A leaf's Hessian block rule: per coordinate for embed / lm_head
    leaves and 1-D leaves, per head (columns in groups of head_dim) for the
    q_proj / k_proj kernels, per output column for every other kernel; a
    sliced leaf by its whole shape."""
    parts, shape = path.split("/"), whole_shape(x)
    if "embed" in parts or "lm_head" in parts or len(shape) < 2:
        return PER_COORD
    if len(parts) >= 2 and parts[-1] == "kernel" and parts[-2] in ("q_proj", "k_proj") \
            and shape[-1] % head_dim == 0:
        return PER_HEAD
    return PER_COL


class AdamMini(Optimizer):
    """Adam-mini: fp32 momentum per coordinate, the second moment one
    scalar per block of adam_mini_rule (the mean of g^2 over the block),
    decoupled weight decay on every leaf. A sliced leaf's block means are
    taken over its whole gradient (the module's docstring)."""

    def __init__(self, learning_rate: LR, head_dim: int = 128, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
                 grad_clip: Optional[float] = 1.0, accumulation_steps: int = 1):
        super().__init__(grad_clip, accumulation_steps)
        self.lr, self.head_dim, self.weight_decay = learning_rate, head_dim, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps

    def _block_mean(self, g2, rule):
        if rule == PER_COORD:
            return g2
        if rule == PER_HEAD:
            return g2.reshape(-1, g2.shape[-1] // self.head_dim, self.head_dim).mean(dim=(0, 2))
        return g2.reshape(-1, g2.shape[-1]).mean(dim=0)

    def _broadcast(self, v, rule, shape):
        if rule == PER_COORD:
            return v
        if rule == PER_HEAD:
            return v.repeat_interleave(self.head_dim).expand(shape)
        return v.expand(shape)

    def _init(self, named) -> Dict[str, Any]:
        f32 = lambda shape, t: torch.zeros(shape, dtype=torch.float32,  # noqa: E731
                                           device=t.device)
        v = []
        for path, t in named:
            rule = adam_mini_rule(path, t, self.head_dim)
            v.append(f32(t.shape, t) if rule == PER_COORD
                     else hold_whole(self._block_mean(f32(whole_shape(t), t), rule)))
        return {"m": [f32(t.shape, t) for _, t in named], "v": v}

    def _apply(self, named, grads, state) -> None:
        step = state["count"] + 1
        lr = _lr(self.lr, step)
        c1, c2 = bias_corrections(self.b1, self.b2, step)
        for (path, p), g, m, v in zip(named, grads, state["m"], state["v"]):
            rule = adam_mini_rule(path, p, self.head_dim)
            gf = g.float()
            m.mul_(self.b1).add_(gf * (1 - self.b1))
            gw = gf if rule == PER_COORD else whole_like(gf, p)
            v.mul_(self.b2).add_(self._block_mean(gw * gw, rule) * (1 - self.b2))
            vh = self._broadcast(v / c2, rule, gw.shape)
            if rule != PER_COORD:
                vh = slice_like(vh, p)
            u = -lr * ((m / c1) / (torch.sqrt(vh) + self.eps) + self.weight_decay * p.float())
            p.add_(u.to(g.dtype).to(p.dtype))


_TABLE = {"galore": GaLore, "apollo": Apollo, "loraplus": LoraPlus, "badam": BAdam,
          "adam_mini": AdamMini}


def make_custom_optimizer(name: str, learning_rate: LR, **kw) -> Optimizer:
    """The optimizer `use_optimizer` names; `kw` are its keyword arguments
    (grad_clip and accumulation_steps included)."""
    if name not in _TABLE:
        raise ValueError(f"unknown optimizer {name!r} (one of {sorted(_TABLE)})")
    return _TABLE[name](learning_rate, **kw)
