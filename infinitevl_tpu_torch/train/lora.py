"""LoRA adapters (torch port of infinitevl_tpu/train/lora.py): plain LoRA
with the rsLoRA scale and the int8 QLoRA base, DoRA (`use_dora`), and the
PiSSA (`pissa_decompose`) and LoftQ (`loftq_init`) initialisations.

Adapters are a tree of their own, mirroring the params' structure:
{path: {'a': [d_in, r], 'b': [r, d_out]}} (DoRA adds 'm' [d_out]).
Training optimises only that tree: `attach_lora` hangs the factors on the
frozen dense nodes as low-rank side paths (`lora_a`, `lora_b`, and DoRA's
`dora_m`), so no weight-shaped copy or weight-shaped gradient ever
exists; `merge_lora` folds the adapters into the base weights for export.
PiSSA and LoftQ are library functions, as in JAX: no hparam reaches them."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ..models.quant import dequantize_kernel, quantize_kernel
from ..models.text import dora_column_norms as _dora_column_norms
from .step import (
    AdamW,
    apply_gradients,
    batch_to_device,
    mm_sft_loss_fn,
    sft_loss_fn,
    tree_device,
)

Params = Dict[str, Any]

TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj")


def lora_scale(alpha: float, rank: int, use_rslora: bool = False) -> float:
    """Adapter scaling: alpha / r, or alpha / sqrt(r) with rank-stabilised LoRA."""
    if use_rslora:
        return alpha / float(rank) ** 0.5
    return alpha / rank


def _is_target(k, v, target) -> bool:
    kern = v.get("kernel", v.get("kernel_q")) if isinstance(v, dict) else None
    return k in target and isinstance(kern, torch.Tensor) and kern.ndim == 2


def _principal(w: torch.Tensor, rank: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(U_r sqrt(S_r), sqrt(S_r) V_r^T) of fp32 w: its rank-r principal part."""
    u, sv, vt = torch.linalg.svd(w, full_matrices=False)
    sr = torch.sqrt(sv[:rank])
    return u[:, :rank] * sr[None, :], sr[:, None] * vt[:rank]


def _trainable(t: torch.Tensor, dtype) -> torch.Tensor:
    return t.detach().to(dtype).requires_grad_(True)


@torch.no_grad()
def _adapter(v: Params, generator, rank: int, dtype, method: str, use_dora: bool) -> Params:
    kern = v.get("kernel", v.get("kernel_q"))
    if "kernel" not in v and (method == "pissa" or use_dora):
        raise ValueError("PiSSA/DoRA need the full-precision base kernel per step; re-load "
                         "the base unquantized or use plain LoRA (the QLoRA configuration)")
    d_in, d_out = kern.shape
    if method == "pissa":
        a, b = _principal(v["kernel"].float(), rank)
    else:
        a = torch.randn((d_in, rank), generator=generator, device=generator.device) / rank**0.5
        b = torch.zeros((rank, d_out), device=kern.device)
    out = {"a": _trainable(a.to(kern.device), dtype), "b": _trainable(b, dtype)}
    if use_dora:
        out["m"] = _trainable(torch.sqrt((v["kernel"].float() ** 2).sum(dim=0)), dtype)
    return out


def init_lora(
    params: Params,
    generator: Optional[torch.Generator],
    rank: int = 8,
    target: Sequence[str] = TARGETS,
    dtype=torch.float32,
    method: str = "lora",
    use_dora: bool = False,
) -> Params:
    """Adapter tree mirroring params' structure: every dict node named in
    `target` that holds a 2-D 'kernel' (or the int8 'kernel_q' of a
    quantised base: the QLoRA configuration) gets {'a', 'b'}, on the
    kernel's device and trainable.

    method:
    - "lora" (any method but "pissa"): a ~ N(0, 1/r) drawn from
      `generator`, b = 0, so the forward equals the base model's at init;
    - "pissa": the kernel's principal singular components, a = U_r sqrt(S_r),
      b = sqrt(S_r) V_r^T (`generator` unused); the base must lose that part
      first (`pissa_decompose`).

    use_dora adds the trainable magnitude 'm' [d_out] = ||W||_col (DoRA): the
    effective weight is m * (W + a b) / ||W + a b||_col, the base's at init.
    PiSSA and DoRA need the full-precision kernel and raise ValueError on a
    quantised base."""

    def walk(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if _is_target(k, v, target):
                    out[k] = _adapter(v, generator, rank, dtype, method, use_dora)
                else:
                    sub = walk(v)
                    if sub is not None:
                        out[k] = sub
            return out or None
        if isinstance(node, (list, tuple)):
            return [s if s is not None else {} for s in map(walk, node)]
        return None

    return walk(params) or {}


def _walk_pairs(p, l, patch):
    """Copy of tree `p` in which every dense node with an adapter in `l` is
    replaced by patch(node, adapter)."""
    if isinstance(p, dict):
        out = {}
        for k, v in p.items():
            ad = l.get(k) if isinstance(l, dict) else None
            if isinstance(ad, dict) and "a" in ad:
                out[k] = patch(v, ad)
            else:
                out[k] = _walk_pairs(v, ad, patch)
        return out
    if isinstance(p, (list, tuple)):
        ls = l if isinstance(l, (list, tuple)) else [None] * len(p)
        return [_walk_pairs(v, lv, patch) for v, lv in zip(p, ls)]
    return p


@torch.no_grad()
def pissa_decompose(
    params: Params,
    generator: Optional[torch.Generator] = None,
    rank: int = 8,
    alpha: Optional[float] = None,
    target: Sequence[str] = TARGETS,
    dtype=torch.float32,
) -> Tuple[Params, Params]:
    """PiSSA: (residual base, adapter) with apply_lora(residual, adapter,
    alpha, rank) == params at init, for any alpha: the principal factors
    are divided by sqrt(alpha / rank), which apply_lora's scale restores
    (alpha defaults to rank, scale 1). Training the adapter over the
    residual trains each weight's principal directions. The residual's
    patched kernels are new tensors; every other leaf is shared."""
    lora = init_lora(params, generator, rank, target, dtype, method="pissa")
    scale = (alpha if alpha is not None else rank) / rank
    inv = 1.0 / scale**0.5

    def shrink(tree):
        if isinstance(tree, dict):
            return {k: shrink(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shrink(v) for v in tree]
        return _trainable(tree * inv, tree.dtype)

    lora = shrink(lora)

    def patch(v, ad):
        delta = ((ad["a"] @ ad["b"]) * scale).to(v["kernel"].dtype)
        return {**v, "kernel": v["kernel"] - delta}

    return _walk_pairs(params, lora, patch), lora


@torch.no_grad()
def loftq_init(
    params: Params,
    rank: int = 8,
    alpha: Optional[float] = None,
    target: Sequence[str] = TARGETS,
    iters: int = 4,
    dtype=torch.float32,
) -> Tuple[Params, Params]:
    """LoftQ for the int8 QLoRA path: per target kernel, `iters` rounds of

        Q    = int8_quantize(W - scale * A B)   (models/quant.quantize_kernel)
        A, B = SVD_r(W - dequant(Q)) / sqrt(scale)

    Returns (qbase, adapter): qbase holds 'kernel_q' + 'scale' on every
    target node (others untouched and shared), and attach / apply_lora(qbase,
    adapter, alpha, rank) approximates the full-precision W at init, where
    plain QLoRA (b = 0) starts from the quantised base. scale = alpha / rank
    is folded into the factors as in pissa_decompose."""
    scale = (alpha if alpha is not None else rank) / rank
    inv = 1.0 / scale**0.5

    def one(v):
        w = v["kernel"].float()
        a = w.new_zeros((w.shape[0], rank))
        b = w.new_zeros((rank, w.shape[1]))
        for _ in range(max(iters, 1)):
            qnode = quantize_kernel(w - scale * (a @ b))
            a, b = _principal(w - dequantize_kernel(qnode, torch.float32), rank)
            a, b = a * inv, b * inv
        node = {kk: vv for kk, vv in v.items() if kk != "kernel"}
        node.update(qnode)
        return node, {"a": _trainable(a, dtype), "b": _trainable(b, dtype)}

    def walk(node):
        if isinstance(node, dict):
            qb, ad = {}, {}
            for k, v in node.items():
                if isinstance(v, dict) and k in target and isinstance(
                        v.get("kernel"), torch.Tensor) and v["kernel"].ndim == 2:
                    qb[k], ad[k] = one(v)
                else:
                    qb[k], sub = walk(v)
                    if sub is not None:
                        ad[k] = sub
            return qb, (ad or None)
        if isinstance(node, (list, tuple)):
            pairs = [walk(v) for v in node]
            return [q for q, _ in pairs], [a if a is not None else {} for _, a in pairs]
        return node, None

    qbase, adapter = walk(params)
    return qbase, adapter or {}


def apply_lora(
    params: Params, lora: Params, alpha: float = 16.0, rank: int = 8,
    use_rslora: bool = False,
) -> Params:
    """Params with the LoRA deltas merged into weight-shaped kernels (the
    result shares every unpatched tensor with `params`); a DoRA adapter
    ('m') folds its magnitude / direction split into the merged kernel. An
    int8 base node ('kernel_q', QLoRA) is dequantised to bfloat16 before
    the delta is added: the merged export is full precision."""
    scale = lora_scale(alpha, rank, use_rslora)

    def patch(v, ad):
        new = dict(v)
        if "kernel" not in v and "kernel_q" in v:
            new.pop("kernel_q"), new.pop("scale")
            new["kernel"] = dequantize_kernel(v)
        base = new["kernel"]
        merged = base + ((ad["a"] @ ad["b"]) * scale).to(base.dtype)
        if "m" in ad:
            norms = _dora_column_norms(base, ad["a"], ad["b"] * scale)
            merged = merged * (ad["m"].float() / norms).to(merged.dtype)[None, :]
        new["kernel"] = merged
        return new

    return _walk_pairs(params, lora, patch)


def attach_lora(
    params: Params, lora: Params, alpha: float = 16.0, rank: int = 8,
    use_rslora: bool = False,
) -> Params:
    """Params with the adapter factors ATTACHED as low-rank side paths:
    matched nodes gain lora_a [d_in, r] and lora_b [r, d_out] (pre-scaled by
    alpha / rank, or alpha / sqrt(rank) with rsLoRA), and the dense helper
    adds (x @ a) @ b to the frozen kernel's output. A DoRA adapter also
    attaches its magnitude as dora_m [d_out]: the dense helper multiplies
    the output by m / ||W + a b||_col (fp32, differentiable in a, b and m)
    before the bias, computing the norms where the layer runs, from the
    kernel as the layer holds it (under FSDP gathered inside its
    checkpoint; under tensor parallelism the rank's slice). Differentiable
    with respect to the adapter leaves; the base tensors are shared, not
    copied."""
    scale = lora_scale(alpha, rank, use_rslora)

    def patch(v, ad):
        new = dict(v)
        new["lora_a"] = ad["a"]
        new["lora_b"] = ad["b"] * scale
        if "m" in ad:
            new["dora_m"] = ad["m"]
        return new

    return _walk_pairs(params, lora, patch)


@torch.no_grad()
def merge_lora(params: Params, lora: Params, alpha: float = 16.0, rank: int = 8,
               use_rslora: bool = False) -> Params:
    """Fold adapters into base weights (export path)."""
    return apply_lora(params, lora, alpha, rank, use_rslora)


def _lora_loss(cfg, base, lora, batch, grid_thw, video_grid_thw, alpha, rank,
               use_rslora, remat, remat_group):
    merged = attach_lora(base, lora, alpha, rank, use_rslora)
    if hasattr(cfg, "text"):  # a full config: batches may carry pixel_values
        if "text" not in merged:
            merged = {"text": merged}
        return mm_sft_loss_fn(
            merged, cfg, batch["input_ids"], batch["labels"], batch["position_ids"],
            pixel_values=batch.get("pixel_values"), grid_thw=grid_thw,
            pixel_values_videos=batch.get("pixel_values_videos"),
            video_grid_thw=video_grid_thw, segment_ids=batch.get("segment_ids"),
            remat=remat, remat_group=remat_group,
            segment_layout=batch.get("segment_layout"),
            image_rows=batch.get("image_rows"), video_rows=batch.get("video_rows"),
        )
    return sft_loss_fn(
        merged["text"] if "text" in merged else merged, cfg, batch["input_ids"],
        batch["labels"], batch["position_ids"], batch.get("segment_ids"),
        remat=remat, remat_group=remat_group, segment_layout=batch.get("segment_layout"),
    )


def make_lora_sft_step(cfg, tx: AdamW, base_params: Optional[Params] = None,
                       alpha: float = 16.0, rank: int = 8, remat: bool = False,
                       remat_group: int = 1, use_rslora: bool = False):
    """Only the adapter tree is optimised (in place); the base stays frozen
    and bit-unchanged. `cfg` may be a TextConfig (text-only SFT) or a full
    InfiniteVLConfig: with the latter, batches carrying pixel_values train
    multimodally (the grid tuples are trailing arguments).

    With base_params given here the step is (lora, opt_state, batch[,
    grid_thw, video_grid_thw]); with base_params=None it is (lora,
    opt_state, base_params, batch[, grids...])."""

    def step(lora, opt_state, batch, grid_thw=None, video_grid_thw=None, _base=None):
        base = base_params if base_params is not None else _base
        batch = batch_to_device(batch, tree_device(lora))
        loss = _lora_loss(cfg, base, lora, batch, grid_thw, video_grid_thw, alpha,
                          rank, use_rslora, remat, remat_group)
        apply_gradients(loss, lora, tx, opt_state)
        return lora, opt_state, loss.detach()

    if base_params is not None:
        return step

    def step_with_base(lora, opt_state, base, batch, grid_thw=None, video_grid_thw=None):
        return step(lora, opt_state, batch, grid_thw, video_grid_thw, _base=base)

    return step_with_base


def make_lora_eval_fn(cfg, alpha: float = 16.0, rank: int = 8, use_rslora: bool = False):
    """Loss-only twin of make_lora_sft_step: (lora, base, batch) -> mean CE
    with the adapters attached (text-only), without autograd."""
    tcfg = cfg.text if hasattr(cfg, "text") else cfg

    @torch.no_grad()
    def eval_loss(lora, base, batch):
        batch = batch_to_device(batch, tree_device(lora))
        return _lora_loss(tcfg, base, lora, batch, None, None, alpha, rank,
                          use_rslora, False, 1)

    return eval_loss
