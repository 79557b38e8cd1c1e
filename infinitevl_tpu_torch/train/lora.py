"""LoRA adapters (torch port of infinitevl_tpu/train/lora.py, method
`lora` with the rsLoRA scale and the int8 QLoRA base; DoRA, PiSSA and
LoftQ are not ported yet and raise).

Adapters are a tree of their own, mirroring the params' structure:
{path: {'a': [d_in, r], 'b': [r, d_out]}}. Training optimises only that
tree: `attach_lora` hangs the factors on the frozen dense nodes as low-rank
side paths (`lora_a`, `lora_b`), so no weight-shaped copy or weight-shaped
gradient ever exists; `merge_lora` folds the adapters into the base
weights for export."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from ..models.quant import dequantize_kernel
from .step import (
    AdamW,
    apply_gradients,
    batch_to_device,
    mm_sft_loss_fn,
    sft_loss_fn,
    tree_device,
)

Params = Dict[str, Any]

_LATER = "is not ported to torch yet (plain LoRA, rsLoRA and the int8 QLoRA base are)"


def lora_scale(alpha: float, rank: int, use_rslora: bool = False) -> float:
    """Adapter scaling: alpha / r, or alpha / sqrt(r) with rank-stabilised LoRA."""
    if use_rslora:
        return alpha / float(rank) ** 0.5
    return alpha / rank


def _is_target(k, v, target) -> bool:
    kern = v.get("kernel", v.get("kernel_q")) if isinstance(v, dict) else None
    return k in target and isinstance(kern, torch.Tensor) and kern.ndim == 2


def init_lora(
    params: Params,
    generator: torch.Generator,
    rank: int = 8,
    target: Sequence[str] = ("q_proj", "k_proj", "v_proj", "o_proj"),
    dtype=torch.float32,
    method: str = "lora",
    use_dora: bool = False,
) -> Params:
    """Adapter tree mirroring params' structure: every dict node named in
    `target` that holds a 2-D 'kernel' (or the int8 'kernel_q' of a
    quantised base: the QLoRA configuration) gets {'a', 'b'} with
    a ~ N(0, 1/r) drawn from `generator` and b = 0, so the forward equals
    the base model's at init. The adapters live on the kernels' device and
    are marked trainable."""
    if method != "lora":
        raise NotImplementedError(f"init_lora: method {method!r} (PiSSA) {_LATER}")
    if use_dora:
        raise NotImplementedError(f"init_lora: use_dora (DoRA) {_LATER}")

    def walk(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if _is_target(k, v, target):
                    kern = v.get("kernel", v.get("kernel_q"))
                    d_in, d_out = kern.shape
                    a = torch.randn((d_in, rank), generator=generator,
                                    device=generator.device) / rank**0.5
                    out[k] = {
                        "a": a.to(device=kern.device, dtype=dtype).requires_grad_(True),
                        "b": torch.zeros((rank, d_out), dtype=dtype,
                                         device=kern.device).requires_grad_(True),
                    }
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
                if "m" in ad:
                    raise NotImplementedError(f"DoRA adapters ('m') {_LATER}")
                out[k] = patch(v, ad)
            else:
                out[k] = _walk_pairs(v, ad, patch)
        return out
    if isinstance(p, (list, tuple)):
        ls = l if isinstance(l, (list, tuple)) else [None] * len(p)
        return [_walk_pairs(v, lv, patch) for v, lv in zip(p, ls)]
    return p


def apply_lora(
    params: Params, lora: Params, alpha: float = 16.0, rank: int = 8,
    use_rslora: bool = False,
) -> Params:
    """Params with the LoRA deltas merged into weight-shaped kernels (the
    result shares every unpatched tensor with `params`). An int8 base node
    ('kernel_q', QLoRA) is dequantised to bfloat16 before the delta is
    added: the merged export is full precision."""
    scale = lora_scale(alpha, rank, use_rslora)

    def patch(v, ad):
        new = dict(v)
        if "kernel" not in v and "kernel_q" in v:
            new.pop("kernel_q"), new.pop("scale")
            new["kernel"] = dequantize_kernel(v)
        delta = (ad["a"] @ ad["b"]) * scale
        new["kernel"] = new["kernel"] + delta.to(new["kernel"].dtype)
        return new

    return _walk_pairs(params, lora, patch)


def attach_lora(
    params: Params, lora: Params, alpha: float = 16.0, rank: int = 8,
    use_rslora: bool = False,
) -> Params:
    """Params with the adapter factors ATTACHED as low-rank side paths:
    matched nodes gain lora_a [d_in, r] and lora_b [r, d_out] (pre-scaled by
    alpha / rank, or alpha / sqrt(rank) with rsLoRA), and the dense helper
    adds (x @ a) @ b to the frozen kernel's output. Differentiable with
    respect to the adapter leaves; the base tensors are shared, not copied."""
    scale = lora_scale(alpha, rank, use_rslora)

    def patch(v, ad):
        new = dict(v)
        new["lora_a"] = ad["a"]
        new["lora_b"] = ad["b"] * scale
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
