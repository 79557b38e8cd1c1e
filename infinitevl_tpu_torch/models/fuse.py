"""Inference-time projection fusion: one matmul per projection group
(torch port of infinitevl_tpu/models/fuse.py).

Concatenating a layer's input projections along the OUTPUT dimension turns
the group into one wide matmul whose column slices are the unfused
outputs (the contraction and its order per output element are unchanged).
Opt-in (`fuse=True` on Generator / StreamingEngine); whether it pays is
shape- and card-dependent, so measure before use.

Fused groups (the names models/text.py and models/vision.py look for):

- SWA layer:      q/k/v        -> ``qkv_proj``   [D, (Hq + 2 Hkv) Dh]
- DeltaNet layer: q/k/v/a/b/g  -> ``fused_proj`` [D, 2 HK + VD + 2 H + HV]
- every SwiGLU MLP: gate/up    -> ``gate_up``    [D, 2 I]
- ViT blocks: qkv is fused by construction; the MLP fuses as above.

Apply it to a loaded tree right before building an engine, and before
quantizing (quantize_params targets the fused names too)."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..config import InfiniteVLConfig

Params = Dict[str, Any]


def _fuse_group(layer: Params, names, out_key: str) -> Params:
    """Concat the named linear sub-dicts along the output dim (idempotent)."""
    if out_key in layer or any(n not in layer for n in names):
        return layer
    kernels = [layer[n]["kernel"] for n in names]
    fused = {"kernel": torch.cat(kernels, dim=1)}
    if any("bias" in layer[n] for n in names):
        fused["bias"] = torch.cat([
            layer[n]["bias"] if "bias" in layer[n]
            else torch.zeros_like(layer[n]["kernel"][0])
            for n in names
        ])
    new = {k: v for k, v in layer.items() if k not in names}
    new[out_key] = fused
    return new


def _fuse_mlp(mlp: Params) -> Params:
    if "gate" in mlp and "up" in mlp:
        return _fuse_group(mlp, ("gate", "up"), "gate_up")
    return mlp


ALL_GROUPS = frozenset({"qkv", "delta", "mlp"})


def _fuse_text_layer(layer: Params, groups=ALL_GROUPS) -> Params:
    if "conv_q_w" in layer:  # DeltaNet flavor
        if "delta" in groups:
            layer = _fuse_group(
                layer,
                ("q_proj", "k_proj", "v_proj", "a_proj", "b_proj", "g_proj"),
                "fused_proj",
            )
    elif "conv_w" in layer:  # Mamba2 flavor: kept as it is, as in JAX
        pass
    elif "q_proj" in layer and "qkv" in groups:  # SWA / full-attention flavor
        layer = _fuse_group(layer, ("q_proj", "k_proj", "v_proj"), "qkv_proj")
    if "mlp" in layer and "mlp" in groups:
        layer = dict(layer)
        layer["mlp"] = _fuse_mlp(layer["mlp"])
    return layer


def fuse_projections(
    params: Params,
    cfg: Optional[InfiniteVLConfig] = None,
    groups=ALL_GROUPS,
) -> Params:
    """Return a new params tree with the per-layer projection groups fused.
    `groups` is a subset of {"qkv", "delta", "mlp"}. Accepts the full
    {'text', 'visual'} tree or a bare text tree. The input tree is not
    modified; fused kernels are new tensors, so drop the original tree
    afterwards to free its memory."""
    del cfg  # the layer flavor is detected structurally
    groups = frozenset(groups)
    out = dict(params)
    text = params.get("text", params if "layers" in params else None)
    if text is not None:
        new_text = dict(text)
        new_text["layers"] = [_fuse_text_layer(lp, groups) for lp in text["layers"]]
        if "text" in params:
            out["text"] = new_text
        else:
            out = new_text
    if "visual" in params and "mlp" in groups:
        vis = dict(params["visual"])
        vis["blocks"] = [{**b, "mlp": _fuse_mlp(b["mlp"])} for b in vis["blocks"]]
        out["visual"] = vis
    return out


def is_fused(params: Params) -> bool:
    text = params.get("text", params)
    return any("qkv_proj" in lp or "fused_proj" in lp for lp in text.get("layers", ()))
