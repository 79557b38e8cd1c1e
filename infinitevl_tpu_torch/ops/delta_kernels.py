"""Wrapper of the Gated-DeltaNet decode-step kernel (B) in
csrc/delta_step.cu, under the name of its Pallas counterpart in
infinitevl_tpu/ops/delta_pallas.py.

A tensor on the CPU takes the plain version (ops/delta_rule.delta_rule_step);
a CUDA tensor launches the kernel or raises. Launches are counted in
`delta_step_fused_stacked.launches`."""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .delta_rule import delta_rule_step
from .norms import l2norm

KERNEL_K = 128  # the key head dim the kernel is written for


def delta_step_fused_stacked(
    q: torch.Tensor,  # [B, H, K] post-conv raw projections (pre-l2norm)
    k: torch.Tensor,
    v: torch.Tensor,  # [B, H, V]
    g: torch.Tensor,  # [B, H] log-decay
    beta: torch.Tensor,  # [B, H]
    stacked_h: torch.Tensor,  # [L, B, H, K, V] fp32, updated in place
    layer: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One decode step of DeltaNet layer `layer`: updates stacked_h[layer]
    IN PLACE (other layers untouched) and returns o [B, H, V] in v.dtype.
    Semantics of delta_rule_step, qk l2norm included."""
    name = "delta_step_fused_stacked"
    if stacked_h.device.type == "cpu":
        o, new_h = delta_rule_step(q, k, v, g, beta, stacked_h[layer], scale)
        stacked_h[layer].copy_(new_h)
        return o
    if stacked_h.device.type != "cuda":
        raise ValueError(f"{name}: device {stacked_h.device} is neither cpu nor cuda")
    B, H, K = q.shape
    V = v.shape[-1]
    L = stacked_h.shape[0]
    if stacked_h.dtype != torch.float32 or not stacked_h.is_contiguous():
        raise TypeError(f"{name}: the state must be contiguous float32")
    if stacked_h.shape != (L, B, H, K, V):
        raise ValueError(f"{name}: state shape {tuple(stacked_h.shape)} is not "
                         f"[L, {B}, {H}, {K}, {V}]")
    if K != KERNEL_K:
        raise ValueError(f"{name}: key head dim {K}, the kernel takes {KERNEL_K}")
    if not 0 <= layer < L:
        raise IndexError(f"{name}: layer {layer} outside the stack of {L}")
    shapes = dict(q=(B, H, K), k=(B, H, K), v=(B, H, V), g=(B, H), beta=(B, H))
    for arg, t in dict(q=q, k=k, v=v, g=g, beta=beta).items():
        if t.device != stacked_h.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, state on {stacked_h.device}")
        if tuple(t.shape) != shapes[arg]:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected {shapes[arg]}")
    if scale is None:
        scale = K**-0.5
    # l2norm, scale, exp(g) and beta stay in torch, as in the JAX wrapper
    qf = (l2norm(q).float() * scale).contiguous()
    kf = l2norm(k).float().contiguous()
    vf = v.float().contiguous()
    eg = torch.exp(g.float()).contiguous()
    bf = beta.float().contiguous()
    o = torch.empty((B, H, V), dtype=torch.float32, device=q.device)
    lib = _build.load_library()
    with torch.cuda.device(q.device):  # launch on the tensors' card
        _build.check(
            lib.ivl_delta_step(
                qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), eg.data_ptr(),
                bf.data_ptr(), stacked_h.data_ptr(), o.data_ptr(),
                B, H, K, V, int(layer),
                torch.cuda.current_stream(q.device).cuda_stream,
            ),
            name,
        )
    delta_step_fused_stacked.launches += 1
    return o.to(v.dtype)


delta_step_fused_stacked.launches = 0
