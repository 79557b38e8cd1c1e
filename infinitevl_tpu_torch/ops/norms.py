"""Normalization primitives (torch port of infinitevl_tpu/ops/norms.py).

Statistics are computed in float32 and cast back to the input dtype, as in
the JAX module and the reference kernels."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def rms_norm_gated(
    x: torch.Tensor,
    gate: torch.Tensor,
    weight: torch.Tensor,
    eps: float = 1e-5,
    activation: str = "silu",
) -> torch.Tensor:
    """RMSNorm(x) * act(gate); the DeltaNet output norm."""
    xf = x.float()
    gf = gate.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * weight.float()
    if activation in ("silu", "swish"):
        y = y * gf * torch.sigmoid(gf)
    elif activation == "sigmoid":
        y = y * torch.sigmoid(gf)
    else:
        raise ValueError(f"unsupported activation {activation!r}")
    return y.to(x.dtype)


def l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Row-wise L2 normalization over the last axis (fp32 internally)."""
    xf = x.float()
    ssq = (xf * xf).sum(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ssq + eps)).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)
