"""The model's weights and its configuration, made by the benchmark.

Weights are random and come from the seed alone: one normal draw and one
uniform draw on the device (a torch.Generator there), cut into the leaves
of the port's parameter layout (models/params.py: [d_in, d_out] kernels,
biases, norms, the DeltaNet's and Mamba2's fp32 per-head leaves) and
scaled in place. The program and the plain reference are both handed a
tree built here from the same seed; neither makes weights of its own."""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

# spec of one leaf: (path, shape, dtype, kind, a, b); kind "normal" is
# a + b * N(0, 1) in the served dtype, "uniform" is U(a, b) in fp32 and
# "logu" / "softplus_inv_logu" are fp32 transforms of a uniform draw.
Leaf = Tuple[Tuple[Any, ...], Tuple[int, ...], str, str, float, float]

STD = 0.02  # every kernel and bias
NORM_NOISE = 0.05  # norm weights are 1 + this * N(0, 1)


def port_config(spec: Dict[str, Any]):
    """The port's InfiniteVLConfig for a configuration file's sizes."""
    from infinitevl_tpu_torch.config import InfiniteVLConfig, TextConfig, VisionConfig

    text = dict(spec["text"])
    for k in ("layer_types", "mrope_section"):
        if text.get(k) is not None:
            text[k] = tuple(text[k])
    vision = dict(spec["vision"])
    vision["fullatt_block_indexes"] = tuple(vision["fullatt_block_indexes"])
    ids = {k: v for k, v in spec.items() if k.endswith("_token_id")}
    return InfiniteVLConfig(text=TextConfig(**text), vision=VisionConfig(**vision), **ids)


def _linear(path, d_in, d_out, bias, dt) -> List[Leaf]:
    out = [(path + ("kernel",), (d_in, d_out), dt, "normal", 0.0, STD)]
    if bias:
        out.append((path + ("bias",), (d_out,), dt, "normal", 0.0, STD))
    return out


def _norm(path, d, dt) -> List[Leaf]:
    return [(path, (d,), dt, "normal", 1.0, NORM_NOISE)]


def _mlp(path, d, i, bias, dt) -> List[Leaf]:
    return (_linear(path + ("gate",), d, i, bias, dt) + _linear(path + ("up",), d, i, bias, dt)
            + _linear(path + ("down",), i, d, bias, dt))


def text_leaves(S, dt: str, root=("text",)) -> List[Leaf]:
    """The decoder's leaves for sizes S (reference.infinitevl.Sizes)."""
    D, I, W = S.D, S.I, S.conv
    conv_std = 1.0 / math.sqrt(W) / math.sqrt(3.0)  # the kaiming-uniform taps' spread
    leaves: List[Leaf] = [(root + ("embed",), (S.V, D), dt, "normal", 0.0, STD)]
    leaves += _norm(root + ("final_norm",), D, dt)
    if not S.tied:
        leaves.append((root + ("lm_head",), (D, S.V), dt, "normal", 0.0, STD))
    for i, role in enumerate(S.roles):
        p = root + ("layers", i)
        leaves += _norm(p + ("input_norm",), D, dt) + _norm(p + ("post_norm",), D, dt)
        if role in ("swa", "full"):
            leaves += (_linear(p + ("q_proj",), D, S.Hq * S.Dh, True, dt)
                       + _linear(p + ("k_proj",), D, S.Hkv * S.Dh, True, dt)
                       + _linear(p + ("v_proj",), D, S.Hkv * S.Dh, True, dt)
                       + _linear(p + ("o_proj",), S.Hq * S.Dh, D, False, dt))
        elif role == "delta":
            H = S.H
            HK, KD, HV = H * S.K, S.KD, H * S.Vd
            for n, o in (("q_proj", HK), ("k_proj", KD), ("v_proj", HV), ("a_proj", H),
                         ("b_proj", H), ("g_proj", HV)):
                leaves += _linear(p + (n,), D, o, False, dt)
            leaves += _linear(p + ("o_proj",), HV, D, False, dt)
            leaves += [(p + ("A_log",), (H,), "float32", "logu", 1e-4, 16.0),
                       (p + ("dt_bias",), (H,), "float32", "softplus_inv_logu", 1e-3, 0.1)]
            leaves += _norm(p + ("o_norm",), S.Vd, dt)
            for n, d in (("q", HK), ("k", KD), ("v", HV)):
                leaves.append((p + (f"conv_{n}_w",), (W, d), dt, "normal", 0.0, conv_std))
                if S.conv_bias:
                    leaves.append((p + (f"conv_{n}_b",), (d,), dt, "normal", 0.0, STD))
        else:  # mamba2
            H, Dh = S.Hq, S.Dh
            HD = H * Dh
            for n in ("q_proj", "k_proj", "v_proj"):
                leaves += _linear(p + (n,), D, HD, True, dt)
            leaves += (_linear(p + ("o_proj",), HD, D, False, dt)
                       + _linear(p + ("dt_proj",), D, H, False, dt)
                       + _linear(p + ("g_proj",), D, HD, False, dt))
            leaves += [(p + ("conv_w",), (W, 3 * HD), dt, "normal", 0.0, conv_std),
                       (p + ("conv_b",), (3 * HD,), dt, "normal", 0.0, STD),
                       (p + ("dt_bias",), (H,), "float32", "softplus_inv_logu", 1e-3, 0.1),
                       (p + ("A_log",), (H,), "float32", "logu", 1.0, 16.0),
                       (p + ("D",), (H,), "float32", "uniform", 0.5, 1.5)]
            leaves += _norm(p + ("o_norm",), Dh, dt)
        leaves += _mlp(p + ("mlp",), D, I, False, dt)
    return leaves


def vision_leaves(S, dt: str, root=("visual",)) -> List[Leaf]:
    """The ViT's leaves for sizes S (reference.infinitevl.Sizes)."""
    D, I = S.vD, S.vI
    in_feat = S.in_ch * S.tps * S.ps ** 2
    leaves: List[Leaf] = [(root + ("patch_embed",), (in_feat, D), dt, "normal", 0.0, STD)]
    for j in range(S.v_depth):
        p = root + ("blocks", j)
        leaves += _norm(p + ("norm1",), D, dt) + _norm(p + ("norm2",), D, dt)
        leaves += _linear(p + ("qkv",), D, 3 * D, True, dt) + _linear(p + ("proj",), D, D, True, dt)
        leaves += _mlp(p + ("mlp",), D, I, True, dt)
    merged = D * S.m * S.m
    m = root + ("merger",)
    leaves += _norm(m + ("ln_q",), D, dt)
    leaves += _linear(m + ("fc1",), merged, merged, True, dt)
    leaves += _linear(m + ("fc2",), merged, S.v_out, True, dt)
    return leaves


def _put(tree, path, value) -> None:
    node = tree
    for k, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= k:
                node.append(None)
            if node[k] is None:
                node[k] = [] if isinstance(nxt, int) else {}
            node = node[k]
        else:
            node = node.setdefault(k, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value


def _torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def torch_seed(seed: int) -> int:
    """A generator seed for any whole number the driver may pass."""
    return int(seed) % (2 ** 63)


def build(spec: Dict[str, Any], seed: int, device, with_vision: bool = True) -> Dict[str, Any]:
    """The parameter tree of configuration `spec` for `seed` on `device`:
    {'text': ..., 'visual': ...} in the port's layout, in the served dtype
    (the per-head fp32 leaves in fp32). Two large draws, then views."""
    from reference.infinitevl import Sizes

    S = Sizes(spec)
    dt = spec["dtype"]
    leaves = text_leaves(S, dt) + (vision_leaves(S, dt) if with_vision else [])
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed))
    n_norm = {d: 0 for d in ("bfloat16", "float32")}
    n_unif = 0
    for _, shape, d, kind, _, _ in leaves:
        n = int(np.prod(shape))
        if kind == "normal":
            n_norm[d] += n
        else:
            n_unif += n
    bufs = {d: torch.randn(n, generator=gen, device=device, dtype=_torch_dtype(d))
            for d, n in n_norm.items() if n}
    unif = torch.rand(max(n_unif, 1), generator=gen, device=device, dtype=torch.float32)
    offs = {d: 0 for d in n_norm}
    uoff = 0
    tree: Dict[str, Any] = {}
    for path, shape, d, kind, a, b in leaves:
        n = int(np.prod(shape))
        if kind == "normal":
            t = bufs[d][offs[d]: offs[d] + n].view(shape)
            offs[d] += n
            t.mul_(b)
            if a:
                t.add_(a)
        else:
            u = unif[uoff: uoff + n].view(shape)
            uoff += n
            if kind == "uniform":
                t = u * (b - a) + a
            elif kind == "logu":  # log of U(a, b)
                t = torch.log(u * (b - a) + a)
            elif kind == "softplus_inv_logu":  # softplus^-1 of a log-uniform dt in [a, b]
                dtv = torch.exp(u * (math.log(b) - math.log(a)) + math.log(a))
                t = dtv + torch.log(-torch.expm1(-dtv))
            else:
                raise ValueError(kind)
            t = t.to(_torch_dtype(d))
        _put(tree, path, t)
    tree["text"]["inv_freq"] = inv_freq(spec["text"], device)
    return tree


def inv_freq(text: Dict[str, Any], device) -> torch.Tensor:
    """The rotary frequencies of the default rope: theta ** (-2i / head_dim)."""
    if text["rope_type"] != "default":
        raise ValueError(f"rope_type {text['rope_type']!r}: the benchmark's configurations use "
                         "the default rope")
    d = text["head_dim"]
    f = 1.0 / text["rope_theta"] ** (np.arange(0, d, 2, dtype=np.float64) / d)
    return torch.as_tensor(f, dtype=torch.float32, device=device)

