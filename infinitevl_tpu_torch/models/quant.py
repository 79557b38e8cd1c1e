"""Weight-only int8 / int4 quantization for serving (torch port of
infinitevl_tpu/models/quant.py; same storage, so a tree quantized by
either package feeds the other through models/params.from_jax_numpy).

int8: per-output-channel symmetric, w[:, j] ~= q[:, j] * scale[j] with q in
[-127, 127]. Storage `kernel_q` int8 [d_in, d_out] + `scale` fp32 [d_out].
The dense helpers compute (x @ q.to(x.dtype)) * scale: column scales
commute with the contraction, so this is exact dequant-then-matmul.

int4: group-wise symmetric over `group_size` input rows per output column,
q in [-7, 7], nibble-packed by hand. Storage `kernel_q4` uint8
[d_in/2, d_out]: packed row r carries original row r in its LOW nibble and
row r + d_in/2 in its HIGH nibble; `scale4` fp32 [G, d_out]. Groups never
straddle the half split; when d_in/2 is not a multiple of the group size
the whole column becomes one group (G = 1). On a CUDA tensor the dense
helpers run every int4 node through the fused unpack-matmul kernel
(ops/int4_kernels.int4_matmul_fused); `int4_matmul` below is the dual-plane
formulation of the JAX package, kept as a second reference.

Embedding (`quantize_embed`): row-wise int8 `embed_q` [vocab, hidden] +
`embed_scale` [vocab] in the table's dtype (the activation dtype rides on
it) + a pre-transposed `head_q` [hidden, vocab] for the tied head; an
untied head becomes `lm_head_q` [hidden, vocab] + `lm_head_scale`.

Quantization runs on the device the weights live on, one node at a time.
Biased nibble storage (`kernel_q4b`) is not ported."""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

Params = Dict[str, Any]

# Projections worth quantizing: the large 2D matmuls. Norm / conv / bias /
# rope leaves stay in high precision, as does the embedding unless
# quantize_embed is set.
DEFAULT_TARGETS = (
    "q_proj", "k_proj", "v_proj", "o_proj", "a_proj", "b_proj", "g_proj",
    "gate", "up", "down", "dt_proj", "qkv", "proj", "fc1", "fc2",
    "gate_up", "qkv_proj", "fused_proj",
)


def _biased_not_ported():
    raise NotImplementedError(
        "biased int4 storage (kernel_q4b) is not ported to torch: no entry "
        "point of the JAX package produces it"
    )


def quantize_kernel(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-output-channel symmetric int8: returns {'kernel_q', 'scale'}."""
    wf = w.float()
    amax = wf.abs().amax(dim=0)  # [d_out]
    scale = amax.clamp(min=1e-8) / 127.0
    q = torch.round(wf / scale[None, :]).clamp(-127, 127).to(torch.int8)
    return {"kernel_q": q, "scale": scale}


def dequantize_kernel(node: Dict[str, torch.Tensor], dtype=torch.bfloat16) -> torch.Tensor:
    return (node["kernel_q"].float() * node["scale"][None, :]).to(dtype)


def quantize_embed_rows(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-ROW symmetric int8 for the embedding table plus a pre-transposed
    int8 copy for the tied head: w[i, :] ~= q[i, :] * scale[i]. The scale
    is stored in w's dtype and q is computed against the stored scale."""
    wf = w.float()
    amax = wf.abs().amax(dim=1)  # [vocab]
    scale = (amax.clamp(min=1e-8) / 127.0).to(w.dtype)
    q = torch.round(wf / scale.float()[:, None]).clamp(-127, 127).to(torch.int8)
    return {"embed_q": q, "embed_scale": scale, "head_q": q.t().contiguous()}


def quantize_kernel_int4(
    w: torch.Tensor, group_size: int = 128, biased: bool = False
) -> Dict[str, torch.Tensor]:
    """Group-wise symmetric int4, nibble-packed into uint8 (layout in the
    module docstring): returns {'kernel_q4', 'scale4'}."""
    if biased:
        _biased_not_ported()
    wf = w.float()
    d_in, d_out = wf.shape
    if d_in % 2:
        raise ValueError(f"int4 packing needs even d_in, got {d_in}")
    if (d_in // 2) % group_size:
        group_size = d_in
    G = d_in // group_size
    wg = wf.reshape(G, group_size, d_out)
    amax = wg.abs().amax(dim=1)  # [G, d_out]
    scale = amax.clamp(min=1e-8) / 7.0
    q = torch.round(wg / scale[:, None, :]).clamp(-7, 7)
    q = q.reshape(d_in, d_out).to(torch.int32)
    half = d_in // 2
    packed = (q[:half] & 0xF) | ((q[half:] & 0xF) << 4)
    return {"kernel_q4": packed.to(torch.uint8), "scale4": scale}


def unpack_int4(
    packed: torch.Tensor, dtype=torch.bfloat16, biased: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[d_in/2, d_out] uint8 -> (lo, hi), each [d_in/2, d_out] in `dtype`
    with values in [-7, 7]."""
    if biased:
        _biased_not_ported()
    p = packed.to(torch.int16)
    lo = p & 0xF
    hi = p >> 4
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    return lo.to(dtype), hi.to(dtype)


def _int4_storage(node: Dict[str, torch.Tensor]) -> torch.Tensor:
    if "kernel_q4b" in node:
        _biased_not_ported()
    q = node.get("kernel_q4", node.get("kernel_q4f"))
    if q is None:
        raise ValueError("not an int4 node: neither kernel_q4 nor kernel_q4f")
    return q


def int4_matmul(x: torch.Tensor, node: Dict[str, torch.Tensor]) -> torch.Tensor:
    """x @ dequant(node) in the dual-plane formulation: each nibble plane
    contracts against its half of x, one batched product over the groups of
    a plane, the group scales (cast to x's dtype) applied to the per-group
    outputs. Everything runs in x's dtype."""
    q = _int4_storage(node)
    s = node["scale4"].to(x.dtype)
    half, d_out = q.shape
    lo, hi = unpack_int4(q, x.dtype)
    G = s.shape[0]
    if G == 1:
        return (x[..., :half] @ lo + x[..., half:] @ hi) * s[0]
    lead = x.shape[:-1]
    g2 = G // 2
    gs = half // g2

    def plane(xh, w, sh):
        xg = xh.reshape(-1, g2, gs).permute(1, 0, 2)  # [g2, M, gs]
        yg = torch.bmm(xg, w.reshape(g2, gs, d_out))  # [g2, M, d_out]
        return (yg * sh[:, None, :]).sum(0)

    y = plane(x[..., :half], lo, s[:g2]) + plane(x[..., half:], hi, s[g2:])
    return y.reshape(*lead, d_out)


def dequantize_kernel_int4(node: Dict[str, torch.Tensor], dtype=torch.bfloat16) -> torch.Tensor:
    q = _int4_storage(node)
    s = node["scale4"]
    half, d_out = q.shape
    lo, hi = unpack_int4(q, torch.float32)
    w = torch.cat([lo, hi], dim=0)
    G = s.shape[0]
    wg = w.reshape(G, 2 * half // G, d_out) * s[:, None, :]
    return wg.reshape(2 * half, d_out).to(dtype)


def prefer_fused_int4(params: Params) -> Params:
    """Rekey every int4 node kernel_q4 -> kernel_q4f. In the JAX package
    the key selects the fused kernel for the nodes its tiling can take; in
    the port both keys go through the same kernel, which takes every node
    that quantize_params produces, so this only renames."""

    def walk(node):
        if isinstance(node, dict):
            return {("kernel_q4f" if k == "kernel_q4" and getattr(v, "ndim", 0) == 2 else k):
                    walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)


def quantize_params(
    params: Params,
    targets: Sequence[str] = DEFAULT_TARGETS,
    min_size: int = 65536,
    bits: int = 8,
    group_size: int = 128,
    int4_biased: bool = False,
    quantize_embed: bool = False,
) -> Params:
    """Replace each targeted dense node's 'kernel' with int8 (per-channel)
    or int4 (group-wise) storage. Structure-preserving otherwise; nodes
    smaller than `min_size` elements keep full precision, and a node with
    odd d_in falls back to int8 under bits=4. `quantize_embed` also
    converts the text `embed` table (and an untied `lm_head`) to row-wise
    int8, always int8. The input tree is not modified."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if int4_biased:
        _biased_not_ported()

    def quant(kernel):
        if bits == 4 and kernel.shape[0] % 2 == 0:
            return quantize_kernel_int4(kernel, group_size)
        return quantize_kernel(kernel)  # odd d_in cannot nibble-pack

    def is_matrix(v):
        return isinstance(v, torch.Tensor) and v.ndim == 2 and v.numel() >= min_size

    def walk(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k in targets and isinstance(v, dict) and is_matrix(v.get("kernel")):
                    new = {kk: vv for kk, vv in v.items() if kk != "kernel"}
                    new.update(quant(v["kernel"]))
                    out[k] = new
                elif quantize_embed and k == "embed" and is_matrix(v):
                    out.update(quantize_embed_rows(v))
                elif quantize_embed and k == "lm_head" and is_matrix(v):
                    # an untied head [hidden, vocab] is already in the
                    # contraction layout: per-output-column int8
                    qn = quantize_kernel(v)
                    out["lm_head_q"] = qn["kernel_q"]
                    out["lm_head_scale"] = qn["scale"].to(v.dtype)
                else:
                    out[k] = walk(v)
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)


def quantized_bytes(params: Params) -> int:
    """Bytes held by the tree's tensors."""
    if isinstance(params, dict):
        return sum(quantized_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(quantized_bytes(v) for v in params)
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    return 0
