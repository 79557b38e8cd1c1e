"""Plain fp32 reference of InfiniteVL: the Qwen2.5-VL ViT, the hybrid decoder
(sliding-window GQA with mRoPE, gated DeltaNet, Mamba2 SSD, SwiGLU MLP) and
the tied head, written from the model's equations in plain torch. It
imports nothing of the program and runs whole sequences: no cache, no
batching, no kernels. Every number is fp32; `fp32_exact()` turns TF32 off.

It reads the configuration file's sizes (configs/<name>.json) and a weight
tree in the port's layout ([d_in, d_out] kernels), which the benchmark
builds from the seed (harness/weights.py) and hands to both sides.

Conventions of the served model that the reference keeps:
- the short convolutions of a multi-token call start from zero history
  (the deployed model's quirk): `conv_start[t]` is the first position that
  token t's taps may read, the start of the call that holds it;
- the sliding window counts positions in the token stream (key j is seen
  by query i when i - W < j <= i), whatever the mRoPE positions are;
- the ring of an SWA layer holds the post-rotary keys and the values of
  the last W positions, position p in slot p % W.

`matmul` selects the linear layers' arithmetic: `mm_fp32` for the
reference, `mm_fp8` (operands rounded to per-tensor scaled float8 e4m3)
for the control that a correct comparison has to reject."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Tree = Dict[str, Any]
MatMul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
FP8_MAX = 448.0  # the largest float8 e4m3 value


def fp32_exact() -> None:
    """fp32 matmuls and convolutions without TF32 on this process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def mm_fp32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x.float() @ w.float()


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one scale for the tensor (its largest
    magnitude maps to 448), returned in fp32."""
    t = t.float()
    s = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def mm_fp8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return round_fp8(x) @ round_fp8(w)


# ----------------------------------------------------------------------------
# sizes
# ----------------------------------------------------------------------------

class Sizes:
    """The sizes of a configuration file, with the derived ones."""

    def __init__(self, spec: Dict[str, Any]):
        t, v = spec["text"], spec["vision"]
        self.t, self.v = t, v
        self.D = t["hidden_size"]
        self.I = t["intermediate_size"]
        self.V = t["vocab_size"]
        self.L = t["num_hidden_layers"]
        self.Hq, self.Hkv, self.Dh = (t["num_attention_heads"], t["num_key_value_heads"],
                                      t["head_dim"])
        self.W = t["sliding_window"]
        self.conv = t["conv_size"]
        self.H = t["num_linear_heads"]
        self.K = t["linear_head_dim"]
        self.KD = t["num_linear_key_value_heads"] * self.K
        self.conv_bias = t["conv_bias"]
        self.Vd = int(self.K * t["expand_v"])  # DeltaNet value head dim
        self.eps, self.norm_eps = t["rms_norm_eps"], t["norm_eps"]
        self.theta = t["rope_theta"]
        self.mrope = tuple(t["mrope_section"])
        self.tied = t["tie_word_embeddings"]
        types = t["layer_types"] or ["linear_attention" if i % 4 else "sliding_attention"
                                     for i in range(self.L)]
        alias = {"sliding_attention": "swa", "chunked_attention": "swa",
                 "full_attention": "full", "mamba2": "mamba2"}
        self.roles = [alias.get(x, "delta") for x in types]
        self.vD, self.vI, self.vH = v["hidden_size"], v["intermediate_size"], v["num_heads"]
        self.v_depth, self.v_out, self.in_ch = v["depth"], v["out_hidden_size"], v["in_channels"]
        self.ps, self.tps, self.m = v["patch_size"], v["temporal_patch_size"], v["spatial_merge_size"]
        self.win_patches = (v["window_size"] // self.m // self.ps) * self.m
        self.full_blocks = set(v["fullatt_block_indexes"])
        self.tokens_per_second = v["tokens_per_second"]
        self.image_token_id = spec["image_token_id"]
        self.vision_start_token_id = spec["vision_start_token_id"]


# ----------------------------------------------------------------------------
# small pieces
# ----------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def linear(x: torch.Tensor, p: Tree, mm: MatMul) -> torch.Tensor:
    y = mm(x, p["kernel"])
    return y + p["bias"].float() if "bias" in p else y


def swiglu(x: torch.Tensor, p: Tree, mm: MatMul) -> torch.Tensor:
    return linear(F.silu(linear(x, p["gate"], mm)) * linear(x, p["up"], mm), p["down"], mm)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def attend(q, k, v, mask, scale) -> torch.Tensor:
    """softmax(q k^T * scale) v over [H, Tq, D] x [H, Tk, D], mask [Tq, Tk]."""
    s = torch.einsum("hqd,hkd->hqk", q, k) * scale
    s = s.masked_fill(~mask[None], float("-inf"))
    return torch.einsum("hqk,hkd->hqd", torch.softmax(s, dim=-1), v)


def l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + eps)


# ----------------------------------------------------------------------------
# vision
# ----------------------------------------------------------------------------

def normalize_patchify(frame: torch.Tensor, S: Sizes) -> torch.Tensor:
    """uint8 [H, W, 3] -> the processor's patches [H*W / ps^2, 3 * tps * ps^2]:
    CLIP-normalised, the frame repeated over the temporal patch, patches in
    the merger's order (row block, column block, row in unit, column in unit)."""
    H, W, C = frame.shape
    x = frame.float() / 255.0
    x = (x - torch.tensor(CLIP_MEAN, device=x.device)) / torch.tensor(CLIP_STD, device=x.device)
    x = x.permute(2, 0, 1)[None].expand(S.tps, C, H, W)
    gh, gw, m, ps = H // S.ps, W // S.ps, S.m, S.ps
    x = x.reshape(1, S.tps, C, gh // m, m, ps, gw // m, m, ps)
    x = x.permute(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return x.reshape(gh * gw, C * S.tps * ps * ps).contiguous()


def _patch_rows_cols(gh: int, gw: int, m: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    i = torch.arange(gh * gw, device=device)
    wm, hm = i % m, (i // m) % m
    wb, hb = (i // (m * m)) % (gw // m), i // (m * m * (gw // m))
    return hb * m + hm, wb * m + wm


def vit_frame(vp: Tree, S: Sizes, patches: torch.Tensor, gh: int, gw: int,
              mm: MatMul = mm_fp32) -> torch.Tensor:
    """One frame's patches [gh*gw, in] through the ViT and the merger:
    [gh*gw / m^2, out] in row-major order of the merged grid."""
    dev = patches.device
    Dh = S.vD // S.vH
    x = mm(patches, vp["patch_embed"])
    rows, cols = _patch_rows_cols(gh, gw, S.m, dev)
    inv = 1.0 / (10000.0 ** (torch.arange(0, Dh // 2, 2, device=dev, dtype=torch.float64)
                             / (Dh // 2)))
    f = torch.cat([rows[:, None] * inv, cols[:, None] * inv], dim=-1).float()
    cos, sin = torch.cat([f, f], -1).cos()[:, None], torch.cat([f, f], -1).sin()[:, None]
    wp = S.win_patches
    win = (rows // wp) * (-(-gw // wp)) + cols // wp
    window_mask = win[:, None] == win[None, :]
    full_mask = torch.ones_like(window_mask)
    n = x.shape[0]
    for j, bp in enumerate(vp["blocks"]):
        h = rms_norm(x, bp["norm1"], 1e-6)
        qkv = linear(h, bp["qkv"], mm).reshape(n, 3, S.vH, Dh)
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        q, k = q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin
        mask = full_mask if j in S.full_blocks else window_mask
        o = attend(q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1), mask, Dh ** -0.5)
        x = x + linear(o.transpose(0, 1).reshape(n, S.vD), bp["proj"], mm)
        x = x + swiglu(rms_norm(x, bp["norm2"], 1e-6), bp["mlp"], mm)
    mg = vp["merger"]
    h = rms_norm(x, mg["ln_q"], 1e-6).reshape(n // (S.m * S.m), S.m * S.m * S.vD)
    return linear(F.gelu(linear(h, mg["fc1"], mm)), mg["fc2"], mm)


# ----------------------------------------------------------------------------
# decoder
# ----------------------------------------------------------------------------

def mrope_cos_sin(pos: torch.Tensor, S: Sizes) -> Tuple[torch.Tensor, torch.Tensor]:
    """[T, Dh] tables for positions [3, T]: each channel run of the
    (duplicated) sections takes the t, h or w axis in turn."""
    dev = pos.device
    inv = 1.0 / (S.theta ** (torch.arange(0, S.Dh, 2, device=dev, dtype=torch.float64) / S.Dh))
    freqs = pos.double()[..., None] * inv  # [3, T, Dh/2]
    emb = torch.cat([freqs, freqs], -1)
    parts, c = [], 0
    for i, n in enumerate(list(S.mrope) * 2):
        parts.append(emb[i % 3, :, c: c + n])
        c += n
    e = torch.cat(parts, -1)
    return e.cos().float(), e.sin().float()


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                conv_start: torch.Tensor) -> torch.Tensor:
    """SiLU(depthwise causal conv) over [T, C] with taps w [W, C] (tap W-1
    on the token itself); tap i of token t reads t - (W-1-i) when that is
    at or after conv_start[t], else zero."""
    T, C = x.shape
    W = w.shape[0]
    t = torch.arange(T, device=x.device)
    acc = torch.zeros_like(x)
    for i in range(W):
        s = W - 1 - i
        src = torch.cat([x.new_zeros((s, C)), x[: T - s]]) if s else x
        ok = ((t - s) >= conv_start).float()[:, None]
        acc = acc + src * ok * w[i].float()
    if b is not None:
        acc = acc + b.float()
    return F.silu(acc)


def swa_layer(p: Tree, S: Sizes, h: torch.Tensor, cos, sin, window: int, mm: MatMul,
              block: int = 2048):
    """Sliding-window GQA over the whole sequence; returns (out [T, D], the
    post-rotary keys [T, Hkv, Dh], the values)."""
    T = h.shape[0]
    q = linear(h, p["q_proj"], mm).reshape(T, S.Hq, S.Dh)
    k = linear(h, p["k_proj"], mm).reshape(T, S.Hkv, S.Dh)
    v = linear(h, p["v_proj"], mm).reshape(T, S.Hkv, S.Dh)
    c, s = cos[:, None], sin[:, None]
    q, k = q * c + rotate_half(q) * s, k * c + rotate_half(k) * s
    G = S.Hq // S.Hkv
    kh = k.repeat_interleave(G, dim=1).transpose(0, 1)  # [Hq, T, Dh]
    vh = v.repeat_interleave(G, dim=1).transpose(0, 1)
    out = torch.empty((T, S.Hq, S.Dh), device=h.device)
    for q0 in range(0, T, block):
        q1 = min(q0 + block, T)
        k0 = max(0, q0 - window + 1)
        qi = torch.arange(q0, q1, device=h.device)[:, None]
        kj = torch.arange(k0, q1, device=h.device)[None, :]
        mask = (kj <= qi) & (kj > qi - window)
        o = attend(q[q0:q1].transpose(0, 1), kh[:, k0:q1], vh[:, k0:q1], mask, S.Dh ** -0.5)
        out[q0:q1] = o.transpose(0, 1)
    return linear(out.reshape(T, -1), p["o_proj"], mm), k, v


def _chunks(x: torch.Tensor, C: int) -> torch.Tensor:
    """[T, H, *] (T a multiple of C) -> [H, N, C, *]."""
    T, H = x.shape[:2]
    return x.reshape(T // C, C, H, *x.shape[2:]).movedim(2, 0)


def _pad_t(x: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))]) if pad else x


def delta_rule(q, k, v, g, beta, state=None, chunk: int = 64):
    """Gated delta rule over [T, H, *] in fp32, in the chunked (WY) form:
    per head, S_t = (I - b_t k_t k_t^T) e^{g_t} S_{t-1} + b_t k_t v_t^T and
    o_t = S_t^T q_t, with q, k L2-normalised and q scaled by K^-1/2, from
    `state` (zero when None). Returns (o [T, H, V], final state [H, K, V])."""
    T, H, K = q.shape
    q = l2norm(q) * K ** -0.5
    k = l2norm(k)
    pad = (-T) % chunk
    q, k, v, g, beta = (_pad_t(x, pad) for x in (q, k, v, g, beta))  # pads: g = b = 0, inert
    qc, kc, vc = _chunks(q, chunk), _chunks(k, chunk), _chunks(v, chunk)  # [H, N, C, *]
    gc, bc = _chunks(g, chunk), _chunks(beta, chunk)  # [H, N, C]
    G = gc.cumsum(-1)
    C = chunk
    tri = torch.ones((C, C), dtype=torch.bool, device=q.device).tril()
    stri = tri.tril(-1)
    diff = G[..., :, None] - G[..., None, :]
    dec = torch.exp(diff.masked_fill(~tri, float("-inf")))  # e^{G_i - G_j}, i >= j
    A = (kc @ kc.transpose(-1, -2)) * dec * bc[..., :, None]
    A = A.masked_fill(~stri, 0.0)
    eye = torch.eye(C, device=q.device)
    rhs = torch.cat([kc * (bc * G.exp())[..., None], vc * bc[..., None]], -1)
    X = torch.linalg.solve_triangular(eye + A, rhs, upper=False, unitriangular=True)
    Wc, Uc = X[..., :K], X[..., K:]
    attn = (qc @ kc.transpose(-1, -2)) * dec  # lower triangle incl. the diagonal
    qg = qc * G.exp()[..., None]
    kout = kc * torch.exp(G[..., -1:] - G)[..., None]
    carry = G[..., -1].exp()  # [H, N]
    Hh, N = q.shape[1], qc.shape[1]
    Sst = q.new_zeros((Hh, K, v.shape[-1])) if state is None else state.float()
    outs = []
    for n in range(N):
        u = Uc[:, n] - Wc[:, n] @ Sst
        outs.append(qg[:, n] @ Sst + attn[:, n] @ u)
        Sst = carry[:, n, None, None] * Sst + kout[:, n].transpose(-1, -2) @ u
    o = torch.stack(outs, 1)  # [H, N, C, V]
    return o.movedim(0, 2).reshape(N * C, Hh, -1)[:T], Sst


def delta_rule_recurrent(q, k, v, g, beta):
    """The token-by-token form of `delta_rule` (its check at small sizes)."""
    T, H, K = q.shape
    q = l2norm(q) * K ** -0.5
    k = l2norm(k)
    Sst = q.new_zeros((H, K, v.shape[-1]))
    outs = []
    for t in range(T):
        Sst = Sst * g[t].exp()[:, None, None]
        err = (v[t] - torch.einsum("hk,hkv->hv", k[t], Sst)) * beta[t][:, None]
        Sst = Sst + k[t][:, :, None] * err[:, None, :]
        outs.append(torch.einsum("hk,hkv->hv", q[t], Sst))
    return torch.stack(outs), Sst


def split_scan(rule, split: int, *args):
    """`rule` over [0, split) from a zero state, then over the rest from the
    state there. Returns (out, the state at `split`)."""
    first = rule(*(a[:split] for a in args))
    if split >= args[0].shape[0]:
        return first
    rest = rule(*(a[split:] for a in args), first[1])
    return torch.cat([first[0], rest[0]]), first[1]


def gated_norm(o, gate, w, eps):
    """RMSNorm over each head's channels, times SiLU(gate)."""
    return rms_norm(o, w, eps) * F.silu(gate)


def delta_layer(p: Tree, S: Sizes, h: torch.Tensor, conv_start, split: int, mm: MatMul):
    T = h.shape[0]
    raw = {n: linear(h, p[f"{n}_proj"], mm) for n in ("q", "k", "v")}
    conv = {n: causal_conv(raw[n], p[f"conv_{n}_w"], p.get(f"conv_{n}_b"), conv_start)
            for n in raw}
    beta = torch.sigmoid(linear(h, p["b_proj"], mm))
    g = -p["A_log"].float().exp() * F.softplus(linear(h, p["a_proj"], mm) + p["dt_bias"].float())
    o, Sst = split_scan(delta_rule, split, conv["q"].reshape(T, S.H, S.K),
                        conv["k"].reshape(T, S.H, S.K), conv["v"].reshape(T, S.H, S.Vd), g, beta)
    gate = linear(h, p["g_proj"], mm).reshape(T, S.H, S.Vd)
    y = linear(gated_norm(o, gate, p["o_norm"], S.norm_eps).reshape(T, -1), p["o_proj"], mm)
    tail = {f"conv_{n}": raw[n][split - S.conv: split] for n in raw}
    return y, dict(delta_h=Sst, **tail)


def ssd(x, dt, A, Bm, Cm, state=None, chunk: int = 64):
    """Mamba2's SSD over [T, H, *] in fp32, chunked: h_t = e^{A dt_t} h_{t-1}
    + dt_t B_t x_t^T, y_t = h_t^T C_t, from `state` (zero when None).
    Returns (y, h)."""
    T = x.shape[0]
    pad = (-T) % chunk
    x, dt, Bm, Cm = (_pad_t(t, pad) for t in (x, dt, Bm, Cm))
    xc, bc, cc, dtc = _chunks(x, chunk), _chunks(Bm, chunk), _chunks(Cm, chunk), _chunks(dt, chunk)
    Lc = (A[:, None, None] * dtc).cumsum(-1)  # [H, N, C]
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    dec = torch.exp((Lc[..., :, None] - Lc[..., None, :]).masked_fill(~tri, float("-inf")))
    M = (cc @ bc.transpose(-1, -2)) * dec * dtc[..., None, :]
    y_in = M @ xc
    inj = (bc * (torch.exp(Lc[..., -1:] - Lc) * dtc)[..., None]).transpose(-1, -2) @ xc
    hop = Lc[..., -1].exp()
    H, N = x.shape[1], xc.shape[1]
    hst = x.new_zeros((H, Bm.shape[-1], x.shape[-1])) if state is None else state.float()
    ys = []
    for n in range(N):
        ys.append(y_in[:, n] + (cc[:, n] * Lc[:, n].exp()[..., None]) @ hst)
        hst = hop[:, n, None, None] * hst + inj[:, n]
    y = torch.stack(ys, 1)
    return y.movedim(0, 2).reshape(N * chunk, H, -1)[:T], hst


def ssd_recurrent(x, dt, A, Bm, Cm):
    T, H, P = x.shape
    hst = x.new_zeros((H, Bm.shape[-1], P))
    ys = []
    for t in range(T):
        hst = torch.exp(A * dt[t])[:, None, None] * hst + (dt[t][:, None] * Bm[t])[:, :, None] * x[t][:, None, :]
        ys.append(torch.einsum("hn,hnp->hp", Cm[t], hst))
    return torch.stack(ys), hst


def mamba2_layer(p: Tree, S: Sizes, h: torch.Tensor, conv_start, split: int, mm: MatMul):
    T = h.shape[0]
    H, Dh = S.Hq, S.Dh
    raw = torch.cat([linear(h, p["v_proj"], mm), linear(h, p["k_proj"], mm),
                     linear(h, p["q_proj"], mm)], -1)
    c = causal_conv(raw, p["conv_w"], p.get("conv_b"), conv_start)
    xv, bk, cq = (t.reshape(T, H, Dh) for t in c.split(H * Dh, -1))
    dt = F.softplus(linear(h, p["dt_proj"], mm) + p["dt_bias"].float())
    A = -p["A_log"].float().exp()
    y, hst = split_scan(lambda *a: ssd(a[0], a[1], A, *a[2:]), split, xv, dt, bk, cq)
    y = y + p["D"].float()[None, :, None] * xv
    gate = linear(h, p["g_proj"], mm).reshape(T, H, Dh)
    out = linear(gated_norm(y, gate, p["o_norm"], S.norm_eps).reshape(T, -1), p["o_proj"], mm)
    return out, dict(mamba_h=hst, mamba_conv=raw[split - S.conv: split])


def embed(tp: Tree, ids: torch.Tensor) -> torch.Tensor:
    return tp["embed"][ids].float()


def decoder(tp: Tree, S: Sizes, x: torch.Tensor, pos: torch.Tensor, conv_start: torch.Tensor,
            logits_at: Sequence[int] = (), state_at: Optional[int] = None,
            mm: MatMul = mm_fp32, mlp_block: int = 4096):
    """The decoder over a whole sequence of input embeddings x [T, D] with
    mRoPE positions [3, T], from an empty state. Returns (state, logits):
    the state a cached run over the first `state_at` tokens (all of them
    when None) ends with (per layer kind: rings, recurrent states and conv
    tails) and the fp32 logits at `logits_at`."""
    T = x.shape[0]
    split = T if state_at is None else int(state_at)
    x = x.float()
    cos, sin = mrope_cos_sin(pos, S)
    state: Dict[str, List[torch.Tensor]] = {}
    for i, lp in enumerate(tp["layers"]):
        role = S.roles[i]
        h = rms_norm(x, lp["input_norm"], S.eps)
        if role in ("swa", "full"):
            window = S.W if role == "swa" else 1 << 30
            a, k, v = swa_layer(lp, S, h, cos, sin, window, mm)
            n = min(split, S.W)
            ring_k = x.new_zeros((S.Hkv, S.W, S.Dh))
            ring_v = x.new_zeros((S.Hkv, S.W, S.Dh))
            slots = torch.arange(split - n, split, device=x.device) % S.W
            ring_k[:, slots] = k[split - n: split].transpose(0, 1)
            ring_v[:, slots] = v[split - n: split].transpose(0, 1)
            parts = dict(swa_k=ring_k, swa_v=ring_v)
        elif role == "delta":
            a, parts = delta_layer(lp, S, h, conv_start, split, mm)
        else:
            a, parts = mamba2_layer(lp, S, h, conv_start, split, mm)
        for key, val in parts.items():
            state.setdefault(key, []).append(val)
        del h
        x = x + a
        del a
        for t0 in range(0, T, mlp_block):
            xs = x[t0: t0 + mlp_block]
            x[t0: t0 + mlp_block] = xs + swiglu(rms_norm(xs, lp["post_norm"], S.eps), lp["mlp"], mm)
    idx = torch.as_tensor(list(logits_at), dtype=torch.long, device=x.device)
    hid = rms_norm(x[idx], tp["final_norm"], S.eps)
    head = tp["embed"].T if S.tied else tp["lm_head"]
    logits = mm(hid, head)
    return {k: torch.stack(v) for k, v in state.items()}, logits


# ----------------------------------------------------------------------------
# the served sequences
# ----------------------------------------------------------------------------

def frame_t_offset(frame_idx: int, fps: float, S: Sizes) -> int:
    """The temporal mRoPE offset of a stream's frame: whole grids of
    temporal_patch_size / fps seconds, tokens_per_second positions a second."""
    second_per_grid = S.tps / fps
    grid_t = int((frame_idx / fps) / second_per_grid)
    return int(grid_t * second_per_grid * S.tokens_per_second)


def stream_sequence(S: Sizes, n_frames: int, gh: int, gw: int, fps: float, device):
    """Token ids, mRoPE positions [3, T] and conv starts of n_frames stream
    frames, each <vision_start> + one image token per merged patch, every
    frame its own call. The frame's <vision_start> sits at position 0 on
    all three axes; its grid tokens at 1 + (t offset, row, column)."""
    lh, lw = gh // S.m, gw // S.m
    n_tok = lh * lw
    per = 1 + n_tok
    ids = torch.full((n_frames, per), S.image_token_id, dtype=torch.long, device=device)
    ids[:, 0] = S.vision_start_token_id
    rows = torch.arange(lh, device=device).repeat_interleave(lw)
    cols = torch.arange(lw, device=device).repeat(lh)
    pos = torch.zeros((3, n_frames, per), dtype=torch.long, device=device)
    for f in range(n_frames):
        pos[0, f, 1:] = 1 + frame_t_offset(f, fps, S)
    pos[1, :, 1:] = 1 + rows
    pos[2, :, 1:] = 1 + cols
    conv_start = (torch.arange(n_frames, device=device) * per)[:, None].expand(n_frames, per)
    return ids.reshape(-1), pos.reshape(3, -1), conv_start.reshape(-1).contiguous()


def text_sequence(prompt_len: int, n_decoded: int, chunk: int, device):
    """Positions and conv starts of a text prompt prefilled in `chunk`-token
    calls, then n_decoded single-token decode steps (which read the conv's
    history)."""
    T = prompt_len + n_decoded
    pos = torch.arange(T, device=device)[None].expand(3, T).contiguous()
    t = torch.arange(T, device=device)
    conv_start = torch.where(t < prompt_len, (t // chunk) * chunk, torch.zeros_like(t))
    return pos, conv_start
