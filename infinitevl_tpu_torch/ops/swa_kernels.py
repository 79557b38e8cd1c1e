"""Wrappers of the ring sliding-window attention kernels (A1 prefill, A2
stacked decode, D decode on one unstacked ring) in csrc/swa_ring_flash.cu,
under the names of their Pallas counterparts in
infinitevl_tpu/ops/swa_pallas.py, and of the stateless training attention
(H, forward and backward) in csrc/swa_train_flash.cu, which takes the place
of infinitevl_tpu/ops/swa.py::_swa_prefill_splash.

A tensor on the CPU takes the kernel's plain version (ops/swa.py); a CUDA
tensor launches the kernel or raises. Each wrapper counts its launches in
its `launches` attribute."""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from . import _build
from .swa import (
    ring_write,
    ring_write_stacked,
    swa_cached_attention,
    swa_prefill_reference,
)
from .vit_kernels import sm_count

HEAD_DIM = 128  # the head dim the kernels are written for
DECODE_TILE = 64  # ring slots per tile of the decode walk (A2, D)
DECODE_SMS_PER_BLOCK = 2  # the decode walk is split into about one block per two SMs
DECODE_MIN_TILES = 2  # and at least two tiles a block (see decode_split_plan)
MAX_GROUPS = 16  # query heads per KV head the decode kernel takes
BWD_TILE = 64  # keys per block of H's bf16 dK/dV kernel
BWD_TARGET_BLOCKS = 2 * 132  # dK/dV blocks wanted in flight: two per SM (measured on
# an H100 at 3B: one split of the GQA sum at T 2,048 took 2.2x the best, and beyond
# two blocks per SM the splits were level within the noise at T 2,048 to 8,192)
KEY_TILE = 64  # keys per stage of the bf16 forward mainloop (A1, H)
PREFILL_ROWS = 64  # query rows per block of A1's bf16 kernel
PREFILL_TARGET_BLOCKS = 2 * 132  # A1 blocks wanted in flight: two per SM (measured on
# an H100 at 3B: T 257 took 0.278 / 0.175 / 0.150 / 0.124 / 0.140 ms under splits 1-5)

_DTYPES = {torch.float32: _build.DTYPE_F32, torch.bfloat16: _build.DTYPE_BF16}


def _check_cuda(name: str, tensors: dict, dtype: torch.dtype) -> None:
    if dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {dtype} not supported (float32, bfloat16)")
    for arg, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, expected cuda")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _on_cpu(name: str, t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{name}: device {t.device} is neither cpu nor cuda")


class PrefillSplit(NamedTuple):
    """How A1's bf16 kernel splits the key tiles (the ring's, then the new
    keys') over blocks: split s takes tiles s, s + split, s + 2 split, ..."""
    split: int
    tiles_per_split: int  # at most; whole 64-key tiles
    partial_shape: tuple  # fp32 scratch [split, B Hkv T G, D + 4]; () if split == 1
    scratch_bytes: int


def prefill_split_plan(B: int, T: int, Hq: int, Hkv: int, cap: int) -> PrefillSplit:
    """The smallest split of A1's key tiles that gives at least
    PREFILL_TARGET_BLOCKS blocks of (64 query rows, batch row, KV head,
    split), and no more splits than key tiles. Each split writes
    (m, l, acc) per query row in fp32; a combine pass adds the splits in
    the order s = 0, 1, ..., so the result does not depend on the order the
    blocks ran in."""
    n_rows = T * (Hq // Hkv)
    base = -(-n_rows // PREFILL_ROWS) * B * Hkv
    n_tiles = -(-cap // KEY_TILE) + -(-T // KEY_TILE)
    split = min(max(1, -(-PREFILL_TARGET_BLOCKS // base)), n_tiles)
    if split == 1:
        return PrefillSplit(1, n_tiles, (), 0)
    shape = (split, B * Hkv * n_rows, HEAD_DIM + 4)
    return PrefillSplit(split, -(-n_tiles // split), shape,
                        4 * split * B * Hkv * n_rows * (HEAD_DIM + 4))


def swa_ring_flash_attention(
    q: torch.Tensor,  # [B, T, Hq, D]
    new_k: torch.Tensor,  # [B, T, Hkv, D]
    new_v: torch.Tensor,
    ring_k: torch.Tensor,  # [B, Hkv, cap, D] head-major (one layer's ring)
    ring_v: torch.Tensor,
    cum_len: int,  # tokens in the ring before this call
    window: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Kernel A1: attention of T new queries over (ring ++ new keys) with
    the sliding-window mask. Reads the ring; does not write it. In bf16 the
    key tiles are split over blocks where the query tiles alone leave the
    card short (prefill_split_plan), with fp32 partials added in a fixed
    order. Returns [B, T, Hq, D] in q's dtype."""
    name = "swa_ring_flash_attention"
    if _on_cpu(name, q):
        return swa_cached_attention(
            q, new_k, new_v, ring_k, ring_v, cum_len, window, scale,
            write_ring=False,
        )
    B, T, Hq, D = q.shape
    Hkv, cap = ring_k.shape[1], ring_k.shape[2]
    _check_cuda(name, dict(q=q, new_k=new_k, new_v=new_v, ring_k=ring_k,
                           ring_v=ring_v), q.dtype)
    if D != HEAD_DIM or Hq % Hkv:
        raise ValueError(f"{name}: needs head_dim {HEAD_DIM} and Hq % Hkv == 0 "
                         f"(got D={D}, Hq={Hq}, Hkv={Hkv})")
    if new_k.shape != (B, T, Hkv, D) or new_v.shape != new_k.shape:
        raise ValueError(f"{name}: new_k/new_v shape {tuple(new_k.shape)} does "
                         f"not match q {tuple(q.shape)} and Hkv={Hkv}")
    if ring_k.shape != (B, Hkv, cap, D) or ring_v.shape != ring_k.shape:
        raise ValueError(f"{name}: ring shape {tuple(ring_k.shape)} is not "
                         f"[B, Hkv, cap, D]")
    if -(-T * (Hq // Hkv) // 32) > 65535:
        raise ValueError(f"{name}: T={T} too long for one launch; prefill in chunks")
    if q.dtype == torch.bfloat16 and 64 % (Hq // Hkv):
        raise ValueError(f"{name}: the bf16 kernel packs 64 / G tokens of the G = Hq / Hkv "
                         f"query heads into a tile; G={Hq // Hkv} does not divide 64")
    if scale is None:
        scale = D**-0.5
    out = torch.empty_like(q)
    plan = (prefill_split_plan(B, T, Hq, Hkv, cap) if q.dtype == torch.bfloat16
            else PrefillSplit(1, 0, (), 0))
    part = (torch.empty(plan.partial_shape, dtype=torch.float32, device=q.device)
            if plan.split > 1 else None)
    lib = _build.load_library()
    with torch.cuda.device(q.device):  # launch on the tensors' card
        _build.check(
            lib.ivl_swa_prefill(
                _DTYPES[q.dtype], q.data_ptr(), new_k.data_ptr(), new_v.data_ptr(),
                ring_k.data_ptr(), ring_v.data_ptr(), out.data_ptr(),
                None if part is None else part.data_ptr(),
                B, T, Hq, Hkv, D, cap, int(cum_len), int(window), plan.split, float(scale),
                torch.cuda.current_stream(q.device).cuda_stream,
            ),
            name,
        )
    swa_ring_flash_attention.launches += 1
    return out


swa_ring_flash_attention.launches = 0


class DecodeSplit(NamedTuple):
    """How A2 and D walk the ring: the tiles of DECODE_TILE slots that hold
    a visible key, oldest first, are tiles (tile0 + i) % n_ring for i <
    n_tiles; split s (one block per batch row and KV head) takes steps
    [s tiles_per_split, (s + 1) tiles_per_split)."""
    split: int
    tiles_per_split: int
    tile0: int
    n_tiles: int
    partial_shape: tuple  # fp32 scratch [B Hkv, split, G, D + 4]; () if split == 1


def decode_split_plan(B: int, Hq: int, Hkv: int, cap: int, cum_len: int, window: int,
                      sms: int) -> DecodeSplit:
    """The walk of the decode kernels (csrc/swa_ring_flash.cu, DecWalk) over
    ring slots visible to the token at position cum_len (the slot m0 =
    cum_len % cap it is written to and the min(cum_len + 1, window) - 1
    before it, cyclically), split so that about one block per
    DECODE_SMS_PER_BLOCK SMs walks at least DECODE_MIN_TILES tiles. Each
    block keeps three tiles (96 KB) in flight, so some 64 blocks fill the
    memory's pipe; more splits only add partials to combine, and a split of
    one tile writes a partial of 4.2 KB against its 32 KB of K/V."""
    n_ring = -(-cap // DECODE_TILE)
    m0 = cum_len % cap
    n_vis = min(cum_len + 1, window)
    lo = (m0 - n_vis + 1) % cap
    tile0 = lo // DECODE_TILE
    if lo <= m0:
        n_tiles = m0 // DECODE_TILE - tile0 + 1
    else:  # wraps past slot cap - 1; both ends in one tile: every tile once
        n_tiles = min(n_ring, n_ring - tile0 + m0 // DECODE_TILE + 1)
    want = max(1, -(-sms // (DECODE_SMS_PER_BLOCK * B * Hkv)))
    tps = min(n_tiles, max(DECODE_MIN_TILES, -(-n_tiles // want)))
    split = -(-n_tiles // tps)
    shape = (B * Hkv, split, Hq // Hkv, HEAD_DIM + 4) if split > 1 else ()
    return DecodeSplit(split, tps, tile0, n_tiles, shape)


class SplitWalk(NamedTuple):
    """One split of the decode walk, as decode_tile_walk predicts it."""
    tiles: List[int]  # ring tiles loaded, in walk order
    masked: List[int]  # those masked element by element
    writes: bool  # the split stores the token into slot m0


def decode_tile_walk(plan: DecodeSplit, cap: int, cum_len: int,
                     window: int) -> List[SplitWalk]:
    """The plain twin of the decode kernels' walk (DecWalk): per split, the
    tiles it loads, those it masks element by element (a tile is whole when
    every slot of it is visible: it lies below cap and holds no slot past
    the window's lower edge, nor the write point's unwritten or evicted
    slots), and whether it owns slot m0."""
    n_ring = -(-cap // DECODE_TILE)
    m0 = cum_len % cap
    n_vis = min(cum_len + 1, window)

    def whole(t: int) -> bool:
        a = t * DECODE_TILE
        if a + DECODE_TILE > cap:
            return False
        if a <= m0 < a + DECODE_TILE - 1:  # holds m0 and m0 + 1
            return n_vis >= cap
        return (m0 - a) % cap < n_vis

    writer = ((m0 // DECODE_TILE - plan.tile0) % n_ring) // plan.tiles_per_split
    walk = []
    for s in range(plan.split):
        steps = range(s * plan.tiles_per_split,
                      min((s + 1) * plan.tiles_per_split, plan.n_tiles))
        tiles = [(plan.tile0 + i) % n_ring for i in steps]
        walk.append(SplitWalk(tiles, [t for t in tiles if not whole(t)], s == writer))
    return walk


def _launch_decode(name, q, new_k, new_v, rings_k, rings_v, layer, cum_len, window,
                   scale) -> torch.Tensor:
    """Launch ivl_swa_decode on ring `layer` of `rings_*` ([S, B, Hkv, cap,
    D], or one ring [B, Hkv, cap, D] as a stack of one): the kernel writes
    the token's K/V into slot cum_len % cap and attends over that ring
    under decode_split_plan's walk; past one split a second kernel combines
    the partials. No torch op but the allocations of the output and the
    scratch."""
    B, _, Hq, D = q.shape
    S = rings_k.shape[0] if rings_k.dim() == 5 else 1
    Hkv, cap = rings_k.shape[-3], rings_k.shape[-2]
    if q.dtype == torch.bfloat16 and (rings_k.data_ptr() % 16 or rings_v.data_ptr() % 16):
        raise ValueError(f"{name}: the bf16 kernel's TMA maps need rings on 16 bytes")
    if scale is None:
        scale = D**-0.5
    plan = decode_split_plan(B, Hq, Hkv, cap, int(cum_len), int(window),
                             sm_count(q.device.index))
    part = (torch.empty(plan.partial_shape, dtype=torch.float32, device=q.device)
            if plan.split > 1 else None)
    out = torch.empty_like(q)
    lib = _build.load_library()
    with torch.cuda.device(q.device):  # launch on the tensors' card
        _build.check(
            lib.ivl_swa_decode(
                _DTYPES[q.dtype], q.data_ptr(), new_k.data_ptr(), new_v.data_ptr(),
                rings_k.data_ptr(), rings_v.data_ptr(),
                None if part is None else part.data_ptr(), out.data_ptr(),
                B, Hq, Hkv, D, cap, S, int(layer), int(cum_len), int(window),
                plan.tiles_per_split, plan.split, float(scale),
                torch.cuda.current_stream(q.device).cuda_stream,
            ),
            name,
        )
    return out


def swa_ring_flash_decode_stacked(
    q: torch.Tensor,  # [B, 1, Hq, D]
    new_k: torch.Tensor,  # [B, 1, Hkv, D]
    new_v: torch.Tensor,
    rings_k: torch.Tensor,  # [S, B, Hkv, cap, D] stacked rings, updated in place
    rings_v: torch.Tensor,
    layer: int,
    cum_len: int,  # tokens in the ring BEFORE this one
    window: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Kernel A2: write the token's K/V into slot cum_len % cap of layer
    `layer` of the stacked rings (IN PLACE), then attend over that ring
    alone. Requires cap >= window (the evicted token is then never
    visible). On the card both happen in one kernel (plus a combine past
    one split), new_k / new_v in q's dtype and contiguous. Returns
    [B, 1, Hq, D] in q's dtype."""
    name = "swa_ring_flash_decode_stacked"
    if _on_cpu(name, q):
        out = swa_cached_attention(
            q, new_k, new_v, rings_k[layer], rings_v[layer], cum_len, window,
            scale, write_ring=False,
        )
        ring_write_stacked(rings_k, rings_v, layer, new_k, new_v, cum_len)
        return out
    B, T, Hq, D = q.shape
    S, _, Hkv, cap, _ = rings_k.shape
    _check_cuda(name, dict(q=q, new_k=new_k, new_v=new_v, rings_k=rings_k,
                           rings_v=rings_v), q.dtype)
    if T != 1:
        raise ValueError(f"{name}: decode takes one token (got T={T})")
    if D != HEAD_DIM or Hq % Hkv or Hq // Hkv > MAX_GROUPS:
        raise ValueError(f"{name}: needs head_dim {HEAD_DIM}, Hq % Hkv == 0 and "
                         f"Hq/Hkv <= {MAX_GROUPS} (got D={D}, Hq={Hq}, Hkv={Hkv})")
    if rings_k.shape != (S, B, Hkv, cap, D) or rings_v.shape != rings_k.shape:
        raise ValueError(f"{name}: rings shape {tuple(rings_k.shape)} is not "
                         f"[S, B, Hkv, cap, D] for B={B}")
    if new_k.shape != (B, 1, Hkv, D) or new_v.shape != new_k.shape:
        raise ValueError(f"{name}: new_k/new_v shape {tuple(new_k.shape)}")
    if cap < window:
        raise ValueError(f"{name}: ring capacity {cap} < window {window}: the "
                         "write-then-attend order would evict a visible key")
    if not 0 <= layer < S:
        raise IndexError(f"{name}: layer {layer} outside the stack of {S}")
    out = _launch_decode(name, q, new_k, new_v, rings_k, rings_v, layer, cum_len,
                         window, scale)
    swa_ring_flash_decode_stacked.launches += 1
    return out


swa_ring_flash_decode_stacked.launches = 0


def swa_ring_decode_plain(
    q: torch.Tensor,  # [B, 1, Hq, D]
    new_k: torch.Tensor,  # [B, 1, Hkv, D]
    new_v: torch.Tensor,
    ring_k: torch.Tensor,  # [B, Hkv, cap, D], updated in place
    ring_v: torch.Tensor,
    cum_len: int,
    window: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Kernel D's plain version: attend over (ring ++ the new token) with
    the sliding-window mask, then write the token into its ring slot."""
    out = swa_cached_attention(q, new_k, new_v, ring_k, ring_v, cum_len, window,
                               scale, write_ring=False)
    ring_write(ring_k, ring_v, new_k, new_v, cum_len)
    return out


def swa_ring_flash_decode(
    q: torch.Tensor,  # [B, 1, Hq, D]
    new_k: torch.Tensor,  # [B, 1, Hkv, D]
    new_v: torch.Tensor,
    ring_k: torch.Tensor,  # [B, Hkv, cap, D] one ring, updated in place
    ring_v: torch.Tensor,
    cum_len: int,  # tokens in the ring BEFORE this one
    window: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Kernel D: kernel A2 on one unstacked ring. The ring is handed to the
    decode kernel as a stack of one layer where it lies (no copy into a
    stack): the token's K/V go into slot cum_len % cap IN PLACE, then the
    query attends over the ring alone. Requires cap >= window. Returns
    [B, 1, Hq, D] in q's dtype."""
    name = "swa_ring_flash_decode"
    if _on_cpu(name, q):
        return swa_ring_decode_plain(q, new_k, new_v, ring_k, ring_v, cum_len,
                                     window, scale)
    B, T, Hq, D = q.shape
    _check_cuda(name, dict(q=q, new_k=new_k, new_v=new_v, ring_k=ring_k, ring_v=ring_v),
                q.dtype)
    if T != 1:
        raise ValueError(f"{name}: decode takes one token (got T={T})")
    if ring_k.dim() != 4 or ring_k.shape[0] != B or ring_k.shape[3] != D \
            or ring_v.shape != ring_k.shape:
        raise ValueError(f"{name}: ring shape {tuple(ring_k.shape)} is not "
                         f"[B, Hkv, cap, D] for B={B}, D={D}")
    Hkv, cap = ring_k.shape[1], ring_k.shape[2]
    if D != HEAD_DIM or Hq % Hkv or Hq // Hkv > MAX_GROUPS:
        raise ValueError(f"{name}: needs head_dim {HEAD_DIM}, Hq % Hkv == 0 and "
                         f"Hq/Hkv <= {MAX_GROUPS} (got D={D}, Hq={Hq}, Hkv={Hkv})")
    if new_k.shape != (B, 1, Hkv, D) or new_v.shape != new_k.shape:
        raise ValueError(f"{name}: new_k/new_v shape {tuple(new_k.shape)}")
    if cap < window:
        raise ValueError(f"{name}: ring capacity {cap} < window {window}: the "
                         "write-then-attend order would evict a visible key")
    out = _launch_decode(name, q, new_k, new_v, ring_k, ring_v, 0, cum_len, window, scale)
    swa_ring_flash_decode.launches += 1
    return out


swa_ring_flash_decode.launches = 0


def _check_train(name, q, k, v, segment_ids, window):
    B, T, Hq, D = q.shape
    _check_cuda(name, dict(q=q, k=k, v=v), q.dtype)
    Hkv = k.shape[2]
    if D != HEAD_DIM or Hq % Hkv:
        raise ValueError(f"{name}: needs head_dim {HEAD_DIM} and Hq % Hkv == 0 "
                         f"(got D={D}, Hq={Hq}, Hkv={Hkv})")
    if k.shape != (B, T, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"{name}: k/v shape {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if window < 1:
        raise ValueError(f"{name}: window {window} < 1")
    if segment_ids is not None and (
        segment_ids.device != q.device or segment_ids.dtype != torch.int32
        or segment_ids.shape != (B, T) or not segment_ids.is_contiguous()
    ):
        raise ValueError(f"{name}: segment_ids must be contiguous int32 [{B}, {T}] "
                         f"on {q.device}")


class BwdSplit(NamedTuple):
    """How H's bf16 dK/dV kernel splits the GQA sum over the query heads."""
    split: int  # query-head groups, each summed by its own blocks
    partial_shape: tuple  # fp32 scratch [2 (dK, dV), split, B, T, Hkv, D]; () if split == 1
    scratch_bytes: int


def bwd_split_plan(B: int, T: int, Hq: int, Hkv: int, D: int = HEAD_DIM,
                   target: Optional[int] = None) -> BwdSplit:
    """The smallest divisor of Hq / Hkv that gives the dK/dV kernel at least
    `target` (BWD_TARGET_BLOCKS unless given) blocks of (64 keys, KV head,
    batch row, head group), or the full split (one query head per block). The partial sums are added by a
    reduce pass in the order s = 0, 1, ..., split - 1, so the result does
    not depend on the order the blocks ran in."""
    if target is None:
        target = BWD_TARGET_BLOCKS
    G = Hq // Hkv
    base = -(-T // BWD_TILE) * Hkv * B
    split = next((s for s in range(1, G + 1) if G % s == 0 and base * s >= target), G)
    if split == 1:
        return BwdSplit(1, (), 0)
    shape = (2, split, B, T, Hkv, D)
    return BwdSplit(split, shape, 4 * 2 * split * B * T * Hkv * D)


class _SwaTrainFlashFn(torch.autograd.Function):
    """Kernel H: the forward keeps q, k, v, the output and the row
    log-sum-exp; the backward launches the delta, dQ and dK/dV kernels (and,
    in bf16 with the GQA sum split, the reduce of dK/dV's partials)."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, window, scale):
        name = "swa_train_flash_attention"
        B, T, Hq, D = q.shape
        Hkv = k.shape[2]
        out = torch.empty_like(q)
        lse = torch.empty((B, Hq, T), dtype=torch.float32, device=q.device)
        lib = _build.load_library()
        with torch.cuda.device(q.device):  # launch on the tensors' card
            _build.check(
                lib.ivl_swa_train_fwd(
                    _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    None if segment_ids is None else segment_ids.data_ptr(),
                    out.data_ptr(), lse.data_ptr(), B, T, Hq, Hkv, D,
                    int(window), float(scale),
                    torch.cuda.current_stream(q.device).cuda_stream,
                ),
                name,
            )
        swa_train_flash_attention.launches += 1
        ctx.save_for_backward(q, k, v, segment_ids, out, lse)
        ctx.window, ctx.scale = int(window), float(scale)
        return out

    @staticmethod
    def backward(ctx, d_out):
        name = "swa_train_flash_attention (backward)"
        q, k, v, segment_ids, out, lse = ctx.saved_tensors
        B, T, Hq, D = q.shape
        Hkv = k.shape[2]
        d_out = d_out.contiguous()
        if d_out.dtype != q.dtype:
            raise TypeError(f"{name}: cotangent dtype {d_out.dtype}, q has {q.dtype}")
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        delta = torch.empty_like(lse)
        plan = (bwd_split_plan(B, T, Hq, Hkv, D) if q.dtype == torch.bfloat16
                else BwdSplit(1, (), 0))
        partial = (torch.empty(plan.partial_shape, dtype=torch.float32, device=q.device)
                   if plan.split > 1 else None)
        lib = _build.load_library()
        with torch.cuda.device(q.device):
            _build.check(
                lib.ivl_swa_train_bwd(
                    _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    None if segment_ids is None else segment_ids.data_ptr(),
                    out.data_ptr(), d_out.data_ptr(), lse.data_ptr(),
                    delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                    None if partial is None else partial.data_ptr(),
                    B, T, Hq, Hkv, D, ctx.window, plan.split, ctx.scale,
                    torch.cuda.current_stream(q.device).cuda_stream,
                ),
                name,
            )
        swa_train_flash_attention.launches_bwd += 1
        return dq, dk, dv, None, None, None


def swa_train_flash_attention(
    q: torch.Tensor,  # [B, T, Hq, D]
    k: torch.Tensor,  # [B, T, Hkv, D]
    v: torch.Tensor,
    window: int,
    scale: Optional[float] = None,
    segment_ids: Optional[torch.Tensor] = None,  # [B, T] integer ids
) -> torch.Tensor:
    """Kernel H: causal sliding-window attention of a stateless forward.
    Query t sees keys in (t - window, t] of its own row that share its
    segment id. Differentiable: on a CUDA tensor the backward is the
    hand-written dQ and dK/dV kernels (reproducible, no atomics). T needs
    no multiple. Returns [B, T, Hq, D] in q's dtype. `launches` counts
    forward launches, `launches_bwd` backward ones."""
    name = "swa_train_flash_attention"
    if _on_cpu(name, q):
        return swa_prefill_reference(q, k, v, window, 0, scale, segment_ids)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if segment_ids is not None:
        segment_ids = segment_ids.to(torch.int32).contiguous()
    _check_train(name, q, k, v, segment_ids, window)
    return _SwaTrainFlashFn.apply(q, k, v, segment_ids, min(int(window), 1 << 30), scale)


swa_train_flash_attention.launches = 0
swa_train_flash_attention.launches_bwd = 0
