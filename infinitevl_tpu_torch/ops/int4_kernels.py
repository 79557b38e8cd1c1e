"""Wrapper of the fused int4 unpack-matmul kernel (G) in
csrc/int4_matmul.cu, under the name of its Pallas counterpart in
infinitevl_tpu/ops/int4_pallas.py, with its plain version beside it.

A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises. The wrapper counts its launches in its `launches`
attribute. Storage layout: models/quant.py."""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from . import _build

SMALL_M = 8  # rows up to which the bytes-bound kernel is taken
TARGET_BLOCKS = 264  # two blocks for each of the card's 132 SMs
SMS = 132  # streaming multiprocessors of an H100
GEMV_COLS, GEMV_MIN_ROWS, GEMV_MAX_ROWS = 128, 64, 512  # columns / packed rows per block
FMA_TILE, FMA_MIN_ROWS = 64, 128  # fp32 tiles: 64 x 64 outputs
WGMMA_COLS, WGMMA_STAGE, WGMMA_MIN_ROWS = 128, 64, 128  # bf16: columns, packed rows per stage
WGMMA_KSTEP = 16  # packed rows of one wgmma k-step
WGMMA_ONE_GROUP_M = 64  # rows up to which one consumer warpgroup (64-row tiles) is taken
TMA_ALIGN = 16  # bytes: x's base and row stride for the tensor map

_DTYPES = {torch.float32: _build.DTYPE_F32, torch.bfloat16: _build.DTYPE_BF16}


def _storage(node: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    packed = node.get("kernel_q4f", node.get("kernel_q4"))
    if packed is None:
        raise ValueError("the fused int4 matmul needs signed kernel_q4 / kernel_q4f storage")
    return packed, node["scale4"]


def _check_shapes(name: str, x, packed, scale) -> Tuple[int, int, int]:
    if packed.dtype != torch.uint8 or packed.ndim != 2:
        raise TypeError(f"{name}: packed weights must be 2-D uint8, got "
                        f"{packed.dtype} {tuple(packed.shape)}")
    half, d_out = packed.shape
    if x.shape[-1] != 2 * half:
        raise ValueError(f"{name}: x has d_in {x.shape[-1]}, the packed weight "
                         f"{2 * half} (an odd d_in cannot be nibble-packed)")
    if scale.dtype != torch.float32 or scale.ndim != 2 or scale.shape[1] != d_out:
        raise TypeError(f"{name}: scale4 must be fp32 [G, {d_out}], got "
                        f"{scale.dtype} {tuple(scale.shape)}")
    G = scale.shape[0]
    if G != 1 and (G % 2 or half % (G // 2)):
        raise ValueError(f"{name}: {G} scale groups do not tile the two planes of "
                         f"{half} rows")
    return half, d_out, G


def int4_matmul_plain(x: torch.Tensor, node: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Kernel G's plain version: unpack both planes, fp32 partial sums per
    group and plane, the group's fp32 scale on each partial sum, one cast to
    x's dtype at the end."""
    packed, scale = _storage(node)
    half, d_out, G = _check_shapes("int4_matmul_plain", x, packed, scale)
    p = packed.to(torch.int16)
    lo = (((p & 0xF) ^ 8) - 8).float()
    hi = (((p >> 4) ^ 8) - 8).float()
    lead = x.shape[:-1]
    xf = x.reshape(-1, 2 * half).float()
    if G == 1:
        y = (xf[:, :half] @ lo + xf[:, half:] @ hi) * scale[0]
    else:
        g2 = G // 2
        gs = half // g2

        def plane(xh, w, sh):
            xg = xh.reshape(-1, g2, gs).permute(1, 0, 2)  # [g2, M, gs]
            yg = torch.bmm(xg, w.reshape(g2, gs, d_out))  # [g2, M, d_out]
            return (yg * sh[:, None, :]).sum(0)

        y = plane(xf[:, :half], lo, scale[:g2]) + plane(xf[:, half:], hi, scale[g2:])
    return y.to(x.dtype).reshape(*lead, d_out)


@functools.lru_cache(maxsize=None)
def launch_plan(M: int, half: int, d_out: int,
                dtype: torch.dtype = torch.bfloat16) -> Tuple[int, int, int]:
    """(tile_m, rows per block, row splits) of kernel G. tile_m is 0 for
    the M <= 8 kernel, else the output rows of a block: 64 for fp32 (64 x
    64 FMA tiles); for bf16 the wgmma kernel's 64 (one warpgroup, M <= 64)
    or 128. The small kernel and fp32 split the packed rows until about
    TARGET_BLOCKS blocks are in flight; bf16 splits them only where its
    128-column tiles leave the card's SMs short, in whole 64-row stages."""
    if M <= SMALL_M:
        tile_m, blocks, lo, hi, step = 0, -(-d_out // GEMV_COLS), GEMV_MIN_ROWS, GEMV_MAX_ROWS, 32
        ks = max(1, min(-(-TARGET_BLOCKS // blocks), -(-half // lo)))
    elif dtype == torch.float32:
        tile_m, lo, hi, step = FMA_TILE, FMA_MIN_ROWS, half, 32
        blocks = -(-d_out // FMA_TILE) * -(-M // FMA_TILE)
        ks = max(1, min(-(-TARGET_BLOCKS // blocks), -(-half // lo)))
    else:
        tile_m = 64 if M <= WGMMA_ONE_GROUP_M else 128
        lo, hi, step = WGMMA_MIN_ROWS, half, WGMMA_STAGE
        blocks = -(-d_out // WGMMA_COLS) * -(-M // tile_m)
        ks = 1 if blocks >= SMS else max(1, min(-(-SMS // blocks), -(-half // lo)))
    rpb = min(max(-(-half // ks), lo), max(hi, lo))
    rpb = -(-rpb // step) * step
    return tile_m, rpb, -(-half // rpb)


ROUTES = {"fma": 0, "wgmma": 1, "wgmma_kstep": 2}  # the C entry's `route` codes


def tile_kernel(half: int, G: int, dtype: torch.dtype) -> str:
    """Which of kernel G's tile kernels serves M > 8 (the C entry launches
    the one named by its `route`): "wgmma" (bf16; G = 1 or scale groups of whole
    64-row stages: one scale fold per stage), "wgmma_kstep" (bf16; groups
    of a multiple of 16 rows below a stage: a fold per 16-row k-step),
    "fma" (fp32, and bf16 groups that split a k-step: 64 x 64 FMA tiles,
    which fold at any group end). Every group that models/quant.py makes is
    served."""
    gs = half if G == 1 else half // (G // 2)
    if dtype == torch.float32 or (G > 1 and gs % WGMMA_KSTEP):
        return "fma"
    return "wgmma" if G == 1 or gs % WGMMA_STAGE == 0 else "wgmma_kstep"


def _stream_ptr(device: torch.device) -> int:
    """The current stream of `device` as the integer the C entry takes. The
    raw getter skips building a Stream object (microseconds, on a wrapper
    that runs hundreds of times per decoded token)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def int4_matmul_fused(x: torch.Tensor, node: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Kernel G: x @ dequant(node) with both nibble planes unpacked from one
    read of the packed weight, fp32 accumulation, group scales on the fp32
    partial sums. Leading dims of x are flattened into the row axis; x may
    be a strided view whose last dim is dense. Returns [..., d_out] in x's
    dtype."""
    name = "int4_matmul_fused"
    packed, scale = _storage(node)
    if x.device.type == "cpu":
        return int4_matmul_plain(x, node)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: device {x.device} is neither cpu nor cuda")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (float32, bfloat16)")
    half, d_out, G = _check_shapes(name, x, packed, scale)
    for arg, t in (("packed", packed), ("scale4", scale)):
        if t.device != x.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be contiguous and 16-byte aligned")
    d_in = 2 * half
    out = torch.empty(x.shape[:-1] + (d_out,), dtype=x.dtype, device=x.device)
    M = out.numel() // d_out
    if M == 0:
        return out
    route = tile_kernel(half, G, x.dtype)
    fma = route == "fma"
    tile_m, rpb, ks = launch_plan(M, half, d_out, torch.float32 if fma else x.dtype)
    if x.is_contiguous():  # rows as they lie: no view is made
        x2, ldx = x, d_in
    else:
        x2 = x.reshape(-1, d_in)
        if x2.stride(1) != 1:
            x2 = x2.contiguous()
        ldx = x2.stride(0)
    x_hi = half  # the column where x's high plane starts
    if tile_m and not fma:
        if (ldx * 2) % TMA_ALIGN or x2.data_ptr() % TMA_ALIGN or (half * 2) % TMA_ALIGN:
            # TMA reads x at 16-byte boundaries: copy it with each plane
            # starting on one (d_in 3420: planes of 1710 columns = 3420 bytes)
            x_hi = -(-half // 8) * 8
            rows = x2.reshape(M, d_in)
            pad = torch.zeros((M, 2 * x_hi), dtype=x.dtype, device=x.device)
            pad[:, :half].copy_(rows[:, :half])
            pad[:, x_hi:x_hi + half].copy_(rows[:, half:])
            x2, ldx = pad, pad.stride(0)
    partial = (torch.empty((ks, M, d_out), dtype=torch.float32, device=x.device)
               if ks > 1 else None)
    lib = _build.load_library()

    def launch():
        _build.check(
            lib.ivl_int4_matmul(
                _DTYPES[x.dtype], x2.data_ptr(), ldx, x_hi, packed.data_ptr(),
                scale.data_ptr(), out.data_ptr(),
                partial.data_ptr() if partial is not None else None,
                M, d_in, d_out, G, rpb, ks, tile_m, ROUTES[route], _stream_ptr(x.device),
            ),
            name,
        )

    if x.device.index == torch.cuda.current_device():
        launch()
    else:
        with torch.cuda.device(x.device):  # launch on the tensors' card
            launch()
    int4_matmul_fused.launches += 1
    return out


int4_matmul_fused.launches = 0
