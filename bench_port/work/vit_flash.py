"""Kernels E and F (csrc/vit_flash.cu): the ViT's attention over a packed
sequence of S patches, F with windows of L patches (the window blocks),
E over whole segments (the full-attention blocks).

Operations: QK^T and PV over the visible pairs, 4 D a pair and head.
Bytes: q, k, v read and the output written once in bf16, the segment ids
read once (int32)."""

from harness.peaks import PEAK_BF16_FLOPS

TRACE_NAMES = ("vit_flash_kernel", "vit_flash_wgmma_kernel")


def work(S, H, D, L, elt=2):
    """(operations, bytes, peak operations/s) of one call: S patches in
    windows (segments) of L, every pair inside a window visible."""
    flops = 4.0 * H * D * S * L
    n_bytes = elt * 4 * S * H * D + 4 * S
    return flops, n_bytes, PEAK_BF16_FLOPS
