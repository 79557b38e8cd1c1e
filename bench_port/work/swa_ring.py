"""Kernel A1 (csrc/swa_ring_flash.cu): T new queries over the ring of one
SWA layer plus the new keys, under the sliding window.

Operations: QK^T and PV over every visible key of every query (4 D a pair
and query head). Bytes: q read and the output written once, the new keys
and values read once, and the ring's slots that hold a visible key read
once, all bf16."""

from harness.flops import visible_keys
from harness.peaks import PEAK_BF16_FLOPS

TRACE_NAMES = ("swa_prefill_kernel", "swa_prefill_wgmma_kernel", "swa_prefill_combine_kernel")


def work(B, T, Hq, Hkv, D, cap, cum_len, window, elt=2):
    """(operations, bytes, peak operations/s) of one call."""
    flops = 4.0 * B * Hq * D * visible_keys(cum_len, T, window)
    ring = min(cap, cum_len)
    n_bytes = elt * (2 * B * T * Hq * D + 2 * B * T * Hkv * D + 2 * B * Hkv * ring * D)
    return flops, n_bytes, PEAK_BF16_FLOPS
