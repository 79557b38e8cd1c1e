"""Kernel C (csrc/delta_chunk.cu): the chunked gated delta rule of one call.

Operations: per chunk of 64 and head, the strict lower half of k k^T, the
lower half of q k^T, the triangular solve on the [k | v] right-hand sides,
w S and q S, the masked product with the values and the state update
(harness/flops.delta_chunk_flops), on the bf16 tensor cores. Bytes: q, k,
v read and o written once in the model's dtype, g and beta read in fp32,
the fp32 state read and written once."""

from harness.flops import delta_chunk_flops
from harness.peaks import PEAK_BF16_FLOPS

TRACE_NAMES = ("delta_chunk_prep", "delta_chunk_scan")


def work(B, T, H, K, V, elt=2):
    """(operations, bytes, peak operations/s) of one call."""
    flops = B * delta_chunk_flops(T, H, K, V)
    n_bytes = elt * (2 * B * T * H * K + 2 * B * T * H * V) + 4 * (2 * B * T * H + 2 * B * H * K * V)
    return flops, n_bytes, PEAK_BF16_FLOPS
