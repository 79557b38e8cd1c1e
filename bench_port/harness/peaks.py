"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at its 700 W limit), and the least time a piece of work
can take on it."""

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12


def bound_s(flops: float, n_bytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The larger of the operations over the peak rate and the bytes (each
    input read once, each output written once) over the memory rate."""
    return max(flops / peak_flops, n_bytes / PEAK_BYTES_S)
