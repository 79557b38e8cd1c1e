"""InfiniteVL on PyTorch + CUDA: the hybrid SWA / Gated-DeltaNet text
decoder of `infinitevl_tpu`, ported to torch with hand-written Hopper
kernels (`csrc/`) for the three kernels on the serving path.

Module paths mirror `infinitevl_tpu`; the JAX package is the reference
the port is tested against. Nothing here imports jax."""

from .config import (
    InfiniteVLConfig,
    TextConfig,
    VisionConfig,
    infinitevl_3b,
    tiny_config,
)

__version__ = "0.1.0"
