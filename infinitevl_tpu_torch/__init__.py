"""InfiniteVL on PyTorch + CUDA: the ViT, the hybrid SWA / Gated-DeltaNet
decoder, generation and the streaming video engine of `infinitevl_tpu`,
ported to torch with hand-written Hopper kernels (`csrc/`) for the five
kernels on the serving and streaming paths.

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
