"""Configs, shared with the JAX package: `infinitevl_tpu.config` is plain
Python (no jax import), so the port re-exports it rather than copying,
layer-role names included."""

from infinitevl_tpu.config import (  # noqa: F401
    FULL,
    LINEAR,
    MAMBA2,
    SLIDING,
    InfiniteVLConfig,
    TextConfig,
    VisionConfig,
    infinitevl_3b,
    tiny_config,
)
