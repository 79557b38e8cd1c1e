"""Configuration dataclasses of the port: its own copy of
infinitevl_tpu/config.py (same field names and defaults, so a config
converts field by field), frozen and hashable so a config can key a cache.

Semantics follow the reference's configuration_infinitevl.py and the
deployed InfiniteVL-3B config.json. The knobs of the JAX build that have
no effect here (use_pallas_*, mlp_chunk_t, delta_stream_min_chunks,
delta_seq_chunk_*) are kept so that both packages read the same config."""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

SLIDING = "sliding_attention"
FULL = "full_attention"
LINEAR = "linear_attention"
MAMBA2 = "mamba2"

# Layer-type aliases accepted by the reference cache container
# (modeling_infinitevl.py:366-443).
_LINEAR_ALIASES = {"linear_attention", "delta_net", "retnet", "state_space"}
_SLIDING_ALIASES = {"sliding_attention", "chunked_attention"}


def _default_layer_types(num_layers: int) -> Tuple[str, ...]:
    # Reference default: every 4th layer (i % 4 == 0) is SWA, rest DeltaNet
    # (configuration_infinitevl.py:279-284).
    return tuple(LINEAR if i % 4 else SLIDING for i in range(num_layers))


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """Qwen2.5-VL-style dynamic-resolution ViT encoder config.

    Defaults follow the deployed InfiniteVL-3B config
    (reference config.json:44-70)."""

    depth: int = 32
    hidden_size: int = 1280
    intermediate_size: int = 3420
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    tokens_per_second: int = 2
    window_size: int = 112
    out_hidden_size: int = 2048
    fullatt_block_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    hidden_act: str = "silu"
    initializer_range: float = 0.02

    def __post_init__(self):
        if self.hidden_act not in ("silu", "swish"):
            raise ValueError(
                f"unsupported hidden_act {self.hidden_act!r} (the ViT MLP "
                "implements silu/swish; the merger's gelu is structural)"
            )

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def spatial_merge_unit(self) -> int:
        return self.spatial_merge_size * self.spatial_merge_size

    @property
    def merger_window(self) -> int:
        """Window edge length in merged-token units (reference
        modeling_infinitevl.py:775)."""
        return self.window_size // self.spatial_merge_size // self.patch_size


@dataclasses.dataclass(frozen=True)
class TextConfig:
    """Hybrid SWA / Gated-DeltaNet decoder config.

    Defaults follow the deployed InfiniteVL-3B config (reference
    config.json:1-42) rather than the class defaults of the reference
    (which describe a 72B-scale model that is never instantiated)."""

    vocab_size: int = 151936
    hidden_size: int = 2048
    intermediate_size: int = 11008
    num_hidden_layers: int = 36
    num_attention_heads: int = 16
    num_key_value_heads: int = 2
    head_dim: int = 128
    hidden_act: str = "silu"
    max_position_embeddings: int = 128000
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    use_sliding_window: bool = True
    sliding_window: int = 8192
    layer_types: Optional[Tuple[str, ...]] = None
    attention_dropout: float = 0.0
    tie_word_embeddings: bool = True
    mrope_section: Tuple[int, ...] = (16, 24, 24)
    attention_scaling: float = 1.0  # derived for yarn (0.1*ln(factor)+1)

    # --- rope scaling variant (reference model_utils/rope.py:35 activates
    # the transformers default/linear/dynamic/yarn/llama3 inits) ---
    rope_type: str = "default"
    rope_factor: float = 1.0
    rope_original_max_position_embeddings: Optional[int] = None
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0

    # --- Gated DeltaNet (linear attention) branch ---
    expand_v: float = 2.0
    mode: str = "chunk"
    use_gate: bool = True
    use_short_conv: bool = True
    conv_size: int = 4
    conv_bias: bool = False
    num_linear_heads: int = 16
    num_linear_key_value_heads: int = 16
    linear_head_dim: int = 128
    norm_eps: float = 1e-5

    # --- build knobs (no reference counterpart) ---
    # Chunk length of the chunkwise delta rule. The reference Triton kernel
    # uses BT=64; the math is chunk-size invariant. Kernel C takes 64.
    delta_chunk_size: int = 64
    # Sequence length at or below which the step-by-step recurrence is used
    # instead of the chunk form (reference modeling_infinitevl.py:1230).
    recurrent_threshold: int = 64
    # If True, multi-token delta-layer prefill uses the cached short-conv
    # history as left context. The reference's multi-token path zero-pads
    # instead; keep False for token parity with the reference.
    conv_carry: bool = False
    # knobs of the JAX build, read by nothing in the port
    use_pallas_swa: bool = True
    use_pallas_delta_step: bool = True
    mlp_chunk_t: int = 4096
    delta_stream_min_chunks: int = 128
    delta_seq_chunk_t: int = 8192
    delta_seq_chunk_eval: int = 4096

    def __post_init__(self):
        # the compute path implements exactly the deployed activation
        # (SwiGLU, models/text.mlp_forward); anything else must fail loudly
        # at config time rather than silently run silu
        if self.hidden_act not in ("silu", "swish"):
            raise ValueError(
                f"unsupported hidden_act {self.hidden_act!r} (the MLP path "
                "implements silu/swish; the reference config.json uses silu)"
            )
        if self.layer_types is None:
            object.__setattr__(
                self, "layer_types", _default_layer_types(self.num_hidden_layers)
            )
        else:
            object.__setattr__(self, "layer_types", tuple(self.layer_types))
        if len(self.layer_types) != self.num_hidden_layers:
            raise ValueError(
                f"layer_types has {len(self.layer_types)} entries for "
                f"{self.num_hidden_layers} layers"
            )
        if self.rope_type == "yarn" and self.attention_scaling == 1.0:
            # yarn scales attention by 0.1*ln(factor) + 1 (transformers
            # _compute_yarn_parameters attention_factor default)
            import math

            object.__setattr__(
                self,
                "attention_scaling",
                0.1 * math.log(self.rope_factor) + 1.0,
            )

    # --- Derived DeltaNet dims (reference modeling_infinitevl.py:1139-1147) ---
    @property
    def linear_key_dim(self) -> int:
        return self.num_linear_key_value_heads * self.linear_head_dim

    @property
    def linear_value_dim(self) -> int:
        return int(self.linear_key_dim * self.expand_v)

    @property
    def head_v_dim(self) -> int:
        return int(self.linear_head_dim * self.expand_v)

    @property
    def swa_layer_indices(self) -> Tuple[int, ...]:
        return tuple(
            i for i, t in enumerate(self.layer_types) if t in _SLIDING_ALIASES
        )

    @property
    def full_layer_indices(self) -> Tuple[int, ...]:
        return tuple(i for i, t in enumerate(self.layer_types) if t == FULL)

    @property
    def linear_layer_indices(self) -> Tuple[int, ...]:
        return tuple(
            i for i, t in enumerate(self.layer_types) if t in _LINEAR_ALIASES
        )

    @property
    def mamba2_layer_indices(self) -> Tuple[int, ...]:
        return tuple(i for i, t in enumerate(self.layer_types) if t == MAMBA2)

    @property
    def num_mamba2_layers(self) -> int:
        return len(self.mamba2_layer_indices)

    @property
    def num_swa_layers(self) -> int:
        return len(self.swa_layer_indices)

    @property
    def num_linear_layers(self) -> int:
        return len(self.linear_layer_indices)

    @property
    def swa_capacity(self) -> int:
        """Ring-buffer capacity. The reference preallocates window - 1 slots
        (modeling_infinitevl.py:84-93); the full window keeps the layout of
        the JAX package. Visibility is enforced by the position mask
        (kp > qp - W), so the extra slot only ever holds a stale,
        never-visible key: attention outputs are identical."""
        return self.sliding_window

    def layer_role(self, idx: int) -> str:
        t = self.layer_types[idx]
        if t in _LINEAR_ALIASES:
            return LINEAR
        if t in _SLIDING_ALIASES:
            return SLIDING
        if t == MAMBA2:
            return MAMBA2
        return FULL


@dataclasses.dataclass(frozen=True)
class InfiniteVLConfig:
    text: TextConfig = dataclasses.field(default_factory=TextConfig)
    vision: VisionConfig = dataclasses.field(default_factory=VisionConfig)
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    vision_end_token_id: int = 151653
    bos_token_id: int = 151643
    eos_token_id: int = 151645

    @property
    def tokens_per_frame_448(self) -> int:
        """Visual tokens for a 448x448 frame (demo_streaming_inference.py:55)."""
        p = self.vision.patch_size * self.vision.spatial_merge_size
        return (448 // p) ** 2


def infinitevl_3b() -> InfiniteVLConfig:
    """The deployed InfiniteVL-3B configuration (reference config.json)."""
    return InfiniteVLConfig()


def tiny_config(
    num_hidden_layers: int = 8,
    hidden_size: int = 64,
    vocab_size: int = 512,
    sliding_window: int = 16,
    vision_depth: int = 2,
) -> InfiniteVLConfig:
    """Small config for tests; preserves the hybrid 1:3 layer pattern."""
    text = TextConfig(
        vocab_size=vocab_size,
        hidden_size=hidden_size,
        intermediate_size=hidden_size * 2,
        num_hidden_layers=num_hidden_layers,
        num_attention_heads=4,
        num_key_value_heads=2,
        head_dim=16,
        sliding_window=sliding_window,
        mrope_section=(4, 2, 2),
        num_linear_heads=4,
        num_linear_key_value_heads=4,
        linear_head_dim=16,
        delta_chunk_size=8,
        recurrent_threshold=8,
        max_position_embeddings=2048,
    )
    vision = VisionConfig(
        depth=vision_depth,
        hidden_size=32,
        intermediate_size=64,
        num_heads=4,
        out_hidden_size=hidden_size,
        fullatt_block_indexes=(vision_depth - 1,),
    )
    # special-token ids must live inside the tiny vocab
    return InfiniteVLConfig(
        text=text,
        vision=vision,
        image_token_id=vocab_size - 2,
        video_token_id=vocab_size - 3,
        vision_start_token_id=vocab_size - 4,
        vision_end_token_id=vocab_size - 5,
        bos_token_id=vocab_size - 6,
        eos_token_id=vocab_size - 7,
    )


def from_hf_dict(d: Dict[str, Any]) -> InfiniteVLConfig:
    """Build a config from an HF-format config.json dict
    (reference configuration_infinitevl.py:300-394 field layout)."""
    vd = dict(d.get("vision_config", {}))
    vision_fields = {f.name for f in dataclasses.fields(VisionConfig)}
    vision = VisionConfig(
        **{k: _tupled(v) for k, v in vd.items() if k in vision_fields}
    )

    td = {k: v for k, v in d.items() if k != "vision_config"}
    td.update(d.get("text_config", {}))
    rope_scaling = td.get("rope_scaling") or {}
    text_fields = {f.name for f in dataclasses.fields(TextConfig)}
    tkw = {k: _tupled(v) for k, v in td.items() if k in text_fields}
    if "mrope_section" in rope_scaling:
        tkw["mrope_section"] = tuple(rope_scaling["mrope_section"])
    rt = rope_scaling.get("rope_type", rope_scaling.get("type", "default"))
    if rt not in ("default", "mrope"):  # HF marks plain mrope as "default"
        tkw["rope_type"] = rt
        if "factor" in rope_scaling:
            tkw["rope_factor"] = float(rope_scaling["factor"])
        for src, dst in (
            ("original_max_position_embeddings", "rope_original_max_position_embeddings"),
            ("beta_fast", "rope_beta_fast"),
            ("beta_slow", "rope_beta_slow"),
            ("low_freq_factor", "rope_low_freq_factor"),
            ("high_freq_factor", "rope_high_freq_factor"),
        ):
            if src in rope_scaling:
                tkw[dst] = rope_scaling[src]
    if "head_dim" not in tkw and "hidden_size" in tkw and "num_attention_heads" in tkw:
        tkw["head_dim"] = tkw["hidden_size"] // tkw["num_attention_heads"]
    if not td.get("use_sliding_window", True):
        tkw["sliding_window"] = td.get("max_position_embeddings", 32768)
    text = TextConfig(**tkw)

    top_fields = {f.name for f in dataclasses.fields(InfiniteVLConfig)}
    top = {k: v for k, v in d.items() if k in top_fields and k not in ("text", "vision")}
    return InfiniteVLConfig(text=text, vision=vision, **top)


def from_hf_json(path: str) -> InfiniteVLConfig:
    with open(path) as f:
        return from_hf_dict(json.load(f))


def _tupled(v):
    return tuple(v) if isinstance(v, list) else v
