"""Per-family multimodal plugins beyond the Qwen2VL scheme (torch port of
infinitevl_tpu/data/mm_plugin.py, the port's own copy: numpy only).

The reference backs every shipped multimodal chat template with an
mm_plugin that (a) expands image placeholders into the family's own image
tokens and (b) produces the pixel tensors that family's vision tower
expects (reference data/mm_plugin.py registry, :1378; Gemma3Plugin :407,
PaliGemmaPlugin :913). Here the two SIMPLEST families — fixed token count,
fixed square resize, no dynamic tiling — are implemented minimally so their
registered templates are trainable on image data; every other family stays
a loud error in `encode_supervised_mm`.

Scope notes (documented, honest):
- PaliGemma (processor image_seq_length, default 256 @ 224 px): the
  reference plugin STRIPS <image> placeholders from message text and
  PREPENDS num_images * image_seqlen `<image>` tokens to input_ids with
  IGNORE labels (mm_plugin.py:940-958). SigLIP normalization (mean/std
  0.5).
- Gemma3 (no pan-and-scan — the reference only enables it via processor
  flags): each <image> placeholder becomes the processor's
  full_image_sequence, i.e. "\n\n<start_of_image>" + 256 soft tokens +
  "<end_of_image>\n\n" (mm_plugin.py:407-446); pixels resize to 896 px,
  SigLIP normalization.
- Videos are NOT supported by either family's reference plugin; raise.

The pixel output is `pixel_values` [N, 3, S, S] float32 — the HF layout
those checkpoints consume — NOT the InfiniteVL flat-patch layout. The
InfiniteVL training engine only consumes the Qwen2VL scheme; these
pipelines exist for data-layer parity (encode once, train/export with the
family's own tower)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

IMAGE_PLACEHOLDER = "<image>"


@dataclasses.dataclass(frozen=True)
class FamilyMMPlugin:
    """One family's minimal image scheme: fixed-count token expansion +
    fixed-size square pixel preprocessing."""

    name: str
    image_token: str       # the literal token the family's tokenizer knows
    image_seqlen: int      # fixed tokens per image
    image_size: int        # square resize target (px)
    mode: str              # 'prepend' (paligemma) | 'replace' (gemma3)
    boi: str = ""          # replace-mode wrapping, before the soft tokens
    eoi: str = ""          # ... and after
    mean: float = 0.5      # SigLIP normalization (both families)
    std: float = 0.5

    def full_image_sequence(self) -> str:
        return self.boi + self.image_token * self.image_seqlen + self.eoi

    def expand_messages(
        self, messages: List[Dict[str, str]], n_images: int
    ) -> List[Dict[str, str]]:
        """Apply the family's placeholder policy to message contents.
        Returns new messages; raises when the placeholder count does not
        match n_images (reference plugins' invariant)."""
        seen = 0
        out = []
        for m in messages:
            content = m["content"]
            while IMAGE_PLACEHOLDER in content:
                repl = (
                    "" if self.mode == "prepend"
                    else self.full_image_sequence()
                )
                content = content.replace(IMAGE_PLACEHOLDER, repl, 1)
                seen += 1
            out.append({**m, "content": content})
        if seen != n_images:
            raise ValueError(
                f"{self.name}: {seen} {IMAGE_PLACEHOLDER} placeholders but "
                f"{n_images} images"
            )
        return out

    def prefix_ids(
        self, tokenizer, n_images: int
    ) -> Tuple[List[int], List[int]]:
        """prepend-mode token prefix (ids, labels): n_images * seqlen image
        tokens, labels IGNORE (filled by the caller's IGNORE_INDEX)."""
        if self.mode != "prepend" or n_images == 0:
            return [], []
        tok = tokenizer.encode(self.image_token, add_special_tokens=False)
        if len(tok) != 1:
            raise ValueError(
                f"{self.name}: tokenizer must map {self.image_token!r} to "
                f"one id, got {tok}"
            )
        return tok * (self.image_seqlen * n_images), []

    def preprocess_image(self, img: np.ndarray) -> np.ndarray:
        """[H, W, 3] uint8 -> [3, S, S] float32, fixed resize + SigLIP
        rescale/normalize (the families' image processors)."""
        from .processing import resize_bicubic

        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"expected [H, W, 3] image, got {img.shape}")
        resized = resize_bicubic(img, self.image_size, self.image_size)
        x = resized.astype(np.float32) / 255.0
        x = (x - self.mean) / self.std
        return np.ascontiguousarray(x.transpose(2, 0, 1))


MM_PLUGINS: Dict[str, FamilyMMPlugin] = {}
for _n in ("paligemma", "paligemma_chat"):
    MM_PLUGINS[_n] = FamilyMMPlugin(
        name=_n, image_token="<image>", image_seqlen=256, image_size=224,
        mode="prepend",
    )
for _n in ("gemma3",):
    MM_PLUGINS[_n] = FamilyMMPlugin(
        name=_n, image_token="<image_soft_token>", image_seqlen=256,
        image_size=896, mode="replace", boi="\n\n<start_of_image>",
        eoi="<end_of_image>\n\n",
    )


def get_mm_plugin(template_name: str) -> Optional[FamilyMMPlugin]:
    return MM_PLUGINS.get(template_name)
