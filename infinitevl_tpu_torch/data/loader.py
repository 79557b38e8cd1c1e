"""Tokenizer selection (the tokenizer half of infinitevl_tpu/data/loader.py:
`SimpleTokenizer` and `resolve_tokenizer`; the dataset half belongs to the
training slice and is not ported)."""

from __future__ import annotations

import re
from typing import Dict, List, Optional


class SimpleTokenizer:
    """Word-level tokenizer for tests and offline smoke runs (real
    deployments pass the HF Qwen2 tokenizer). Special tokens of the form
    <|...|> — and bare <snake_case> family specials like <image> /
    <image_soft_token> (mm_plugin families concatenate them without
    whitespace) — are split out even without surrounding whitespace."""

    _SPECIAL = re.compile(r"(<\|[^|>]+\|>|<[a-z][a-z_]*>)")

    def __init__(self, vocab: Optional[Dict[str, int]] = None, unk: int = 1,
                 config=None):
        self.vocab = dict(vocab or {})
        self.unk = unk
        self.eos_token_id = 2
        if config is not None:
            # pin vision control tokens to the config's ids so multimodal
            # masks line up in offline smoke runs
            self.vocab["<|image_pad|>"] = config.image_token_id
            self.vocab["<|video_pad|>"] = config.video_token_id
            self.vocab["<|vision_start|>"] = config.vision_start_token_id
            self.vocab["<|vision_end|>"] = config.vision_end_token_id
            self.eos_token_id = config.eos_token_id

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids = []
        for piece in self._SPECIAL.split(text.replace("\n", " \\n ")):
            words = [piece] if self._SPECIAL.fullmatch(piece) else piece.split()
            for w in words:
                if w not in self.vocab:
                    self.vocab[w] = len(self.vocab) + 10
                ids.append(self.vocab[w])
        return ids

    def decode(self, ids, skip_special_tokens=True):
        rev = {v: k for k, v in self.vocab.items()}
        return " ".join(rev.get(int(i), "<unk>") for i in ids)


def resolve_tokenizer(args=None, cfg=None, tokenizer=None):
    """Central tokenizer selection: an explicit tokenizer wins; else HF
    tokenizer files (tokenizer_path or model_name_or_path) whenever
    present; SimpleTokenizer only as the offline fallback."""
    if tokenizer is not None:
        return tokenizer
    path = None
    if args is not None:
        path = getattr(args.model, "tokenizer_path", None) or getattr(
            args.model, "model_name_or_path", None
        )
    if path:
        import os

        marker_files = (
            "tokenizer.json", "tokenizer_config.json", "vocab.json",
            "tokenizer.model",
        )
        if any(os.path.exists(os.path.join(path, f)) for f in marker_files):
            from transformers import AutoTokenizer

            return AutoTokenizer.from_pretrained(path)
    return SimpleTokenizer(config=cfg)
