"""MMLU / C-Eval-style multiple-choice evaluator (torch port of
infinitevl_tpu/eval/mcq.py): few-shot prompts, the argmax over the
choice letters' logits at the next position, per-category accuracy.

Prompts are left-padded to the next multiple of 128 and scored in batches
of one bucket: the pads lead each row in segment 0, the prompt follows in
segment 1 with positions from 0, and the stateless forward masks the pads
from the prompt (on the card: kernel H, the short conv and kernel C's
packed path take the segment ids)."""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

CHOICES = ("A", "B", "C", "D")

# per-language instruction / answer strings ("en" and "zh" eval templates)
_LANG = {
    "en": {
        "system": (
            "The following are multiple choice questions (with answers) "
            "about {subject}.\n\n"
        ),
        "answer": "Answer:",
    },
    "zh": {
        "system": "以下是关于{subject}的单项选择题，请直接给出正确答案的选项。\n\n",
        "answer": "答案：",
    },
}


def format_example(
    example: Dict[str, Any],
    support_set: Sequence[Dict[str, Any]] = (),
    subject_name: str = "",
    lang: str = "en",
) -> str:
    """Few-shot MCQ prompt."""
    strings = _LANG.get(lang, _LANG["en"])
    parts = []
    if subject_name:
        parts.append(strings["system"].format(subject=subject_name))
    for ex in support_set:
        parts.append(_one(ex, strings, with_answer=True))
    parts.append(_one(example, strings, with_answer=False))
    return "".join(parts)


def _one(ex: Dict[str, Any], strings: Dict[str, str], with_answer: bool) -> str:
    s = ex["question"] + "\n"
    for c in CHOICES:
        if c in ex and ex[c]:
            s += f"{c}. {ex[c]}\n"
    s += strings["answer"]
    if with_answer:
        s += f" {ex['answer']}\n\n"
    return s


def _bucket_len(n: int, quantum: int = 128) -> int:
    return max(quantum, -(-n // quantum) * quantum)


def left_padded_batch(rows: Sequence[np.ndarray], P: int):
    """(ids, position_ids [3, B, P], segment_ids) of prompts left-padded to P."""
    B = len(rows)
    ids = np.zeros((B, P), np.int64)
    seg = np.zeros((B, P), np.int32)
    pos = np.zeros((B, P), np.int64)
    for r, e in enumerate(rows):
        e = e[-P:]
        L = len(e)
        ids[r, P - L:] = e
        seg[r, P - L:] = 1
        pos[r, P - L:] = np.arange(L)
    return ids, np.ascontiguousarray(np.broadcast_to(pos[None], (3, B, P))), seg


@torch.no_grad()
def last_logits(params, cfg, ids, pos, seg, device) -> torch.Tensor:
    """fp32 logits [B, vocab] at the last position of a left-padded batch."""
    from ..models.infinitevl import forward

    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    logits, _ = forward(params, cfg, as_t(ids), as_t(pos), state=None,
                        segment_ids=as_t(seg), logits_to_keep=1)
    return logits[:, 0]


class MCQEvaluator:
    """Choice-logit MCQ scoring with length buckets: prompts are left-padded
    to the next 128 multiple and scored in batches of `batch_size` rows
    (a short batch repeats its rows to fill the shape), on the generator's
    device and weights."""

    def __init__(self, generator, tokenizer, batch_size: int = 8, lang: str = "en"):
        self.lang = lang
        self.generator = generator
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.choice_ids = [
            self.tokenizer.encode(f" {c}", add_special_tokens=False)[-1] for c in CHOICES
        ]

    def choice_logits(self, prompts: Sequence[str]) -> np.ndarray:
        """[len(prompts), 4] fp32 logits of the choice letters."""
        g = self.generator
        encoded = [np.asarray(self.tokenizer.encode(p, add_special_tokens=False), np.int64)
                   for p in prompts]
        out = np.zeros((len(prompts), len(CHOICES)), np.float32)
        by_bucket: Dict[int, List[int]] = {}
        for i, ids in enumerate(encoded):
            by_bucket.setdefault(_bucket_len(len(ids)), []).append(i)
        B = self.batch_size
        for P, idxs in sorted(by_bucket.items()):
            for s in range(0, len(idxs), B):
                chunk = idxs[s : s + B]
                rows = (chunk * B)[:B]  # repeat to fill the batch
                ids, pos, seg = left_padded_batch([encoded[i] for i in rows], P)
                logits = last_logits(g.params, g.cfg, ids, pos, seg, g.device)
                scores = logits[:, self.choice_ids].cpu().numpy()
                out[chunk] = scores[: len(chunk)]
        return out

    def _score_prompts(self, prompts: Sequence[str]) -> List[str]:
        scores = self.choice_logits(prompts)
        return [CHOICES[int(np.argmax(row))] for row in scores]

    def score_one(self, prompt: str) -> str:
        """Argmax over the choice-letter logits at the next position."""
        return self._score_prompts([prompt])[0]

    def evaluate(
        self,
        examples: Sequence[Dict[str, Any]],
        support_set: Sequence[Dict[str, Any]] = (),
        subject_name: str = "",
    ) -> Dict[str, float]:
        prompts = [format_example(ex, support_set, subject_name, lang=self.lang)
                   for ex in examples]
        preds = self._score_prompts(prompts)
        correct = 0
        per_category: Dict[str, List[bool]] = {}
        for ex, pred in zip(examples, preds):
            ok = pred == ex["answer"]
            correct += ok
            per_category.setdefault(ex.get("category", "all"), []).append(ok)
        out = {"accuracy": correct / max(len(examples), 1)}
        for cat, oks in per_category.items():
            out[f"accuracy/{cat}"] = sum(oks) / len(oks)
        return out

    def evaluate_task(self, task: Dict[str, Dict[str, Any]], n_shot: int = 5
                      ) -> Dict[str, float]:
        """MMLU-style benchmark {subject: {name, dev: [...], test: [...]}}:
        few-shot support from each subject's dev split; overall and
        per-subject accuracy."""
        out: Dict[str, float] = {}
        total_ok, total_n = 0.0, 0
        for subject, block in task.items():
            support = list(block.get("dev", ()))[: max(n_shot, 0)]
            examples = block["test"]
            metrics = self.evaluate(examples, support, block.get("name", subject))
            out[f"accuracy/{subject}"] = metrics["accuracy"]
            total_ok += metrics["accuracy"] * len(examples)
            total_n += len(examples)
        out["accuracy"] = total_ok / max(total_n, 1)
        return out
