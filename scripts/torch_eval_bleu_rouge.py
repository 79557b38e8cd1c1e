"""Score generated predictions with BLEU-4 / ROUGE (torch port of
scripts/eval_bleu_rouge.py, on the PyTorch package's metrics): reads a
jsonl with "predict" and "label" fields (the format written by generation
runs) and prints corpus-average metrics.

Usage: python scripts/torch_eval_bleu_rouge.py predictions.jsonl
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(path: str) -> dict:
    from infinitevl_tpu_torch.eval.text_metrics import compute_similarity

    preds, refs = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            preds.append(row["predict"])
            refs.append(row["label"])
    scores = compute_similarity(preds, refs)
    scores["samples"] = len(preds)
    print(json.dumps(scores, indent=2))
    return scores


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    main(sys.argv[1])
