"""Logging / observability: process logger, JSONL trainer log, loss plots.

Covers the reference's extras/logging.py (rank-0 logger), LogCallback's
trainer_log.jsonl (train/callbacks.py:173), extras/ploting.py loss curves,
and ReporterCallback (train/callbacks.py:356-385: wandb/swanlab run meta) —
here as `make_reporter(report_to=...)`: tensorboard event files when the
package is present, wandb/swanlab import-gated. The
JSONL log stays the durable record either way."""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any, Dict


def get_logger(name: str = "infinitevl_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(
            logging.Formatter("[%(asctime)s] %(levelname)s %(name)s: %(message)s")
        )
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger


def is_main_process() -> bool:
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


class TrainerLog:
    """Append-only JSONL metrics log + optional loss plot."""

    def __init__(self, output_dir: str, filename: str = "trainer_log.jsonl"):
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, filename)
        self._t0 = time.time()
        self.records: list[Dict[str, Any]] = []

    def log(self, step: int, **metrics: Any) -> None:
        rec = {"current_steps": step, "elapsed_s": round(time.time() - self._t0, 2)}
        rec.update(
            {k: (float(v) if hasattr(v, "item") or isinstance(v, float) else v)
             for k, v in metrics.items()}
        )
        self.records.append(rec)
        if is_main_process():
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")

    def plot_loss(self, key: str = "loss", filename: str = "training_loss.png"):
        """Save a loss curve (extras/ploting.py:69 equivalent)."""
        steps = [r["current_steps"] for r in self.records if key in r]
        vals = [r[key] for r in self.records if key in r]
        if not steps:
            return None
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots(figsize=(7, 4))
            ax.plot(steps, vals)
            ax.set_xlabel("step")
            ax.set_ylabel(key)
            ax.set_title(f"training {key}")
            out = os.path.join(self.output_dir, filename)
            fig.savefig(out, dpi=100, bbox_inches="tight")
            plt.close(fig)
            return out
        except ImportError:
            return None


class Reporter:
    """Fan metrics out to external trackers (ReporterCallback equivalent).

    Backends resolve at construction; unknown/unavailable ones raise so a
    yaml typo is loud (the reference errors the same way via HF Trainer's
    report_to validation)."""

    def __init__(self, targets, output_dir: str, run_meta: Dict[str, Any] | None = None):
        self.backends = []
        for t in targets:
            if t in ("none", None):
                continue
            if t == "tensorboard":
                from torch.utils.tensorboard import SummaryWriter

                w = SummaryWriter(log_dir=os.path.join(output_dir, "runs"))
                if run_meta:
                    w.add_text("run_meta", json.dumps(run_meta, default=str))
                self.backends.append(("tensorboard", w))
            elif t == "wandb":
                import wandb  # gated: not in the offline image

                run = wandb.init(dir=output_dir, config=run_meta or {})
                self.backends.append(("wandb", run))
            elif t == "swanlab":
                import swanlab  # gated: not in the offline image

                run = swanlab.init(logdir=output_dir, config=run_meta or {})
                self.backends.append(("swanlab", run))
            else:
                raise ValueError(
                    f"unknown report_to target {t!r} "
                    "(one of tensorboard/wandb/swanlab/none)"
                )

    def log(self, step: int, **metrics: Any) -> None:
        if not is_main_process():
            return
        scalars = {
            k: float(v)
            for k, v in metrics.items()
            if isinstance(v, (int, float)) or hasattr(v, "item")
        }
        for kind, b in self.backends:
            if kind == "tensorboard":
                for k, v in scalars.items():
                    b.add_scalar(k, v, global_step=step)
            else:  # wandb / swanlab share the .log({...}, step=) shape
                b.log(scalars, step=step)

    def close(self) -> None:
        for kind, b in self.backends:
            if kind == "tensorboard":
                b.close()
            elif kind == "wandb":
                b.finish()
            else:
                b.finish()


def make_reporter(
    report_to, output_dir: str, run_meta: Dict[str, Any] | None = None
) -> Reporter:
    """Build a Reporter from a yaml `report_to` value (str or list)."""
    if report_to is None or report_to == "none":
        targets = []
    elif isinstance(report_to, str):
        targets = [report_to]
    else:
        targets = list(report_to)
    return Reporter(targets, output_dir, run_meta)


def calculate_tps(num_tokens: int, elapsed_s: float, num_devices: int = 1) -> float:
    """Effective tokens/sec (extras/misc.py calculate_tps equivalent)."""
    return num_tokens / max(elapsed_s, 1e-9)
