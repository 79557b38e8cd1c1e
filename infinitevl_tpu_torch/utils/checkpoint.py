"""Train-state checkpoints (torch port of the train-state half of
infinitevl_tpu/utils/checkpoint.py; the port's own format).

A checkpoint is one `step_<n>.pt` file under the checkpoint directory,
written by `torch.save` to a temporary name and renamed, so a reader never
sees a partial file. The state is any nest of dicts, lists, tensors and
plain numbers (parameters or adapters, the optimizer state, the step).
Tensors are saved from the CPU and restored onto the device of the
template's matching leaf, bit for bit."""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Tuple

import torch

_STEP_FILE = re.compile(r"step_(\d+)\.pt$")


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def save_train_state(path: str, step: int, state: Dict[str, Any]) -> None:
    """Write `state` as checkpoint `step` under directory `path`."""
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, f"step_{int(step)}.pt")
    tmp = f"{final}.tmp.{os.getpid()}"
    torch.save({"step": int(step), "state": _map(lambda t: t.detach().cpu(), state)}, tmp)
    os.replace(tmp, final)


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(path)) if m]
    return max(steps, default=None)


def _like(template, loaded):
    """`loaded` with every tensor moved to its template leaf's device and
    dtype, and marked trainable where the template's leaf is."""
    if isinstance(template, dict):
        return {k: _like(template[k], loaded[k]) if k in template else loaded[k]
                for k in loaded}
    if isinstance(template, (list, tuple)):
        return type(template)(_like(t, l) for t, l in zip(template, loaded))
    if isinstance(template, torch.Tensor) and isinstance(loaded, torch.Tensor):
        out = loaded.to(device=template.device, dtype=template.dtype)
        return out.requires_grad_(template.requires_grad)
    return loaded


def restore_train_state(
    path: str, step: Optional[int] = None, template: Optional[Dict[str, Any]] = None
) -> Tuple[Optional[int], Optional[Dict[str, Any]]]:
    """(step, state) of checkpoint `step` (default: the latest) under
    `path`, or (None, None) when there is none. With a `template`, tensors
    land on the devices of the template's leaves."""
    step = step if step is not None else latest_step(path)
    if step is None:
        return None, None
    blob = torch.load(os.path.join(path, f"step_{int(step)}.pt"), map_location="cpu",
                      weights_only=True)
    state = blob["state"]
    return int(blob["step"]), _like(template, state) if template is not None else state


def merge_params(base: Dict[str, Any], update: Dict[str, Any]) -> Dict[str, Any]:
    """Recursively overlay `update` onto `base` (missing keys keep base)."""
    if isinstance(base, dict):
        out = dict(base)
        for k, v in (update or {}).items():
            out[k] = merge_params(base[k], v) if k in base else v
        return out
    if isinstance(base, (list, tuple)):
        return type(base)(merge_params(b, u) for b, u in zip(base, update))
    return update if update is not None else base
