"""The device the port's entry points run on when the caller names none.

The port is written for an NVIDIA GPU: `default_device()` is the current
CUDA card, and it raises where there is none. It never returns the CPU;
a caller that wants the CPU (the tests) passes device="cpu" explicitly."""

from __future__ import annotations

from typing import Optional, Union

import torch

Device = Union[str, torch.device]


def default_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "infinitevl_tpu_torch runs on a CUDA GPU and none is available "
            "(torch.cuda.is_available() is False); pass device='cpu' "
            "explicitly to run the plain versions on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device: Optional[Device]) -> torch.device:
    """`device` as a torch.device; None means `default_device()`."""
    return default_device() if device is None else torch.device(device)
