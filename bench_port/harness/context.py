"""What run.py hands a driver, and what a driver hands back."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, List, Optional

from .trace import TraceSummary


@dataclasses.dataclass
class RunContext:
    cell: Any  # harness.spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: Any  # torch.device
    t_process: float  # perf_counter at the process's start: set-up counts from here


@dataclasses.dataclass
class Readings:
    """What the per-layer readers read."""
    bench_dir: Path
    trace: Optional[TraceSummary]
    calls: Dict[str, List[Dict[str, Any]]]  # kernel -> shapes of its calls in the traced steps
    window: Dict[str, Any]  # the window's own series and totals


@dataclasses.dataclass
class DriverResult:
    end_to_end: Dict[str, float]  # name -> value, setup_s included
    attempted: int
    failed: int
    checks: Dict[str, float]  # name -> the number compared with the reference
    memory_peak_bytes: int
    readings: Readings
    notes: List[str] = dataclasses.field(default_factory=list)  # lines for standard error
    checked: Any = None  # what the comparison judged (the control's calibration reads it)
