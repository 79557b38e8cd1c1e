"""The readers that per-layer metric files are made of. A metric file
(metrics/<name>.py) binds `read` to one of these; `read(ctx)` returns the
metric's value, or None where the run holds nothing for it to read (then
the metric is left out of the result line; a share of a roofline or a peak
never reads 0 for want of data).

`ctx` (harness.context.Readings) holds the traced stretch's summary, the
kernel calls the driver declared for the traced steps with their shapes,
and the window's own numbers."""

from __future__ import annotations

from typing import Callable, Optional

from . import peaks
from .spec import work_module

Reader = Callable[[object], Optional[float]]


def roofline(kernel: str) -> Reader:
    """Sum over the traced steps of the kernel's bound (work/<kernel>.py, from
    the declared calls' shapes) over the device time of its launches, in %."""

    def read(ctx):
        calls = ctx.calls.get(kernel)
        if ctx.trace is None or not calls:
            return None
        work = work_module(ctx.bench_dir, kernel)
        dev_s, n = ctx.trace.kernel_time_s(work.TRACE_NAMES)
        if n == 0 or dev_s <= 0:
            return None
        bound = sum(peaks.bound_s(*work.work(**shape)) for shape in calls)
        return 100.0 * bound / dev_s

    return read


def launches_per_step() -> Reader:
    """Kernel launches in the traced stretch over its steps (an exact count)."""

    def read(ctx):
        if ctx.trace is None or ctx.trace.steps <= 0:
            return None
        return len(ctx.trace.kernels) / ctx.trace.steps

    return read


def device_idle_pct() -> Reader:
    """The share of the traced stretch in which no operation ran on the device."""

    def read(ctx):
        if ctx.trace is None or ctx.trace.window_s <= 0:
            return None
        return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)

    return read


def mfu(flops_key: str, seconds_key: str) -> Reader:
    """The model FLOPs of the window's work over the window's time, as a
    share of the card's bf16 peak."""

    def read(ctx):
        f, s = ctx.window.get(flops_key), ctx.window.get(seconds_key)
        if not f or not s:
            return None
        return 100.0 * f / s / peaks.PEAK_BF16_FLOPS

    return read


def window_mean(key: str, scale: float = 1.0) -> Reader:
    """The mean of a per-step series the driver kept over the window."""

    def read(ctx):
        xs = ctx.window.get(key)
        if not xs:
            return None
        return scale * sum(xs) / len(xs)

    return read
