"""The traced stretch of a `--trace 1` run: torch.profiler over a few steady
steps after the measured window, reduced to what the per-layer metrics
read. Device events give the kernels (names, intervals); host events, the
benchmark's own `bench.*` annotations among them, say what the host was
doing in each gap in which the device sat idle. Nothing is written to
disk."""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

WINDOW_MARK = "bench.traced_window"
ANNOTATIONS = ("bench.",)  # the benchmark's own record_function ranges
NOT_KERNELS = ("memcpy", "memset", "Memcpy", "Memset")


@dataclasses.dataclass
class TraceSummary:
    kernels: List[Tuple[str, int, int]]  # (name, start ns, end ns) of every kernel launch
    busy_s: float  # union of device activity inside the window
    window_s: float
    steps: int  # the driver's steps (or requests) inside the window
    device_ops: List[List]  # [[name, seconds]], the ten largest
    idle_gaps: List[List]  # [[what the host did, seconds]], the ten longest

    def kernel_time_s(self, names: Sequence[str]) -> Tuple[float, int]:
        """Device seconds and launch count of the kernels whose names hold one
        of `names` (a kernel's trace name carries its namespace, template
        arguments and signature around the function's name)."""
        t, n = 0, 0
        for name, s, e in self.kernels:
            if any(k in name for k in names):
                t += e - s
                n += 1
        return t * 1e-9, n


@contextlib.contextmanager
def profiled():
    """torch.profiler over CPU and CUDA; yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=False, with_stack=False) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def window_mark():
    import torch

    return torch.profiler.record_function(WINDOW_MARK)


def _union(iv: np.ndarray) -> np.ndarray:
    """Merge intervals [n, 2] (sorted by start) into disjoint ones."""
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out, dtype=np.int64).reshape(-1, 2)


def summarize(prof, steps: int) -> TraceSummary:
    """Reduce a profile whose steps ran inside `window_mark()`."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    win: Optional[Tuple[int, int]] = None
    for e in prof.profiler.kineto_results.events():
        s = int(e.start_ns())
        end = s + int(e.duration_ns())
        name = e.name()
        if e.device_type() == cuda:
            if not name.startswith(ANNOTATIONS):  # a host range mirrored on the device
                dev.append((name, s, end))
        else:
            if name == WINDOW_MARK:
                win = (s, end)
            host.append((name, s, end))
    if win is None:
        raise RuntimeError(f"the profile holds no {WINDOW_MARK} range")
    w0, w1 = win
    inside = [(n, max(s, w0), min(e, w1)) for n, s, e in dev if e > w0 and s < w1]
    kernels = [x for x in inside if not any(t in x[0] for t in NOT_KERNELS)]
    iv = np.asarray(sorted((s, e) for _, s, e in inside), dtype=np.int64).reshape(-1, 2)
    busy = _union(iv)
    busy_ns = int((busy[:, 1] - busy[:, 0]).sum()) if len(busy) else 0
    by_name: Dict[str, int] = {}
    for n, s, e in inside:
        by_name[n] = by_name.get(n, 0) + (e - s)
    device_ops = [[n, t * 1e-9] for n, t in sorted(by_name.items(), key=lambda x: -x[1])[:10]]
    # idle gaps: the window less the union of device activity
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    order = np.argsort(-(gaps[:, 1] - gaps[:, 0]))[:10]
    hs = np.asarray([s for _, s, _ in host], dtype=np.int64)
    he = np.asarray([e for _, _, e in host], dtype=np.int64)
    names = [n for n, _, _ in host]
    idle = []
    for g in order:
        s, e = gaps[g]
        mid = (s + e) // 2
        cover = np.nonzero((hs <= mid) & (he >= mid))[0]
        cover = [i for i in cover if names[i] != WINDOW_MARK]
        marks = [i for i in cover if names[i].startswith(ANNOTATIONS)]
        inner = min(cover, key=lambda i: he[i] - hs[i]) if cover else None
        what = names[min(marks, key=lambda i: he[i] - hs[i])] if marks else "host"
        if inner is not None and names[inner] != what:
            what = f"{what}/{names[inner]}"
        idle.append([what, (e - s) * 1e-9])
    return TraceSummary(kernels=kernels, busy_s=busy_ns * 1e-9, window_s=(w1 - w0) * 1e-9,
                        steps=steps, device_ops=device_ops, idle_gaps=idle)
