"""Spans and the device trace of a `--trace 1` run.

`Tracer(on)` wraps the measured window: off, its spans cost nothing; on,
the window runs under `torch.profiler` (CPU and CUDA activity) and each
span is a `record_function` range, so the host's spans and the device's
kernels share one clock.  The spans are the harness's own, around its
calls into each layer of the program: `window`, `make_batch`, `step`,
`submit`, `engine.step`, `sample_due`.

`summary()` reduces the trace to what the readers take: device time by
kernel name, the union of device activity in the window (`busy_s`), the
window's length (`window_s`), the device time by group
(`yardstick/groups.py`) and the idle time by the innermost span the host
was in when each gap began.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from .yardstick import groups

SPANS = ("window", "make_batch", "step", "submit", "engine.step",
         "sample_due")


@dataclasses.dataclass
class TraceSummary:
    kernel_s: Dict[str, float]          # device seconds by kernel name
    busy_s: float
    window_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    events: int


class Tracer:
    def __init__(self, on: bool, cuda: bool):
        self.on = on
        self.cuda = cuda
        self._prof = None

    @contextlib.contextmanager
    def window(self):
        if not self.on:
            yield
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if self.cuda else [])
        self._prof = profile(activities=acts)
        self._sync()
        self._prof.__enter__()
        try:
            with torch.profiler.record_function("window"):
                yield
                self._sync()
        finally:
            self._prof.__exit__(None, None, None)

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def summary(self) -> Optional[TraceSummary]:
        if self._prof is None:
            return None
        from torch.autograd import DeviceType
        kernels: List[Tuple[float, float, str]] = []
        spans: List[Tuple[float, float, str]] = []
        window = None
        # the profiler's raw events: building its event tree
        # (`prof.events()`) takes minutes over a serving window's millions
        for e in self._prof.profiler.kineto_results.events():
            name = e.name()
            t0 = e.start_ns() / 1e9
            t1 = t0 + e.duration_ns() / 1e9
            on_device = e.device_type() == DeviceType.CUDA
            if name in SPANS:
                # a span's range is also drawn on the device's row: not work
                if on_device:
                    continue
                if name == "window":
                    window = (t0, t1)
                else:
                    spans.append((t0, t1, name))
            elif on_device and not e.is_user_annotation():
                kernels.append((t0, t1, name))
        if window is None:
            return None
        w0, w1 = window
        by_name: Dict[str, float] = collections.Counter()
        by_group: Dict[str, float] = collections.Counter()
        for t0, t1, name in kernels:
            by_name[name] += t1 - t0
            by_group[groups.group(name)] += t1 - t0
        busy, gaps = _union_and_gaps(kernels, w0, w1)
        idle: Dict[str, float] = collections.Counter()
        spans.sort()
        starts = [s[0] for s in spans]
        for g0, g1 in gaps:
            idle[_innermost(spans, starts, g0)] += g1 - g0
        return TraceSummary(
            kernel_s=dict(by_name), busy_s=busy, window_s=w1 - w0,
            device_ops=sorted(by_group.items(), key=lambda kv: -kv[1])[:10],
            idle_gaps=sorted(idle.items(), key=lambda kv: -kv[1])[:10],
            events=len(kernels))


def _union_and_gaps(intervals, w0: float, w1: float):
    """(seconds of the union of the intervals inside [w0, w1], the gaps
    between them inside it)."""
    busy, gaps = 0.0, []
    cur = w0
    for t0, t1, _ in sorted(intervals):
        t0, t1 = max(t0, w0), min(t1, w1)
        if t1 <= cur:
            continue
        if t0 > cur:
            gaps.append((cur, t0))
            cur = t0
        busy += t1 - cur
        cur = t1
    if cur < w1:
        gaps.append((cur, w1))
    return busy, gaps


def _innermost(spans, starts, t: float) -> str:
    """The name of the latest-starting span (of the last few that start by
    t: the harness's spans do not nest deeply) that covers t, else
    "host"."""
    i = bisect.bisect_right(starts, t)
    for s0, s1, n in reversed(spans[max(0, i - 4):i]):
        if s1 >= t:
            return n
    return "host"
