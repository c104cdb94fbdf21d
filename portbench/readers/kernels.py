"""Readers of the device trace: a kernel group's share of its roofline,
the eager kernels' share of device time, and the device's idle share.

A reader takes (ctx, outcome, trace summary, metric) and returns the
metric's value, or None where the trace holds nothing to read (no kernel
matched, no device activity): the harness then leaves the metric out.
"""

from __future__ import annotations

import re
from typing import Optional

from ..yardstick import groups, peaks, work


def _matched_s(summary, pattern: str) -> float:
    rx = re.compile(pattern)
    return sum(sec for name, sec in summary.kernel_s.items()
               if rx.search(name))


def roofline(ctx, out, summary, metric) -> Optional[float]:
    """100 x the least time of the work (`yardstick/work.py`'s function
    `args.work`) over the device time of the kernels `args.pattern`
    matches."""
    if summary is None:
        return None
    t = _matched_s(summary, metric["args"]["pattern"])
    if t <= 0.0:
        return None
    items = getattr(work, metric["args"]["work"])(ctx.shape, out.work)
    flops = peaks.peak_flops(ctx.device_name, ctx.shape.dtype)
    bw = peaks.peak_bytes_per_s(ctx.device_name)
    bound = sum(max(ops / flops, byts / bw) * count
                for ops, byts, count in items)
    return 100.0 * bound / t


def eager_share(ctx, out, summary, metric) -> Optional[float]:
    """100 x the device time of kernels that are neither cuBLAS nor the
    port's own, over all device time."""
    if summary is None:
        return None
    total = sum(summary.kernel_s.values())
    if total <= 0.0:
        return None
    rest = sum(sec for name, sec in summary.kernel_s.items()
               if not re.search(groups.OWN, name)
               and not re.search(groups.CUBLAS, name))
    return 100.0 * rest / total


def idle_share(ctx, out, summary, metric) -> Optional[float]:
    """100 x (1 - the union of device activity over the traced window)."""
    if summary is None or summary.busy_s <= 0.0 or summary.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - summary.busy_s / summary.window_s)
