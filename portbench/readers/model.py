"""Readers of the window's work: the model FLOPs utilisation, and the
program's own counters."""

from __future__ import annotations

from typing import Optional

from ..yardstick import peaks, work


def mfu(ctx, out, summary, metric) -> Optional[float]:
    """100 x the model FLOPs of what the traced window completed
    (`yardstick/work.model_flops`, flops.py's conventions) over the
    window's length times the chip's peak."""
    if summary is None or summary.window_s <= 0.0 or summary.busy_s <= 0.0:
        return None
    achieved = work.model_flops(ctx.shape, out.work) / summary.window_s
    return 100.0 * achieved / peaks.peak_flops(ctx.device_name,
                                               ctx.shape.dtype)


def ratio(ctx, out, summary, metric) -> Optional[float]:
    """counters[args.num] / counters[args.den] (None where either is
    missing or the denominator is 0)."""
    num = out.counters.get(metric["args"]["num"])
    den = out.counters.get(metric["args"]["den"])
    if num is None or not den:
        return None
    return num / den
