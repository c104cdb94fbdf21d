"""The program's spans, on the device trace's clock.

`span(name, **attrs)` marks a stretch of the program's work.  While no
`torch.profiler` session records, it returns one shared null context: the
cost is a read of the profiler's flag and the call.  While a session
records (the training loop's `--profile-at` trace, `utils/profiling`'s
`op_breakdown`, the benchmark's `--trace 1` window), it opens a
RecordFunction range (`torch._C._profiler._RecordFunctionFast`: the range
`torch.profiler.record_function` opens, without its TorchScript op call,
about 2 us a span against 12 on the CPU), so the span lies in the kineto
trace beside the kernels it launched and in any exported Chrome trace.
The profiler drops a range's arguments, so a span given `attrs` also
appends (t0_ns, t1_ns, thread id, name, attrs) to a bounded in-memory
record, stamped with `time.time_ns()`: kineto stamps its events with the
same unix-epoch clock.  `event(name, **attrs)` records an instant the
same way, and `records(t0_ns, t1_ns)` returns the records that lie inside
a window, or None where the bounded record has dropped some of them.
`recording()` says whether a profiler records, for a caller to build a
span's attributes only then.

Span names are prefixed by their layer: `gen.` the generation engine,
`train.` the data-parallel training step, `model.` and `data.` the
forward's entry and the image normalisation, `op.` the eager ops.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Dict, List, Optional, Tuple

from torch._C._profiler import _RecordFunctionFast
# `_profiler._is_profiler_enabled`: set by torch.profiler.profile on entry,
# cleared on exit; read at each call, as it is rebound
from torch.autograd import profiler as _profiler

Record = Tuple[int, int, int, str, Dict]

_NULL = contextlib.nullcontext()
# a serving window of 30 s at 300 requests/s leaves about 12k records
_RECORDS: "collections.deque[Record]" = collections.deque(maxlen=1 << 17)
# the end of the last record the bounded deque dropped
_dropped_t1 = -1


def recording() -> bool:
    """Whether a torch.profiler session records, so spans are on."""
    return _profiler._is_profiler_enabled


def _keep(rec: Record):
    global _dropped_t1
    if len(_RECORDS) == _RECORDS.maxlen:
        _dropped_t1 = _RECORDS[0][1]
    _RECORDS.append(rec)


class _Recorded:
    """A profiler range that also keeps its attributes."""

    __slots__ = ("name", "attrs", "t0", "range")

    def __init__(self, name: str, attrs: Dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self.t0 = time.time_ns()
        self.range = _RecordFunctionFast(self.name)
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        _keep((self.t0, time.time_ns(), threading.get_ident(), self.name,
               self.attrs))
        return False


def span(name: str, **attrs):
    """A context marking `name` in the profiler's trace while one records,
    with `attrs` kept in the in-memory record; else a shared null
    context."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    if attrs:
        return _Recorded(name, attrs)
    return _RecordFunctionFast(name)


def event(name: str, **attrs):
    """Record an instant `name` with `attrs` while a profiler records."""
    if _profiler._is_profiler_enabled:
        t = time.time_ns()
        _keep((t, t, threading.get_ident(), name, attrs))


def records(t0_ns: int, t1_ns: int) -> Optional[List[Record]]:
    """The records (t0_ns, t1_ns, thread id, name, attrs) that start and
    end inside [t0_ns, t1_ns], in the order they ended; None where the
    bounded record dropped one that ended inside the window."""
    if _dropped_t1 >= t0_ns:
        return None
    return [r for r in list(_RECORDS) if r[0] >= t0_ns and r[1] <= t1_ns]
