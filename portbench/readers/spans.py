"""Readers of the program's own spans (`vitrs_tpu_torch/utils/trace.py`):
device time and idle time put down to the program span that launched or
waited, host syncs per unit of work, and the engine's records.

The profiler's events are read once a run (`_view`, cached on the
profiler object) and shared by every metric here.  A program span is a
host range whose name starts with one of the program's layer prefixes
(`PROGRAM`); the harness's spans (`tracing.SPANS`) are not among them.
A kernel is put down to every program span open on the thread that
launched it, at the launch: the CUDA runtime call with the kernel's
correlation id gives both (else the CPU op the kernel is linked to), so
a GELU kernel of a decode tick counts for `op.gelu` and for `gen.decode`.
A device gap is put down to the main thread's innermost program span
where it begins; the main thread is the one that holds the harness's
`window`.

Where the trace holds no program span of the asked names, or the program
keeps no records (a program without spans) or dropped some inside the
window, or the run drove no device (the CPU runs of the tests), a reader
returns None and the harness leaves the metric out.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import functools
import math
import re
from typing import Dict, List, Optional, Tuple

from ..tracing import SPANS, _union_and_gaps

PROGRAM = re.compile(r"^(gen|train|model|data|op)\.")
RUNTIME = re.compile(r"^cu(da)?[A-Z]")
# host calls that block until the device has done queued work
SYNCS = frozenset(("cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy"))


Stack = Tuple[str, ...]


class _Timeline:
    """The program spans open on one thread over time, outermost first,
    from its spans' (start, end, name), which nest."""

    def __init__(self, spans: List[Tuple[int, int, str]]):
        self.times: List[int] = []
        self.stacks: List[Stack] = []
        stack: List[Tuple[int, int, str]] = []
        for s0, s1, name in sorted(spans, key=lambda s: (s[0], -s[1])):
            while stack and stack[-1][1] <= s0:
                end = stack.pop()[1]
                self._mark(end, stack)
            stack.append((s0, s1, name))
            self._mark(s0, stack)
        while stack:
            end = stack.pop()[1]
            self._mark(end, stack)

    def _mark(self, t: int, stack: List[Tuple[int, int, str]]):
        self.times.append(t)
        self.stacks.append(tuple(s[2] for s in stack))

    def at(self, t: int) -> Stack:
        i = bisect.bisect_right(self.times, t) - 1
        return self.stacks[i] if i >= 0 else ()


@dataclasses.dataclass
class _View:
    window_ns: Tuple[int, int]
    span_count: Dict[str, int]
    kernel_in: Dict[Stack, float]             # device s by launching stack
    kernel_s: float
    idle_in: Dict[Optional[str], float]       # idle s by main-thread span
    syncs_in: Dict[Optional[str], int]        # syncs by the caller's span
    cuda: bool


@functools.lru_cache(maxsize=1)
def _view(prof) -> Optional[_View]:
    from torch.autograd import DeviceType
    spans: Dict[int, List[Tuple[int, int, str]]] = collections.defaultdict(
        list)
    ops: Dict[int, Tuple[int, int]] = {}        # correlation -> (tid, t)
    runtime: Dict[int, Tuple[int, int]] = {}    # correlation -> (tid, t)
    syncs: List[Tuple[int, int]] = []
    kernels = []
    window = None
    main = None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation() and name not in SPANS:
                kernels.append((e.start_ns(), e.duration_ns(),
                                e.correlation_id(),
                                e.linked_correlation_id()))
            continue
        t0, tid = e.start_ns(), e.start_thread_id()
        if RUNTIME.match(name):
            runtime[e.correlation_id()] = (tid, t0)
            if name in SYNCS:
                syncs.append((tid, t0))
            continue
        ops[e.correlation_id()] = (tid, t0)
        if PROGRAM.match(name):
            spans[tid].append((t0, t0 + e.duration_ns(), name))
        elif name == "window" and e.is_user_annotation():
            window, main = (t0, t0 + e.duration_ns()), tid
    if window is None:
        return None
    lines = {tid: _Timeline(s) for tid, s in spans.items()}

    def open_at(tid: int, t: int) -> Stack:
        line = lines.get(tid)
        return line.at(t) if line is not None else ()

    kernel_in: Dict[Stack, float] = collections.Counter()
    intervals = []
    for t0, dur, corr, linked in kernels:
        launch = runtime.get(corr) or ops.get(linked)
        kernel_in[open_at(*launch) if launch else ()] += dur / 1e9
        intervals.append((t0, t0 + dur, None))
    w0, w1 = window
    idle_in: Dict[Optional[str], float] = collections.Counter()
    for g0, g1 in _union_and_gaps(intervals, w0, w1)[1]:
        idle_in[(open_at(main, g0) or (None,))[-1]] += (g1 - g0) / 1e9
    syncs_in: Dict[Optional[str], int] = collections.Counter(
        (open_at(tid, t) or (None,))[-1] for tid, t in syncs
        if w0 <= t <= w1)
    count = collections.Counter(n for s in spans.values() for s0, _, n in s
                                if w0 <= s0 <= w1)
    return _View(window, dict(count), dict(kernel_in),
                 sum(kernel_in.values()), dict(idle_in), dict(syncs_in),
                 bool(kernels or runtime))


def _of(ctx) -> Optional[_View]:
    prof = getattr(ctx.tracer, "_prof", None)
    return _view(prof) if prof is not None else None


def _records(view: _View, name: str) -> Optional[List[tuple]]:
    """The program's in-memory records named `name` inside the traced
    window; None where the program keeps no records or dropped some of
    the window's."""
    try:
        from vitrs_tpu_torch.utils import trace
    except ImportError:
        return None
    recs = trace.records(*view.window_ns)
    return None if recs is None else [r for r in recs if r[3] == name]


def device_share_in(ctx, out, summary, metric) -> Optional[float]:
    """100 x the device time of kernels launched while one of `args.spans`
    is open on the launching thread, over all device time."""
    view = _of(ctx)
    names = set(metric["args"]["spans"])
    if view is None or view.kernel_s <= 0.0 \
            or not any(view.span_count.get(n) for n in names):
        return None
    return 100.0 * sum(s for stack, s in view.kernel_in.items()
                       if names.intersection(stack)) / view.kernel_s


def idle_in(ctx, out, summary, metric) -> Optional[float]:
    """100 x the idle time of the device gaps that begin while the main
    thread's innermost program span is one of `args.spans`, over the
    window."""
    view = _of(ctx)
    names = metric["args"]["spans"]
    if view is None or view.kernel_s <= 0.0 \
            or not any(view.span_count.get(n) for n in names):
        return None
    w0, w1 = view.window_ns
    return 100.0 * sum(view.idle_in.get(n, 0.0)
                       for n in names) / ((w1 - w0) / 1e9)


def syncs_per(ctx, out, summary, metric) -> Optional[float]:
    """Host calls that block on the device (`SYNCS`) made inside any
    program span, over the count of `args.per` spans."""
    view = _of(ctx)
    per = view.span_count.get(metric["args"]["per"]) if view else None
    if not per or not view.cuda:
        return None
    return sum(n for name, n in view.syncs_in.items()
               if name is not None) / per


def pad_share(ctx, out, summary, metric) -> Optional[float]:
    """100 x (1 - the prompt tokens over the tokens computed) of the
    window's prefill passes (`gen.prefill` records)."""
    view = _of(ctx)
    recs = _records(view, "gen.prefill") if view and view.cuda else None
    computed = sum(r[4]["computed_tokens"] for r in recs or ())
    if not computed:
        return None
    return 100.0 * (1.0 - sum(r[4]["real_tokens"] for r in recs) / computed)


def request_p95_ms(ctx, out, summary, metric) -> Optional[float]:
    """The nearest-rank p95 over the requests submitted and given their
    first token inside the window of the time from `gen.submit` to the end
    of the `gen.sample` that returned that token, joined by request id."""
    view = _of(ctx)
    if view is None or not view.cuda:
        return None
    subs, samples = _records(view, "gen.submit"), _records(view, "gen.sample")
    if subs is None or samples is None:
        return None
    submitted = {r[4]["rid"]: r[0] for r in subs}
    times = sorted((r[1] - submitted[rid]) / 1e6 for r in samples
                   for rid in r[4]["first"] if rid in submitted)
    if not times:
        return None
    return times[max(0, math.ceil(0.95 * len(times)) - 1)]
