"""What the traffic generators share: the outcome a generator hands the
harness, the pacing of a window, and the freeing of the program's state
before the reference runs."""

from __future__ import annotations

import collections
import dataclasses
import gc
import time
from typing import Dict, List, Optional

import torch


@dataclasses.dataclass
class Outcome:
    e2e: Dict[str, float]                  # end-to-end metrics by name
    setup_s: float
    attempted: int
    failed: int
    numbers: Dict[str, float]              # the compared numbers
    work: dict                             # what the window completed
    counters: dict = dataclasses.field(default_factory=dict)
    memory_peak_bytes: int = 0
    notes: dict = dataclasses.field(default_factory=dict)


def is_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def sync(device):
    if is_cuda(device):
        torch.cuda.synchronize(device)


class Pacer:
    """Keeps at most `depth` launched calls unfinished on the device, so
    the host enqueues the next call while the device runs the last one,
    and no call is enqueued far past the window's end."""

    def __init__(self, device, depth: int = 2):
        self.cuda = is_cuda(device)
        self.depth = depth
        self.queue: collections.deque = collections.deque()

    def launched(self):
        if not self.cuda:
            return
        ev = torch.cuda.Event()
        ev.record()
        self.queue.append(ev)
        while len(self.queue) >= self.depth:
            self.queue.popleft().synchronize()


def peak_bytes(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if is_cuda(device) \
        else 0


def free(device):
    gc.collect()
    if is_cuda(device):
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def now() -> float:
    return time.perf_counter()


def sample(rng, population: List, k: int, always: Optional[List] = None
           ) -> List:
    """k members of population drawn by rng, plus `always`, in order."""
    picked = set(always or [])
    rest = [x for x in population if x not in picked]
    k = max(0, min(k, len(rest)))
    idx = rng.choice(len(rest), size=k, replace=False) if k else []
    return sorted(picked | {rest[i] for i in idx})
