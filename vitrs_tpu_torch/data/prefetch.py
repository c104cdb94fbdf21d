"""Double-buffered host -> device prefetch: the port of
`vitrs_tpu/data/prefetch.py`.

A background thread runs the loader (the native augment or JPEG pipeline)
and moves each batch to the device ahead of the step, so the host's
augment and the copy overlap the step on the card.  Queue depth 2 is
classic double buffering; an exception in the thread surfaces on the
`__next__` after the batches made before it, and `close()` stops and joins
the thread.

On a CUDA device, in PyTorch's idiom:
  * the thread copies each batch into a pinned host buffer and issues the
    non-blocking H2D copies on a side stream, then records an event;
  * the consumer makes its current stream wait on that event and calls
    `record_stream` on the tensors it takes, so the caching allocator does
    not hand their memory to another tensor before the step that reads
    them has run;
  * a pinned buffer is refilled only after the event of the copy that read
    it has completed.
On the CPU the thread hands the batch over with no copy (`torch.from_numpy`).

Each batch comes with the host seconds the loader took to produce it
(`last_load_s` after `__next__`: the training loop's `loader_ms`).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, List, Optional

import numpy as np
import torch


class DevicePrefetcher:
    def __init__(self, loader, device, depth: int = 2):
        self.loader = loader
        self.device = torch.device(device)
        self.depth = depth
        self.last_load_s = 0.0
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        # depth batches wait in the queue and one is being filled: a pinned
        # buffer per slot beyond them, each with the event of its last copy
        self._pinned: List[Optional[List[torch.Tensor]]] = [None] * (depth + 2)
        self._events: List[Optional[torch.cuda.Event]] = [None] * (depth + 2)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _to_device(self, slot: int, arrays) -> tuple:
        """Copy `arrays` into slot's pinned buffers and issue their H2D
        copies on the side stream: (device tensors, the copies' event)."""
        event = self._events[slot]
        if event is not None:
            event.synchronize()          # the last copy from this slot is done
        src = [torch.from_numpy(a) for a in arrays]
        host = self._pinned[slot]
        if host is None or any(h.shape != t.shape or h.dtype != t.dtype
                               for h, t in zip(host, src)):
            host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    for t in src]
            self._pinned[slot] = host
        for h, t in zip(host, src):
            h.copy_(t)
        with torch.cuda.stream(self._stream):
            dev = tuple(h.to(self.device, non_blocking=True) for h in host)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._events[slot] = event
        return dev, event

    def _run(self):
        slot = 0
        try:
            while not self._stop.is_set():
                t0 = time.perf_counter()
                arrays = [np.ascontiguousarray(a)
                          for a in self.loader.next_batch()]
                load_s = time.perf_counter() - t0
                if self._stream is not None:
                    batch, event = self._to_device(slot, arrays)
                    slot = (slot + 1) % len(self._pinned)
                else:
                    batch, event = tuple(map(torch.from_numpy, arrays)), None
                while not self._stop.is_set():
                    try:
                        self._q.put((batch, event, load_s), timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surfaced on the next __next__
            self._exc = e

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        while True:
            try:
                batch, event, self.last_load_s = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                # the batches made before a loader's error come first
                if self._exc is not None:
                    raise self._exc
                if not self._thread.is_alive():
                    raise StopIteration
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for t in batch:
                t.record_stream(current)
        return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10)
