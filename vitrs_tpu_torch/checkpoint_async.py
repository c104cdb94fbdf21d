"""Async and range-sharded checkpoint writes: the port of
`vitrs_tpu/checkpoint_async.py`.

* **AsyncCheckpointer**: `save()` snapshots the parameters and the flat
  AdamW m and v with device-side copies on the current stream and returns
  (`save_tree()` does the same for a side tree, the EMA's);
  a writer thread copies the snapshot to pinned host memory on a side
  stream and writes the file with `checkpoint.save_checkpoint`, so the
  bytes are those of a synchronous save.  The device copy is what makes
  this safe: the fused AdamW (K7) updates the masters, m and v in place,
  and the copy, queued on the stream before the next step's K7, holds the
  values of save()-call time however far training has gone on.  At most
  `max_inflight` saves are pending (save() blocks while the previous write
  has not finished: bounded memory); `wait()` drains; a writer's error
  surfaces on the next save() or wait(); `close()` drains and stops the
  thread.  On the CPU the snapshot is a plain clone.

* **save_checkpoint_sharded**: each of num_hosts writers writes its
  contiguous byte range of the payload into one pre-sized file through the
  native ckptio pwrite path (`vitrs_alloc_file` + `vitrs_write_range`,
  native/ckptio.cpp), host 0 also the header and the cursor.  The file is
  identical to a single `checkpoint.save_checkpoint` and loads with
  `checkpoint.load_checkpoint`.  Without the native library the ranges go
  through plain file writes, as in the JAX package.  Under a
  torch.distributed process group the writers meet at two barriers, as the
  JAX function's hosts do: none writes its range before host 0 has sized
  the file, and none returns before every range is written.  With one
  process the calls run in order, host 0 first, and the barriers are none.
"""

from __future__ import annotations

import ctypes
import os
import queue
import threading
from typing import Dict, Optional

import numpy as np
import torch

from . import checkpoint as ckpt_io
from . import params as PRM
from .config import ViTConfig


def _snapshot(params, cfg: ViTConfig, m, v, n_valid) -> dict:
    """Device-side copies, queued on the current stream: the flat
    parameter vector (one copy when params are views into it, else one a
    tensor), m, v."""
    flat = PRM.flat_base(params, cfg)
    if flat is not None:
        snap = {"flat": flat.detach().clone()}
    else:
        snap = {("params", k): t.detach().clone() for k, t in params.items()}
    if m is not None:
        n = n_valid if n_valid is not None else m.shape[0]
        snap["m"], snap["v"] = m[:n].detach().clone(), v[:n].detach().clone()
    return snap


class AsyncCheckpointer:
    def __init__(self, max_inflight: int = 1):
        self._q: queue.Queue = queue.Queue(maxsize=max_inflight)
        self._exc: Optional[BaseException] = None
        self._pinned: Dict = {}     # host buffers, reused from save to save
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            try:
                snap, event, write = item
                write(self._host(snap, event))
            except BaseException as e:      # surfaced on next save()/wait()
                self._exc = e
            finally:
                item = snap = None
                self._q.task_done()

    def _host(self, snap: dict, event) -> dict:
        """The snapshot as numpy arrays: on CUDA through pinned buffers,
        copied on a side stream that first waits for the snapshot's copies
        (`event`)."""
        if event is None:
            return {k: t.numpy() for k, t in snap.items()}
        stream = torch.cuda.Stream(next(iter(snap.values())).device)
        stream.wait_event(event)
        host = {}
        with torch.cuda.stream(stream):
            for k, t in snap.items():
                key = (k, tuple(t.shape), t.dtype)
                if key not in self._pinned:
                    self._pinned[key] = torch.empty(t.shape, dtype=t.dtype,
                                                    pin_memory=True)
                host[k] = self._pinned[key].copy_(t, non_blocking=True)
        stream.synchronize()
        return {k: t.numpy() for k, t in host.items()}

    def _raise_pending(self):
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def _enqueue(self, snap: dict, write):
        """Queue write(the snapshot as numpy arrays) for the thread, after
        the snapshot's copies on the current stream."""
        device = next(iter(snap.values())).device
        event = None
        if device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
        # blocks only while the previous saves have not drained
        self._q.put((snap, event, write))

    def save(self, path: str, params: Dict[str, torch.Tensor],
             cfg: ViTConfig, m=None, v=None, step: int = 0, seed: int = 0,
             cursor: int = 0, n_valid: Optional[int] = None):
        """Snapshot and schedule a write of `checkpoint.save_checkpoint`'s
        file; returns once the device-side copies are queued on the current
        stream (no wait for the device).  params: tensors (views into the
        flat vector, or any dict); m, v: the flat AdamW state, trimmed to
        n_valid values."""
        self._raise_pending()

        def write(host):
            if "flat" in host:
                params_h = PRM.unflatten_params(
                    torch.from_numpy(host["flat"]), cfg)
            else:
                params_h = {k[1]: a for k, a in host.items()
                            if isinstance(k, tuple)}
            ckpt_io.save_checkpoint(path, params_h, cfg, m=host.get("m"),
                                    v=host.get("v"), step=step, seed=seed,
                                    cursor=cursor)

        self._enqueue(_snapshot(params, cfg, m, v, n_valid), write)

    def save_tree(self, path: str, tensors: Dict[str, torch.Tensor],
                  meta: Optional[dict] = None):
        """Snapshot `tensors` and schedule `checkpoint_tree.save_tree` of
        them (the EMA's side tree), as `save` does."""
        from . import checkpoint_tree as CT
        self._raise_pending()
        self._enqueue({k: t.detach().clone() for k, t in tensors.items()},
                      lambda host: CT.save_tree(path, host, meta))

    def wait(self):
        self._q.join()
        self._raise_pending()

    def close(self):
        try:
            self.wait()
        finally:
            self._q.put(None)
            self._thread.join(timeout=30)


# ---------------------------------------------------------------------------
# range-sharded writes
# ---------------------------------------------------------------------------

def _barrier() -> None:
    """Every rank waits here when a process group is up; a no-op in one
    process (`torch.distributed.barrier`: the writes to the shared file need
    order, its allocation before every range, every range before any
    reader)."""
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _native():
    from .native import build
    lib = build.load("ckptio")
    if lib is None:
        return None
    try:
        if lib.vitrs_ckptio_abi() != 1:
            return None
    except Exception:
        return None
    return lib


def _write_range(path: str, offset: int, data: np.ndarray):
    data = np.ascontiguousarray(data)
    raw = data.view(np.uint8).reshape(-1)
    lib = _native()
    if lib is not None:
        rc = lib.vitrs_write_range(
            path.encode(), ctypes.c_int64(offset),
            ctypes.c_int64(raw.nbytes),
            raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int(min(os.cpu_count() or 1, 8)))
        if rc == 0:
            return
    with open(path, "r+b") as f:
        f.seek(offset)
        f.write(raw.tobytes())


def _alloc(path: str, size: int):
    lib = _native()
    if lib is not None and lib.vitrs_alloc_file(path.encode(),
                                                ctypes.c_int64(size)) == 0:
        return
    with open(path, "wb") as f:
        f.truncate(size)


def _f32_flat(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32).reshape(-1)


def save_checkpoint_sharded(path: str, cfg: ViTConfig, host_id: int,
                            num_hosts: int,
                            params: Optional[Dict] = None,
                            m=None, v=None,
                            step: int = 0, seed: int = 0, cursor: int = 0):
    """Host `host_id` of `num_hosts` writes its 1/num_hosts range of the
    payload into one file.  params: the full dict (tensors or arrays) on
    every host, each host serialising only its range; m, v: the full flat
    (n,) vectors.  The layout and version rule are
    `checkpoint.save_checkpoint`'s, so any host can load the file."""
    assert 0 <= host_id < num_hosts
    n = PRM.num_parameters(cfg)
    has_opt = m is not None and v is not None
    version = 2 if (cfg.mode == "vit" or has_opt or step or seed
                    or cfg.num_kv_heads or cfg.pos_emb == "rope"
                    or cfg.window or cfg.num_experts) else 1
    payload = n * 4 * (3 if has_opt else 1)
    total = ckpt_io.HEADER_BYTES + payload + (8 if has_opt else 0)
    if host_id == 0:
        _alloc(path, total)
        _write_range(path, 0, ckpt_io._header(cfg, version, step, has_opt,
                                              seed))
        if has_opt:
            _write_range(path, ckpt_io.HEADER_BYTES + n * 12,
                         np.int64([cursor]))
    _barrier()      # nobody writes a range before host 0 sized the file

    # the host's contiguous f32 range of [params | m | v]
    total_f32 = n * (3 if has_opt else 1)
    per = (total_f32 + num_hosts - 1) // num_hosts
    lo, hi = host_id * per, min(host_id * per + per, total_f32)
    if lo >= hi:
        _barrier()  # the one exit: meet the writers' barrier
        return
    out = np.empty(hi - lo, np.float32)

    def emit(start: int, size: int, flat_of):
        a, b = max(lo, start), min(hi, start + size)
        if a < b:
            out[a - lo:b - lo] = flat_of()[a - start:b - start]

    shapes = PRM.param_shapes(cfg)
    pos = 0
    for name in PRM.tensor_order(cfg):
        size = int(np.prod(shapes[name]))
        emit(pos, size, lambda: _f32_flat(params[name]))
        pos += size
    if has_opt:
        emit(n, n, lambda: _f32_flat(m)[:n])
        emit(2 * n, n, lambda: _f32_flat(v)[:n])
    _write_range(path, ckpt_io.HEADER_BYTES + lo * 4, out)
    _barrier()      # returning means the file is whole, for every rank
