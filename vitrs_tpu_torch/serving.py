"""Serving and export: the port of `vitrs_tpu/serving.py` on `torch.export`.

`export_forward` traces the inference forward (`vit_forward(train=False)`
or `gpt_forward`) at one batch geometry with the weights inside, and writes
one artifact that a serving process loads and calls with no model code:
`ServedModel` imports only the kernels' op registrations (`vitrs::*`,
ops/_build.kernel_op), which the graph calls by name.  On the card the
graph's attention nodes are the K1-fwd op (K3-fwd with kv heads), so an
exported GPT-2 124M call launches K1-fwd once a layer, as the eager forward
does.

Artifact: the magic `VITRSPT1` (the JAX package's `VITRSRV1` artifacts are
refused with ValueError before anything is parsed), two little-endian
uint32 lengths, the JSON meta, then the bytes of `torch.export.save`.
Nothing is unpickled as an arbitrary object: every tensor file inside the
export's zip is read with `torch.load(weights_only=True)` before
`torch.export.load` sees it, and a file that needs more is refused (the
export loader itself would fall back to a full unpickle).

`BatchingServer` is the JAX class as it is: host threads coalesce single
requests into fixed-size batches, pad to the compiled batch, and set each
future from its row, or every future of the batch to the batch's error.
"""

from __future__ import annotations

import io
import json
import os
import queue
import struct
import threading
import time
import zipfile
from concurrent.futures import Future
from typing import Dict

import numpy as np
import torch

from .config import ViTConfig
# the kernels' ops, which an exported graph calls by name
from .ops import (basic, flash_attention,  # noqa: F401
                  flash_attention_gqa, flash_prefill, fused_ce)

_MAGIC = b"VITRSPT1"


class _Forward(torch.nn.Module):
    """The inference forward over prepared weights held as buffers."""

    def __init__(self, prepared: Dict[str, torch.Tensor], cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        self.names = sorted(prepared)
        for i, k in enumerate(self.names):
            self.register_buffer(f"w{i}", prepared[k])

    def forward(self, x):
        from .models import model as M
        params = {k: getattr(self, f"w{i}") for i, k in enumerate(self.names)}
        if self.cfg.mode == "vit":
            return M.vit_forward(params, x, self.cfg, train=False)
        return M.gpt_forward(params, x, self.cfg)


def export_forward(params: Dict, cfg: ViTConfig, batch_size: int,
                   path: str) -> dict:
    """Export the logits forward of `params` (a canonical tensor dict, on
    the device to serve from) for a fixed batch: (B, img, img, C) fp32
    images in vit mode, (B, max_seq_len) int32 tokens in gpt mode.  The
    weights are prepared once (`model.prepare_params`: matmul weights in
    cfg.dtype) and stored in the artifact.  Returns the meta it wrote."""
    from .models import model as M
    device = params["wte"].device
    prepared = M.prepare_params(params, cfg)
    if cfg.mode == "vit":
        example = torch.zeros((batch_size, cfg.img_size, cfg.img_size,
                               cfg.in_chans), dtype=torch.float32,
                              device=device)
    else:
        example = torch.zeros((batch_size, cfg.max_seq_len),
                              dtype=torch.int32, device=device)
    with torch.no_grad():
        ep = torch.export.export(_Forward(prepared, cfg), (example,))
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    blob = buf.getvalue()
    meta = {"mode": cfg.mode, "batch_size": batch_size,
            "input_shape": list(example.shape),
            "input_dtype": str(example.dtype).removeprefix("torch."),
            "device": str(device)}
    mjson = json.dumps(meta).encode()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<II", len(mjson), len(blob)))
        f.write(mjson)
        f.write(blob)
    os.replace(tmp, path)
    return meta


def _check_tensor_files(blob: bytes, path: str):
    """Read every tensor file of the export's zip as weights only; raise
    ValueError on one that needs an arbitrary unpickle."""
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        for name in z.namelist():
            if name.endswith(".pt"):
                try:
                    torch.load(io.BytesIO(z.read(name)), map_location="cpu",
                               weights_only=True)
                except Exception as e:
                    raise ValueError(f"{path}: {name} is not plain tensor "
                                     f"data ({type(e).__name__})") from e


class ServedModel:
    """A loaded artifact: call it with a batch of the exported shape and get
    the logits.  No model code, config or parameters are needed."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            if f.read(len(_MAGIC)) != _MAGIC:
                raise ValueError(f"not a vitrs_tpu_torch serving artifact: "
                                 f"{path}")
            mlen, blen = struct.unpack("<II", f.read(8))
            self.meta = json.loads(f.read(mlen).decode())
            blob = f.read(blen)
        if len(blob) != blen:
            raise ValueError(f"truncated serving artifact: {path}")
        _check_tensor_files(blob, path)
        self.device = torch.device(self.meta["device"])
        # the weights on the device the forward was exported on
        self._module = torch.export.load(io.BytesIO(blob)).module().to(
            self.device)
        self._dtype = getattr(torch, self.meta["input_dtype"])

    def __call__(self, x) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                            else x).to(self.device, self._dtype)
        assert tuple(x.shape) == tuple(self.meta["input_shape"]), (
            f"expected {self.meta['input_shape']}, got {tuple(x.shape)}")
        with torch.no_grad():
            return self._module(x)


class BatchingServer:
    """Micro-batching inference loop: concurrent single-example requests
    are coalesced into fixed-size batches (padded to `batch_size`, the one
    compiled shape) and each result is scattered back to its future.
    `max_wait_ms` bounds the time a lone request waits for company.  `fn`
    maps a (batch_size, ...) array to a (batch_size, ...) result: a
    ServedModel, a forward, or a generate closure over same-length
    prompts."""

    def __init__(self, fn, batch_size: int, max_wait_ms: float = 5.0):
        self.fn = fn
        self.batch_size = batch_size
        self.max_wait = max_wait_ms / 1000.0
        self.batches = 0
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, x) -> Future:
        """Enqueue one example; returns a concurrent.futures.Future."""
        fut: Future = Future()
        self._q.put((np.asarray(x), fut))
        return fut

    def __call__(self, x):
        return self.submit(x).result()

    def _loop(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.perf_counter() + self.max_wait
            while len(batch) < self.batch_size:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            xs = np.stack([b[0] for b in batch])
            n = len(batch)
            if n < self.batch_size:              # pad to the compiled shape
                pad = np.repeat(xs[:1], self.batch_size - n, axis=0)
                xs = np.concatenate([xs, pad])
            try:
                ys = self.fn(xs)
                ys = (ys.detach().float().cpu().numpy()
                      if isinstance(ys, torch.Tensor) else np.asarray(ys))
                self.batches += 1
                for i, (_, fut) in enumerate(batch):
                    fut.set_result(ys[i])
            except BaseException as e:   # every future of the batch gets it
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
