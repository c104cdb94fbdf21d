"""Binary checkpoint format — the port of `vitrs_tpu/checkpoint.py`.

The same file as the JAX package reads and writes: an i32[256] header
(1024 bytes; layout documented in vitrs_tpu/checkpoint.py) followed by every
parameter tensor as contiguous f32 in canonical order, then, when the header
says so, the AdamW m and v vectors and an i64 dataloader cursor.  A file
written by either package loads in the other.

Ranges of NATIVE_MIN_BYTES (32 MB) or more are read by the multi-threaded
native reader (native/ckptio.cpp `vitrs_read_range`, pread over up to 8
threads), as the JAX package reads them; smaller ranges, or a reader that
does not build or has another ABI, take a plain file read.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .config import ViTConfig
from .params import num_parameters, param_shapes, tensor_order

MAGIC = 20240326
HEADER_I32 = 256
HEADER_BYTES = 1024
# ranges at least this long go through the native reader; below it a plain
# read wins on latency (the JAX package's threshold)
NATIVE_MIN_BYTES = 32 << 20


def _header(cfg: ViTConfig, version: int, step: int, has_opt: bool,
            seed: int) -> np.ndarray:
    h = np.zeros(HEADER_I32, dtype=np.int32)
    h[0] = MAGIC
    h[1] = version
    h[2] = cfg.max_seq_len
    h[3] = cfg.vocab_size
    h[4] = cfg.num_layers
    h[5] = cfg.num_heads
    h[6] = cfg.channels
    if version >= 2:
        h[7] = 1 if cfg.mode == "vit" else 0
        h[8] = cfg.img_size
        h[9] = cfg.patch_size
        h[10] = cfg.in_chans
        h[11] = cfg.num_classes
        h[12] = 1 if cfg.pool == "mean" else 0
        h[13] = step
        h[14] = 1 if has_opt else 0
        h[15] = seed
        h[16] = cfg.num_kv_heads
        h[17] = 1 if cfg.pos_emb == "rope" else 0
        h[18] = cfg.window
        h[19] = cfg.num_experts
        h[20] = cfg.moe_top_k if cfg.num_experts else 0
    return h


def config_from_header(h: np.ndarray) -> ViTConfig:
    version = int(h[1]) if int(h[0]) == MAGIC else 1
    kw = dict(max_seq_len=int(h[2]), vocab_size=int(h[3]),
              num_layers=int(h[4]), num_heads=int(h[5]), channels=int(h[6]))
    if version >= 2 and int(h[7]) == 1:
        kw.update(mode="vit", img_size=int(h[8]), patch_size=int(h[9]),
                  in_chans=int(h[10]), num_classes=int(h[11]),
                  pool="mean" if int(h[12]) == 1 else "cls")
    if version >= 2 and int(h[16]):
        kw.update(num_kv_heads=int(h[16]))
    if version >= 2 and int(h[17]) == 1:
        kw.update(pos_emb="rope")
    if version >= 2 and int(h[18]):
        kw.update(window=int(h[18]))
    if version >= 2 and int(h[19]):
        kw.update(num_experts=int(h[19]), moe_top_k=int(h[20]))
    return ViTConfig(**kw).validate()


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float32).numpy()
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32))


def save_checkpoint(path: str, params: Mapping, cfg: ViTConfig,
                    m=None, v=None, step: int = 0, seed: int = 0,
                    cursor: int = 0) -> None:
    """Write params (tensors or numpy arrays) and optional flat AdamW m/v.
    The version rule is the JAX package's: v1 unless a field only v2 holds
    is set.  Written to a temporary file and renamed into place."""
    has_opt = m is not None and v is not None
    version = 2 if (cfg.mode == "vit" or has_opt or step or seed
                    or cfg.num_kv_heads or cfg.pos_emb == "rope"
                    or cfg.window or cfg.num_experts) else 1
    h = _header(cfg, version, step, has_opt, seed)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(h.tobytes())
        for name in tensor_order(cfg):
            f.write(_f32(params[name]).tobytes())
        if has_opt:
            f.write(_f32(m).tobytes())
            f.write(_f32(v).tobytes())
            f.write(np.int64(cursor).tobytes())
    os.replace(tmp, path)


def _native_lib():
    """native/ckptio.cpp (built by g++ at first use), or None where it does
    not build or its ABI is not the one called here."""
    from .native import build
    lib = build.load("ckptio")
    if lib is None:
        return None
    try:
        if lib.vitrs_ckptio_abi() != 1:
            return None
    except AttributeError:
        return None
    lib.vitrs_read_range.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_void_p,
                                     ctypes.c_int]
    lib.vitrs_read_range.restype = ctypes.c_int
    return lib


def _read_range(path: str, offset: int, nbytes: int) -> np.ndarray:
    """Bytes [offset, offset + nbytes) of the file: the native pread over
    up to 8 threads for a range of NATIVE_MIN_BYTES or more, else (or if
    the native read fails) a plain read."""
    lib = _native_lib() if nbytes >= NATIVE_MIN_BYTES else None
    if lib is not None:
        out = np.empty(nbytes, np.uint8)
        rc = lib.vitrs_read_range(os.fsencode(path), offset, nbytes,
                                  out.ctypes.data,
                                  min(os.cpu_count() or 1, 8))
        if rc == 0:
            return out
    with open(path, "rb") as f:
        f.seek(offset)
        buf = f.read(nbytes)
    return np.frombuffer(buf, np.uint8)


def load_checkpoint(path: str, cfg: Optional[ViTConfig] = None
                    ) -> Tuple[Dict[str, np.ndarray], ViTConfig, dict]:
    """Read a checkpoint; the header is the config's source of truth.

    Returns (params as f32 numpy arrays, config, extras) with extras holding
    step/seed/m/v/cursor — the JAX package's return contract, so
    `params.from_numpy` takes the first element either way.  A caller's cfg
    may change implementation switches but must agree on the five header
    geometry fields, else ValueError."""
    with open(path, "rb") as f:
        h = np.frombuffer(f.read(HEADER_BYTES), dtype=np.int32)
    if h.shape[0] != HEADER_I32:
        raise ValueError(f"truncated header in {path}")
    if int(h[0]) != MAGIC:
        raise ValueError(f"bad magic {int(h[0])} (expected {MAGIC}) in {path}")
    if int(h[1]) not in (1, 2):
        raise ValueError(
            f"unsupported checkpoint version {int(h[1])} in {path}: only "
            f"versions 1 (f32 core-16) and 2 (vit/opt-state extension) are "
            f"readable; llm.c bf16 exports (version 3) are not")
    file_cfg = config_from_header(h)
    if cfg is not None:
        for f_name in ("max_seq_len", "vocab_size", "num_layers", "num_heads",
                       "channels"):
            if getattr(cfg, f_name) != getattr(file_cfg, f_name):
                raise ValueError(
                    f"config mismatch on {f_name}: caller has "
                    f"{getattr(cfg, f_name)}, file has "
                    f"{getattr(file_cfg, f_name)}")
        file_cfg = cfg
    shapes = param_shapes(file_cfg)
    n = num_parameters(file_cfg)
    file_size = os.path.getsize(path)
    if file_size < HEADER_BYTES + n * 4:
        off = 0
        avail = max(0, file_size - HEADER_BYTES) // 4
        for name in tensor_order(file_cfg):
            off += int(np.prod(shapes[name]))
            if off > avail:
                raise ValueError(f"truncated checkpoint at tensor {name}")
    flat = _read_range(path, HEADER_BYTES, n * 4).view(np.float32)
    params, off = {}, 0
    for name in tensor_order(file_cfg):
        size = int(np.prod(shapes[name]))
        params[name] = flat[off:off + size].reshape(shapes[name]).copy()
        off += size
    extras = {"step": int(h[13]), "seed": int(h[15]), "m": None, "v": None,
              "cursor": 0}
    if int(h[1]) >= 2 and int(h[14]) == 1:
        opt_off = HEADER_BYTES + n * 4
        opt = _read_range(path, opt_off, n * 8).view(np.float32)
        extras["m"] = opt[:n].copy()
        extras["v"] = opt[n:].copy()
        if file_size >= opt_off + n * 8 + 8:
            cur = _read_range(path, opt_off + n * 8, 8).view(np.int64)
            extras["cursor"] = int(cur[0])
    return params, file_cfg, extras
