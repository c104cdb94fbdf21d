"""K4: rectangular flash attention for continuation prefill (forward only).

The port of `vitrs_tpu/ops/flash_prefill.py`.  Chunked prefill
(models/generate.py) runs a prompt through the KV cache in fixed-size
chunks; every chunk after the first is a rectangle: S queries at absolute
positions q_offset..q_offset+S-1 attend the cache prefix [0, q_offset+S),
with the causal frontier of query i at q_offset+i.  The Pallas kernel is
the online-softmax tile kernel instantiated with separate q and k/v of
different lengths and a static q_off; here it is the same CUDA kernel as
K1-fwd and K3-fwd (`csrc/flash_fwd.cu`), launched with tq = S, q_off and
kv_heads, reading the cache at kv width (MHA is kv_heads == num_heads), at every
head dim the kernels take (`flash_attention.HEAD_DIMS`).
Its kv loop stops at each block's causal frontier, so cache slots at or
beyond q_offset+S are never read and may hold anything.

* The kernel is the custom op `vitrs::flash_prefill` (`_build.kernel_op`).
  A CUDA tensor goes to the kernel (`flash_prefill_cuda`, which counts its
  own `launches`), or the wrapper raises; a CPU tensor to the plain PyTorch
  version, which cuts the cache at the frontier before any arithmetic, so
  a NaN in the unfilled tail cannot leak in as 0 * NaN.
* The JAX function's contract asserts become ValueError here (a bare
  assert vanishes under `python -O`): the geometry, q_offset >= 0, a cache
  length that is a multiple of PREFILL_BLOCK, and a chunk that fits it.
* window > 0 is the sliding-window band: query i sees keys in
  (q_offset + i - window, q_offset + i], and the kernel's kv loop starts
  at the first tile the chunk's band reaches.  Rope stays outside K4, as
  in the JAX function: the caller passes q and the cache already rotated.
* The JAX package's `VITRS_NO_FLASH_CONT` (A/B timing on the TPU) and
  `VITRS_FLASH_CONT_INTERPRET` (interpret mode) knobs are not ported.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from .attention import supports
from .flash_attention import flash_fwd_plain, launch_fwd

# the cache-length granularity of the JAX kernel's kv grid; generate()
# rounds a chunked prefill's cache up to it, and so does the port, so that
# both packages route the same shapes to this kernel
PREFILL_BLOCK = 256


def supports_prefill(num_heads: int, kv_heads: int, head_dim: int) -> bool:
    """Whether K4 takes the geometry: the rule K1-fwd and K3 follow
    (`attention.supports`: the head dims of `flash_attention.HEAD_DIMS`,
    any head count, kv_heads dividing num_heads; the chunk arrives
    rotated, so rope does not enter).  That takes every geometry the JAX
    kernel takes (D | 128 with kv blocks that fill 128 lanes), and more:
    MQA at head_dim 64, and D >= 256, which the JAX package serves with
    dense cache attention (here K4: the same function)."""
    return supports(num_heads, head_dim, kv_heads)


def flash_prefill_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        num_heads: int, kv_heads: int, q_offset: int,
                        sm_scale: float, window: int = 0) -> torch.Tensor:
    """K4's function in plain PyTorch: q (B, S, C) at positions
    q_offset.. against k/v (B, Tk, kv_dim) caches -> out (B, S, C), with
    K1's numerics and band (`flash_attention.flash_fwd_plain`, which cuts
    the cache at the causal frontier q_offset + S first)."""
    return flash_fwd_plain(q, k, v, num_heads, True, sm_scale,
                           kv_heads=kv_heads, q_offset=q_offset,
                           window=window)[0]


def flash_prefill_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       num_heads: int, kv_heads: int, q_offset: int,
                       sm_scale: float, window: int = 0) -> torch.Tensor:
    """Launch K4 on q's current stream: the contract of
    `flash_prefill_plain`.  q may be a strided view into the chunk's packed
    qkv, k/v views of one layer's caches (last dim contiguous); the chunk
    must lie within the cache (the rectangle past the keys' end is the
    ring's, not K4's)."""
    if q_offset + q.shape[1] > k.shape[1]:
        raise ValueError(f"flash_prefill_cuda: chunk {q_offset}.."
                         f"{q_offset + q.shape[1]} does not fit a cache of "
                         f"{k.shape[1]}")
    out, _ = launch_fwd("flash_prefill_cuda", q, k, v, num_heads, kv_heads,
                        True, sm_scale, q_offset, window)
    flash_prefill_cuda.launches += 1
    return out


flash_prefill_cuda.launches = 0

flash_prefill_op = _build.kernel_op(
    "flash_prefill", "(Tensor q, Tensor k, Tensor v, int num_heads, "
    "int kv_heads, int q_offset, float sm_scale, int window) -> Tensor",
    lambda *a: flash_prefill_plain(*a), lambda *a: flash_prefill_cuda(*a),
    lambda q, *args: q.new_empty(q.shape))


def flash_prefill_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      num_heads: int, kv_heads: int, q_offset: int,
                      sm_scale: Optional[float] = None,
                      window: int = 0) -> torch.Tensor:
    """q (B, S, C) at absolute positions q_offset..q_offset+S-1 against
    k/v (B, Tk, kv_dim) caches holding positions 0..Tk-1 -> (B, S, C).

    Causal in absolute positions: query i attends keys j <= q_offset + i,
    and with window > 0 only keys j > q_offset + i - window.  Cache slots
    >= q_offset + S are never read.  Raises ValueError unless the geometry
    `supports_prefill`, q_offset is an int >= 0, window >= 0, Tk is a
    multiple of PREFILL_BLOCK and the chunk fits the cache; forward only."""
    if not isinstance(window, int) or window < 0:
        raise ValueError(f"flash_prefill_qkv: window must be an int >= 0, "
                         f"got {window!r}")
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"flash_prefill_qkv: q (B, S, C) and k, v of one "
                         f"(B, Tk, kv_dim) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, C = q.shape
    Tk, kvd = k.shape[1], k.shape[2]
    D = C // num_heads
    if (C % num_heads or num_heads % kv_heads or kvd != kv_heads * D
            or not supports_prefill(num_heads, kv_heads, D)):
        raise ValueError(f"flash_prefill_qkv: no kernel geometry for "
                         f"num_heads={num_heads}, kv_heads={kv_heads}, C={C}, "
                         f"kv_dim={kvd}")
    if not isinstance(q_offset, int) or q_offset < 0:
        raise ValueError(f"flash_prefill_qkv: q_offset must be an int >= 0, "
                         f"got {q_offset!r}")
    if Tk % PREFILL_BLOCK:
        raise ValueError(f"flash_prefill_qkv: cache length {Tk} is not a "
                         f"multiple of {PREFILL_BLOCK}")
    if q_offset + S > Tk:
        raise ValueError(f"flash_prefill_qkv: chunk {q_offset}..{q_offset + S}"
                         f" does not fit a cache of {Tk}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    return flash_prefill_op(q, k, v, num_heads, kv_heads, q_offset,
                            sm_scale, window)
