"""K3: grouped-query flash attention with K/V at kv width, forward and
backward.

The port of `vitrs_tpu/ops/flash_attention_gqa.py`.  Its Pallas launchers
(`_fwd_single` and `_fwd`, `_bwd_single` and `_bwd_parts`) run the six
tile kernels of ops/flash_attention.py at GQA geometry; here the same two
CUDA libraries as K1-fwd and K2 run at that geometry: `csrc/flash_fwd.cu`
and `csrc/flash_bwd.cu` take a kv_heads argument, query head h reads kv
head h // (num_heads // kv_heads), and the dK/dV kernel sums dk and dv over
each kv head's group of query heads in registers.  So K/V are never
expanded to num_heads in device memory, and dk/dv leave the kernel at kv
width, already summed.

Layout ("GQA-packed"): qkv (B, T, C + 2*kv_dim) = q | k | v, q at channels
[0, C) as in the MHA packed layout, k and v at kv width (kv head g at
channels [g*D, (g+1)*D) of its part).  The TPU-shaped parts of the JAX
module are not carried over: the phantom-lane padding of small kv widths
to 128 lanes (`pad_gqa_weight`, `kvd_padded`), the split-cell grid
(`_q_split`), the 128-lane kv blocks of `_geom`, the VMEM budgets, and
`supports_gqa`, the rule that sends the geometries those blocks cannot
tile to the JAX package's expanded-weight MHA route.  The port's kernels
take any kv_heads dividing num_heads at every head dim of
`flash_attention.HEAD_DIMS`, MQA included.

* The kernels are the custom ops `vitrs::flash_gqa_fwd` and
  `vitrs::flash_gqa_bwd` (`_build.kernel_op`).  A CUDA tensor goes to the
  kernels (`flash_gqa_fwd_cuda`, `flash_gqa_bwd_cuda`), or the wrapper
  raises; a CPU tensor to their plain PyTorch versions, which the CPU tests
  hold against the JAX kernels.
* `flash_gqa_fwd_cuda.launches` and `flash_gqa_bwd_cuda.launches` count
  the wrappers' calls, apart from K1's and K2's counts, so that a run shows
  which kernel served it.  A backward call runs three kernels (pre-pass,
  dK/dV, dQ) and counts once.
* `flash_gqa_qkv` is differentiable in the packed qkv through an
  autograd.Function whose backward is the K3 backward.
* The sliding window and rope are K1/K2's (the same kernels): the band
  skips kv tiles outside it, q and k are rotated as they are loaded (in
  the backward, once, by its pre-pass), and dk is rotated back once, after
  the group sum.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import _build
from .flash_attention import (_bwd_fake, _fwd_fake, flash_bwd_plain,
                              flash_fwd_plain, launch_bwd, launch_fwd)

def split_gqa(qkv: torch.Tensor, num_heads: int, kv_heads: int):
    """Split a GQA-packed projection (B, T, C + 2*kv_dim) into q/k/v views.
    C = num_heads*D, kv_dim = kv_heads*D, solved from the packed width
    W = (num_heads + 2*kv_heads)*D."""
    W = qkv.shape[-1]
    C = W * num_heads // (num_heads + 2 * kv_heads)
    kvd = (W - C) // 2
    return qkv[..., :C], qkv[..., C:C + kvd], qkv[..., C + kvd:]


def flash_gqa_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        num_heads: int, kv_heads: int, causal: bool,
                        sm_scale: float, window: int = 0, rope: bool = False,
                        q_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3-fwd's function in plain PyTorch: q (B, Tq, C) at q_offset, k/v
    (B, Tk, kv_dim) -> (out (B, Tq, C) in q's dtype, lse (B, NH, Tq)
    fp32), with K1's numerics, band, rectangle and rotation
    (`flash_attention.flash_fwd_plain`)."""
    return flash_fwd_plain(q, k, v, num_heads, causal, sm_scale,
                           kv_heads=kv_heads, q_offset=q_offset,
                           window=window, rope=rope)


def flash_gqa_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       num_heads: int, kv_heads: int, causal: bool,
                       sm_scale: float, window: int = 0, rope: bool = False,
                       q_offset: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K3-fwd on q's current stream: the contract of
    `flash_gqa_fwd_plain`.  q/k/v may be strided views into the packed qkv
    (last dim contiguous).  Raises on anything the kernel does not take."""
    res = launch_fwd("flash_gqa_fwd_cuda", q, k, v, num_heads, kv_heads,
                     causal, sm_scale, q_offset, window, rope)
    flash_gqa_fwd_cuda.launches += 1
    return res


flash_gqa_fwd_cuda.launches = 0

flash_gqa_fwd_op = _build.kernel_op(
    "flash_gqa_fwd", "(Tensor q, Tensor k, Tensor v, int num_heads, "
    "int kv_heads, bool causal, float sm_scale, int window, bool rope, "
    "int q_offset=0) -> (Tensor, Tensor)", lambda *a: flash_gqa_fwd_plain(*a),
    lambda *a: flash_gqa_fwd_cuda(*a), _fwd_fake)


def flash_gqa_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, num_heads: int, kv_heads: int,
                        causal: bool, sm_scale: float, window: int = 0,
                        rope: bool = False, q_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3-bwd's function in plain PyTorch: (dq (B, Tq, C), dk, dv
    (B, Tk, kv_dim)), dk/dv summed over each group in fp32 and rounded
    once; under rope dk is rotated back once, after the group sum
    (`flash_attention.flash_bwd_plain`, q at q_offset)."""
    return flash_bwd_plain(q, k, v, out, lse, do, num_heads, causal,
                           sm_scale, kv_heads=kv_heads, window=window,
                           rope=rope, q_offset=q_offset)


def flash_gqa_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                       num_heads: int, kv_heads: int, causal: bool,
                       sm_scale: float, window: int = 0, rope: bool = False,
                       q_offset: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K3-bwd (three kernels: pre-pass, dK/dV, dQ; `launches`
    counts the call once) on q's current stream: the contract of
    `flash_gqa_bwd_plain`."""
    res = launch_bwd("flash_gqa_bwd_cuda", q, k, v, out, lse, do, num_heads,
                     kv_heads, causal, sm_scale, window, rope, q_offset)
    flash_gqa_bwd_cuda.launches += 1
    return res


flash_gqa_bwd_cuda.launches = 0

flash_gqa_bwd_op = _build.kernel_op(
    "flash_gqa_bwd", "(Tensor q, Tensor k, Tensor v, Tensor out, Tensor lse, "
    "Tensor dout, int num_heads, int kv_heads, bool causal, float sm_scale, "
    "int window, bool rope, int q_offset=0) -> (Tensor, Tensor, Tensor)",
    lambda *a: flash_gqa_bwd_plain(*a), lambda *a: flash_gqa_bwd_cuda(*a),
    _bwd_fake)


def _scale(qkv, num_heads, kv_heads, sm_scale):
    if sm_scale is not None:
        return sm_scale
    return 1.0 / math.sqrt(qkv.shape[-1] // (num_heads + 2 * kv_heads))


def flash_gqa_attention_fwd(qkv: torch.Tensor, num_heads: int, kv_heads: int,
                            causal: bool = True,
                            sm_scale: Optional[float] = None,
                            window: int = 0, rope: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GQA-packed qkv (B, T, C + 2*kv_dim) -> (out (B, T, C), lse
    (B, NH, T) fp32).  q, k and v are views into qkv: the kernel reads
    them in place (and rotates q and k under rope)."""
    sm_scale = _scale(qkv, num_heads, kv_heads, sm_scale)
    q, k, v = split_gqa(qkv, num_heads, kv_heads)
    return flash_gqa_fwd_op(q, k, v, num_heads, kv_heads, causal, sm_scale,
                            window, rope)


def flash_gqa_attention_bwd(qkv: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor,
                            num_heads: int, kv_heads: int,
                            causal: bool = True,
                            sm_scale: Optional[float] = None,
                            window: int = 0, rope: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of `flash_gqa_attention_fwd`: (dq (B, T, C), dk, dv
    (B, T, kv_dim)), as the separate arrays the JAX package's GQA
    `_bwd_parts` returns (without its phantom lanes)."""
    sm_scale = _scale(qkv, num_heads, kv_heads, sm_scale)
    q, k, v = split_gqa(qkv, num_heads, kv_heads)
    return flash_gqa_bwd_op(q, k, v, out, lse, do, num_heads, kv_heads,
                            causal, sm_scale, window, rope)


class _FlashGQAPacked(torch.autograd.Function):
    """GQA flash attention over packed qkv with its K3 backward; the packed
    gradient is the concatenation of dq and the group-summed dk, dv."""

    @staticmethod
    def forward(ctx, qkv, num_heads, kv_heads, causal, sm_scale, window, rope):
        out, lse = flash_gqa_attention_fwd(qkv, num_heads, kv_heads, causal,
                                           sm_scale, window, rope)
        ctx.save_for_backward(qkv, out, lse)
        ctx.args = (num_heads, kv_heads, causal, sm_scale, window, rope)
        return out

    @staticmethod
    def backward(ctx, do):
        qkv, out, lse = ctx.saved_tensors
        parts = flash_gqa_attention_bwd(qkv, out, lse, do.contiguous(),
                                        *ctx.args)
        return torch.cat(parts, dim=-1), None, None, None, None, None, None


def flash_gqa_qkv(qkv: torch.Tensor, num_heads: int, kv_heads: int,
                  causal: bool = True, sm_scale: Optional[float] = None,
                  window: int = 0, rope: bool = False) -> torch.Tensor:
    """GQA flash attention over packed qkv (B, T, C + 2*kv_dim) ->
    (B, T, C); differentiable with respect to qkv, which arrives unrotated
    (rope rotates q and k inside the kernels)."""
    return _FlashGQAPacked.apply(qkv, num_heads, kv_heads, causal, sm_scale,
                                 window, rope)
