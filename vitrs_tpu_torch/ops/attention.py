"""Attention dispatch and the GQA helpers — the port of
`vitrs_tpu/ops/attention.py`.

The JAX package sends attention to its Pallas flash kernel on a TPU and to
dense XLA elsewhere.  Here the flash path is every geometry the port's
kernels take (`supports`: every divisor of 128 and every multiple of 128
up to 1024 as head dim, any kv_heads dividing num_heads): on a CUDA tensor the hand-written kernels
(K1-fwd and K2 for MHA, ops/flash_attention.py; K3 for GQA,
ops/flash_attention_gqa.py), on a CPU tensor their plain PyTorch versions.
Other geometries, and `use_flash=False`, go to dense attention.  Both
routes are differentiable: the flash route through its autograd.Functions,
the dense route through plain torch autograd.

The GQA helpers (`expand_kv_heads`, `expand_packed`, `expand_qkv_weight`)
are plain torch: the dense route for geometries the kernels do not tile
(expanded weights, as the JAX model's plain composition does) and the
oracle the tests compare the K3 kernels with.
`attention_gqa` computes what the JAX function computes without its
expansion: the JAX package expands K/V to num_heads and rides K1, the port
reads K/V at kv width in K3.
"""

from __future__ import annotations

import numpy as np
import torch

from . import basic
from .flash_attention import HEAD_DIMS, ROPE_HEAD_DIMS, flash_attention_qkv
from .flash_attention_gqa import flash_gqa_qkv, split_gqa
from .rope import rope_qk


def supports(num_heads: int, head_dim: int, kv_heads: int = 0,
             rope: bool = False) -> bool:
    """The port's routing rule, its kernels' own: head_dim in HEAD_DIMS
    (every divisor of 128 and every multiple of 128 up to 1024), any head
    count, and kv_heads (0: num_heads) dividing num_heads; under rope
    (rotated inside the kernels) the even head dims up to 128.  That
    covers every geometry that the JAX package sends to a Pallas kernel up
    to D = 1024: it pads a head count its 128-lane blocks cannot tile with
    phantom heads (`padded_num_heads`), so gpt-nano's 2 heads of 8 (16
    phantom heads) and gpt2-1558m's 25 heads of 64 run on the kernels in
    both (here unpadded: the grid has a block row per head).  The port's
    kernels also take the GQA geometries the JAX package sends to its
    expanded MHA route, and D >= 256 under GQA: the same function.  Rope
    at D >= 256 is dense in both (the JAX kernels assert on it,
    `_rope_table`; the JAX package computes it densely on the CPU), and so
    is rope at D = 1, which has no pair to rotate.  Past D = 1024, which
    the JAX kernels tile, the port's fp32 forward would need 2048 threads
    a block: dense (ROADMAP.md Queue 2)."""
    kv_heads = kv_heads or num_heads
    return (head_dim in (ROPE_HEAD_DIMS if rope else HEAD_DIMS)
            and kv_heads > 0 and num_heads % kv_heads == 0)


def rope_packed(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Packed MHA qkv with q and k rotated at positions 0..T-1 (`rope_qk`),
    v untouched: the dense route's explicit rotation."""
    C = qkv.shape[-1] // 3
    q, k = rope_qk(qkv[..., :C], qkv[..., C:2 * C],
                   torch.arange(qkv.shape[1], device=qkv.device), num_heads)
    return torch.cat([q, k, qkv[..., 2 * C:]], dim=-1)


def attention(qkv: torch.Tensor, num_heads: int, causal: bool = True,
              window: int = 0, rope: bool = False,
              use_flash: bool = True, quirks: bool = False) -> torch.Tensor:
    """Multi-head attention over packed qkv (B, T, 3C) -> (B, T, C).
    window > 0 (causal only) is sliding-window attention.  rope=True takes
    UNROTATED qkv and rotates q and k at positions 0..T-1: inside the
    kernels on the flash route, with an explicit `rope_qk` on the dense
    route, as in the JAX function.  use_flash=False takes the dense route
    for every geometry, as the JAX function's switch does; so does
    quirks=True, the reference's softmax as written (G5, G11), which no
    kernel computes."""
    head_dim = qkv.shape[-1] // (3 * num_heads)
    if quirks or not (use_flash and supports(num_heads, head_dim, rope=rope)):
        if rope:
            qkv = rope_packed(qkv, num_heads)
        return basic.attention_dense(qkv, num_heads, causal=causal,
                                     window=window, quirks=quirks)[0]
    return flash_attention_qkv(qkv, num_heads, causal=causal, window=window,
                               rope=rope)


def expand_kv_heads(kv: torch.Tensor, kv_heads: int,
                    num_heads: int) -> torch.Tensor:
    """K or V (B, T, kv_heads*D) -> (B, T, num_heads*D): kv head g serves
    the G = num_heads // kv_heads consecutive query heads [g*G, (g+1)*G)
    (the Llama/GQA convention).  Its autograd transpose is the per-group
    sum, the GQA dk/dv reduction."""
    if kv_heads == num_heads:
        return kv
    B, T, kvd = kv.shape
    D = kvd // kv_heads
    return (kv.reshape(B, T, kv_heads, D)
            .repeat_interleave(num_heads // kv_heads, dim=2)
            .reshape(B, T, num_heads * D))


def expand_packed(qkv: torch.Tensor, num_heads: int,
                  kv_heads: int) -> torch.Tensor:
    """GQA-packed projection (B, T, C + 2*kv_dim) -> packed MHA (B, T, 3C)."""
    if not kv_heads or kv_heads == num_heads:
        return qkv
    q, k, v = split_gqa(qkv, num_heads, kv_heads)
    return torch.cat([q, expand_kv_heads(k, kv_heads, num_heads),
                      expand_kv_heads(v, kv_heads, num_heads)], dim=-1)


def _expand_row_index(num_heads: int, kv_heads: int,
                      head_size: int) -> np.ndarray:
    """The row gather (length 3C) from the GQA projection's rows onto the
    packed MHA output channels: q rows pass through, each kv head's D rows
    repeat for its G = num_heads // kv_heads query heads."""
    C = num_heads * head_size
    kvd = kv_heads * head_size
    base = np.arange(kvd).reshape(kv_heads, head_size)
    kv = np.repeat(base, num_heads // kv_heads, axis=0).reshape(-1)
    return np.concatenate([np.arange(C), C + kv, C + kvd + kv])


def expand_qkv_weight(qkvw: torch.Tensor, qkvb, num_heads: int,
                      kv_heads: int):
    """GQA projection weight (..., C + 2*kv_dim, IC) and bias -> the MHA
    (..., 3C, IC) weight and bias, repeating each kv head's D rows for its
    query group: linear(x, expanded) == expand_packed(linear(x, w))
    exactly.  The dense route's projection (models/model.py); its autograd
    transpose sums the group's rows back (the JAX package's
    `reduce_qkv_weight_grad`)."""
    if not kv_heads or kv_heads == num_heads:
        return qkvw, qkvb
    D = qkvw.shape[-2] // (num_heads + 2 * kv_heads)
    idx = torch.as_tensor(_expand_row_index(num_heads, kv_heads, D),
                          device=qkvw.device)
    w = qkvw.index_select(-2, idx)
    b = None if qkvb is None else qkvb.index_select(-1, idx)
    return w, b


def attention_gqa(qkv: torch.Tensor, num_heads: int, kv_heads: int,
                  causal: bool = True, window: int = 0,
                  rope: bool = False, use_flash: bool = True) -> torch.Tensor:
    """Grouped-query attention over a GQA-packed projection
    (B, T, C + 2*kv_dim) -> (B, T, C).  MHA (kv_heads == num_heads) is
    `attention`; a flash geometry goes to K3, which reads K/V at kv width
    (the JAX function expands K/V and rides K1: the same function); any
    other geometry, or use_flash=False, to dense attention over the
    expanded K/V.  window and rope as in `attention` (the JAX function
    takes no rope: its callers rotate first; a rotation per head commutes
    with the expansion)."""
    if kv_heads == num_heads:
        return attention(qkv, num_heads, causal=causal, window=window,
                         rope=rope, use_flash=use_flash)
    head_dim = qkv.shape[-1] // (num_heads + 2 * kv_heads)
    if not (use_flash and supports(num_heads, head_dim, kv_heads, rope)):
        return attention(expand_packed(qkv, num_heads, kv_heads), num_heads,
                         causal=causal, window=window, rope=rope,
                         use_flash=False)
    return flash_gqa_qkv(qkv, num_heads, kv_heads, causal=causal,
                         window=window, rope=rope)
