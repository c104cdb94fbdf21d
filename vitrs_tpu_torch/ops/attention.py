"""Attention dispatch — the port of `vitrs_tpu/ops/attention.py`.

The JAX package sends attention to its Pallas flash kernel on a TPU and to
dense XLA elsewhere.  Here the flash path (ops/flash_attention.py) takes
every geometry the JAX package's kernel takes: on a CUDA tensor it is the
hand-written kernels (K1-fwd forward, K2 backward), on a CPU tensor their
plain PyTorch versions.  Geometries the JAX kernel does not take go to
dense attention in both packages.  Both routes are differentiable: the
flash route through its autograd.Function, the dense route through plain
torch autograd.
"""

from __future__ import annotations

import torch

from . import basic
from .flash_attention import flash_attention_qkv


def supports(num_heads: int, head_dim: int) -> bool:
    """The JAX package's routing rule (vitrs_tpu/ops/flash_attention.supports),
    kept so that both packages route every geometry the same way: a head_dim
    that tiles 128 lanes and a head count that fills whole 128-lane groups.
    Every GPT-2 preset (D = 64, even head count) passes; gpt-nano (D = 8)
    does not."""
    if head_dim >= 128:
        return head_dim % 128 == 0
    return 128 % head_dim == 0 and num_heads % (128 // head_dim) == 0


def attention(qkv: torch.Tensor, num_heads: int,
              causal: bool = True) -> torch.Tensor:
    """Multi-head attention over packed qkv (B, T, 3C) -> (B, T, C)."""
    head_dim = qkv.shape[-1] // (3 * num_heads)
    if not supports(num_heads, head_dim):
        return basic.attention_dense(qkv, num_heads, causal=causal)[0]
    return flash_attention_qkv(qkv, num_heads, causal=causal)


def split_gqa(qkv: torch.Tensor, num_heads: int, kv_heads: int):
    """Split a packed projection (B, T, C + 2*kv_dim) into q/k/v views.
    C = num_heads*D, kv_dim = kv_heads*D — solved from the packed width
    W = (num_heads + 2*kv_heads)*D."""
    W = qkv.shape[-1]
    C = W * num_heads // (num_heads + 2 * kv_heads)
    kvd = (W - C) // 2
    return qkv[..., :C], qkv[..., C:C + kvd], qkv[..., C + kvd:]
