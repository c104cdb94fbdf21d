"""Rotary positional embeddings (RoPE) — the port of `vitrs_tpu/ops/rope.py`.

Each query/key head is rotated by a position-dependent angle, so attention
scores depend on the relative distance of query and key.  The pairing is
the half-split one of the JAX package (the GPT-NeoX/Llama convention): dim i
of a head pairs with dim i + D/2, never even with odd.

    out[i]       = x[i] cos(t w_i) - x[i + D/2] sin(t w_i)
    out[i + D/2] = x[i] sin(t w_i) + x[i + D/2] cos(t w_i),
    w_i = base^(-i / (D/2))

With cfg.pos_emb == "rope" the wpe table stays in the parameter set (the
canonical 16-tensor layout is never reordered) but is not read and gets an
exact zero gradient.

Two uses:
* `apply_rope` / `rope_qk`: the explicit rotation of packed activations,
  as the JAX functions compute it (the dense attention route, the serving
  paths that write rotated K into the cache);
* `rope_table` + `rotate`: the compact fp32 (T, D/2) cos and sin tables the
  flash kernels read to rotate q and k as they load them, and the same
  rotation in plain PyTorch for the kernels' plain versions.  The Pallas
  kernels stream a (T, 256) lane-repeated table in the qkv dtype and rotate
  with a +-1 permutation matmul; both are TPU layout and are not carried
  over.  The table stays in fp32 here where the Pallas kernels round it to
  bf16 in bf16 runs: a difference of at most 2^-9 relative in cos and sin,
  inside the bf16 rounding of the rotated q and k themselves.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

DEFAULT_BASE = 10000.0


def rope_angles(pos: torch.Tensor, head_dim: int,
                base: float = DEFAULT_BASE) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) for positions `pos` (any shape P), each (*P, head_dim/2)
    fp32; the inverse frequencies are the RoFormer geometric series."""
    half = head_dim // 2
    inv_freq = base ** (-torch.arange(half, dtype=torch.float32,
                                      device=pos.device) / half)
    ang = pos.to(torch.float32)[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def _pair_rotate(xf: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                 ) -> torch.Tensor:
    """xf (..., heads, D) fp32, cos/sin broadcastable to (..., 1, D/2)."""
    half = xf.shape[-1] // 2
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def apply_rope(x: torch.Tensor, pos, num_heads: int,
               base: float = DEFAULT_BASE, inverse: bool = False
               ) -> torch.Tensor:
    """Rotate packed heads x (B, T, H*D) at positions `pos`: a scalar, (T,)
    sequence positions, (B, 1) per-example starts (decode slots) or (B, T).
    inverse=True applies R(-theta), the transpose.  Computed in fp32,
    returned in x's dtype."""
    B, T, C = x.shape
    D = C // num_heads
    pos = torch.as_tensor(pos, device=x.device)
    if pos.dim() == 0:
        pos = pos[None, None]
    elif pos.dim() == 1:
        pos = pos[None, :]
    cos, sin = rope_angles(pos.expand(B, T), D, base)       # (B, T, D/2)
    if inverse:
        sin = -sin
    xf = x.float().reshape(B, T, num_heads, D)
    out = _pair_rotate(xf, cos[:, :, None], sin[:, :, None])
    return out.reshape(B, T, C).to(x.dtype)


def rope_qk(q: torch.Tensor, k: torch.Tensor, pos, num_heads: int,
            kv_heads: int = 0, base: float = DEFAULT_BASE):
    """Rotate q (B, T, C) and k (B, T, kv_dim) at shared positions; k may
    carry fewer heads (GQA), since the rotation is per head."""
    return (apply_rope(q, pos, num_heads, base),
            apply_rope(k, pos, kv_heads or num_heads, base))


@functools.lru_cache(maxsize=8)
def _table(T: int, head_dim: int, device: str, base: float):
    cos, sin = rope_angles(torch.arange(T, device=device), head_dim, base)
    return cos.contiguous(), sin.contiguous()


def rope_table(T: int, head_dim: int, device,
               base: float = DEFAULT_BASE) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (cos, sin) tables the flash kernels read: each (T, head_dim/2)
    fp32, contiguous, row t for position t.  Cached per (T, D, device), so
    every layer of a step reads the same two tensors."""
    return _table(int(T), int(head_dim), str(torch.device(device)),
                  float(base))


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
           num_heads: int, inverse: bool = False,
           scale: Optional[float] = None) -> torch.Tensor:
    """The kernels' rotation in plain PyTorch: x (B, T, H*D) in any dtype,
    cos/sin the table rows of x's T positions (T, D/2) -> fp32 (B, T, H*D).
    scale folds into cos and sin (the softmax 1/sqrt(D) of q), as the
    kernels fold it; inverse rotates by -theta."""
    B, T, C = x.shape
    D = C // num_heads
    if scale is not None:
        cos, sin = cos * scale, sin * scale
    if inverse:
        sin = -sin
    xf = x.float().reshape(B, T, num_heads, D)
    return _pair_rotate(xf, cos[:, None], sin[:, None]).reshape(B, T, C)
