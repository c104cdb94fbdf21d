"""Core ops — the port of the forward half of `vitrs_tpu/ops/basic.py`.

Plain functions on tensors, with the JAX package's dtype rules: LayerNorm
statistics in fp32, tanh-GELU in the input dtype, linear with an fp32
accumulator and an output in the input dtype.  The matmuls are left to
torch.matmul (cuBLAS on the card), as the JAX package left them to XLA.
Backward passes and the quirk/CE ops come with the training slice.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

LN_EPS = 1e-5
GELU_COEF = 0.044715
INV_SQRT2 = 0.7071067811865476


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LayerNorm over the last axis; returns (out, mean, rstd) like the JAX
    op.  Statistics and the affine step in fp32, output in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1)
    var = (xf - mean[..., None]).square().mean(dim=-1)
    rstd = torch.rsqrt(var + LN_EPS)
    out = (xf - mean[..., None]) * rstd[..., None] * w.float() + b.float()
    return out.to(x.dtype), mean, rstd


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximation GELU, computed in x's dtype as the JAX op is."""
    s = math.sqrt(2.0 / math.pi)
    cube = GELU_COEF * x * x * x
    return 0.5 * x * (1.0 + torch.tanh(s * (x + cube)))


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU 0.5·x·(1 + erf(x/√2)), in fp32, output in x's dtype."""
    xf = x.float()
    return (0.5 * xf * (1.0 + torch.erf(xf * INV_SQRT2))).to(x.dtype)


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ W.T (+ b) with W stored (OC, C).

    The weight must already be in x's dtype: callers cast the weights once
    when a model is built (models/model.prepare_params), where the JAX op
    casts on every call; the result is the same.  torch.matmul accumulates
    in fp32 and returns x's dtype, and the bias adds in x's dtype, as in the
    JAX op."""
    if w.dtype != x.dtype or (b is not None and b.dtype != x.dtype):
        raise TypeError(f"linear: weights in {w.dtype}, input in {x.dtype}; "
                        "cast the weights once with prepare_params")
    y = torch.matmul(x, w.t())
    return y if b is None else y + b


def attention_dense(qkv: torch.Tensor, num_heads: int, causal: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materialised multi-head attention over packed qkv (B, T, 3C).

    Returns (out (B, T, C), att (B, NH, T, T) fp32) like the JAX op without
    its quirk and window options.  Scores and the softmax in fp32; the
    probabilities round to v's dtype before the product with V."""
    B, T, C3 = qkv.shape
    C = C3 // 3
    D = C // num_heads

    def heads(t):
        return t.reshape(B, T, num_heads, D).transpose(1, 2).float()

    q, k, v = (heads(t) for t in qkv.split(C, dim=-1))
    scores = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(D))
    if causal:
        mask = torch.ones(T, T, dtype=torch.bool, device=qkv.device).tril()
        scores = scores.masked_fill(~mask, -math.inf)
    att = torch.softmax(scores, dim=-1)
    out = torch.matmul(att.to(qkv.dtype).float(), v).to(qkv.dtype)
    return out.transpose(1, 2).reshape(B, T, C), att
