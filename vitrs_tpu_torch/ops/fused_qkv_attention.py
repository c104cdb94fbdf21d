"""Fused qkv projection + flash attention — the port of
`vitrs_tpu/ops/fused_qkv_attention.py` (MHA and GQA, rope and the sliding
window).

Forward: one packed matmul from the canonical (C + 2*kv_dim, C) weight,
then the flash forward reading q, k and v in place: K1-fwd for MHA, K3-fwd
for GQA, which reads k and v at kv width.  Backward: the flash backward (K2,
or K3-bwd, whose dk and dv come back at kv width already summed over each
group) returns dq, dk and dv as three arrays, which go straight into the
projection gradients,

    dln1 = dq Wq + dk Wk + dv Wv,    dW_part = d_part^T ln1,    dqkvb = sum d_part,

so the packed dqkv is never built; only the weight gradient is assembled.
Under rope the op saves the UNROTATED qkv: the kernels rotate q and k as
they load them, in the forward and again in the backward, and return dq and
dk already rotated back, so the projection backward never sees a rotation.
window > 0 is the causal band, skipped tile by tile in the kernels.
Under GQA this is the JAX op's GQA-native branch (its "small projection");
its expanded-weight MHA branch, which the JAX package takes for geometries
its GQA kernels do not tile, computes the same function and is not needed
here: the port's K3 takes any kv_heads dividing num_heads.

The weight arrives in its storage dtype (the fp32 master during training)
and is cast to the activations' dtype inside the op, as the JAX op's
`linear` does: so dqkvw and dqkvb come back in the storage dtype.  As in
the JAX op (`preferred_element_type=float32`), dqkvw is the fp32 product
of the compute-dtype operands, never rounded to bf16, and dqkvb is summed
in fp32.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import basic
from . import flash_attention as FA
from . import flash_attention_gqa as FG

_HALF = (torch.bfloat16, torch.float16)


def matmul_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (2-D) accumulated and returned in fp32, whatever the operands'
    dtype.  Half-precision operands on CUDA go to cuBLAS with an fp32
    output; elsewhere they are widened first, which is exact (a product of
    two bf16 or fp16 values fits in fp32's mantissa)."""
    if a.is_cuda and a.dtype in _HALF and b.dtype == a.dtype:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def qkv_projection_bwd(dq: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor,
                       ln1: torch.Tensor, qkvw: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of y = ln1 [Wq|Wk|Wv]^T + b given the three parts' output
    grads: (dln1 in ln1's dtype, dqkvw fp32, dqkvb fp32).  qkvw is the
    weight in ln1's dtype, as the forward used it; the caller casts the
    fp32 grads to its storage dtype.  Part widths come from the grads
    themselves (dk and dv are kv_dim wide under GQA)."""
    C = ln1.shape[-1]
    Cq, Ck = dq.shape[-1], dk.shape[-1]
    Wq, Wk, Wv = qkvw[:Cq], qkvw[Cq:Cq + Ck], qkvw[Cq + Ck:]
    dln1 = (basic.linear(dq, Wq.t()) + basic.linear(dk, Wk.t())
            + basic.linear(dv, Wv.t()))
    x = ln1.reshape(-1, C)

    def dW(g):
        return matmul_fp32(g.reshape(-1, g.shape[-1]).t(), x)

    dqkvw = torch.cat([dW(dq), dW(dk), dW(dv)], dim=0)
    red = tuple(range(dq.dim() - 1))
    dqkvb = torch.cat([g.float().sum(dim=red) for g in (dq, dk, dv)])
    return dln1, dqkvw, dqkvb


class _QKVAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ln1, qkvw, qkvb, num_heads, kv_heads, causal, window,
                rope):
        w = qkvw.to(ln1.dtype)
        qkv = basic.linear(ln1, w, qkvb.to(ln1.dtype))
        if kv_heads == num_heads:
            out, lse = FA.flash_attention_fwd(qkv, num_heads, causal,
                                              window=window, rope=rope)
        else:
            out, lse = FG.flash_gqa_attention_fwd(qkv, num_heads, kv_heads,
                                                  causal, window=window,
                                                  rope=rope)
        ctx.save_for_backward(ln1, w, qkv, out, lse)
        ctx.args = (num_heads, kv_heads, causal, window, rope)
        ctx.dtypes = (qkvw.dtype, qkvb.dtype)
        return out

    @staticmethod
    def backward(ctx, do):
        ln1, w, qkv, out, lse = ctx.saved_tensors
        num_heads, kv_heads, causal, window, rope = ctx.args
        if kv_heads == num_heads:
            dq, dk, dv = FA.flash_attention_bwd(qkv, out, lse, do.contiguous(),
                                                num_heads, causal,
                                                window=window, rope=rope)
        else:
            dq, dk, dv = FG.flash_gqa_attention_bwd(
                qkv, out, lse, do.contiguous(), num_heads, kv_heads, causal,
                window=window, rope=rope)
        dln1, dqkvw, dqkvb = qkv_projection_bwd(dq, dk, dv, ln1, w)
        w_dtype, b_dtype = ctx.dtypes
        return (dln1.to(ln1.dtype), dqkvw.to(w_dtype), dqkvb.to(b_dtype),
                None, None, None, None, None)


def qkv_attention(ln1: torch.Tensor, qkvw: torch.Tensor, qkvb: torch.Tensor,
                  num_heads: int, causal: bool = False, window: int = 0,
                  rope: bool = False, kv_heads: int = 0) -> torch.Tensor:
    """(B, T, C) -> (B, T, C): packed qkv projection + flash attention,
    differentiable in ln1, qkvw and qkvb.  kv_heads > 0 (GQA/MQA) takes the
    small (C + 2*kv_dim, C) weight; 0 means num_heads.  window > 0 (causal
    only) is the sliding-window band; rope rotates q and k at positions
    0..T-1 inside the kernels."""
    return _QKVAttention.apply(ln1, qkvw, qkvb, num_heads,
                               kv_heads or num_heads, causal, window, rope)
