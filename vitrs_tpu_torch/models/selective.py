"""Selective activation rematerialisation: the port of
`vitrs_tpu/models/selective.py`.

The blanket recompute (`remat="full"`: `torch.utils.checkpoint` around the
whole block) redoes everything in the backward, flash attention included.
The selective policy keeps what is dear to recompute and recomputes what is
cheap, as the reference's own stash does (the attention probabilities and
the LayerNorm statistics):

  saved a layer:    the block input x, the flash `out` and its compact fp32
                    lse (B, NH, T), the LN mean and rstd of both norms, and
                    the MLP branch's input
  recomputed:       ln1 and ln2 from the saved statistics, the qkv
                    projection, fc and GELU

so the backward runs K2 (K3-bwd under GQA) from the saved out and lse and
never K1-fwd again, and a layer keeps about 3 (B, T, C) activations where
the plain path keeps about 15.

`attn_branch` and `mlp_branch` are autograd.Functions whose backwards do,
op for op, what autograd does for the plain block (models/model._block):
the same matmuls in the same layouts and dtypes, the fused op's
`qkv_projection_bwd`, the same LayerNorm and GELU backwards.  So on one
device the two paths give the same gradients up to the order of a few
reductions.  The JAX branches instead form the weight gradients as fp32
products; they agree at fp32, and the bf16 plain path is the one the
port's selective path is held to.

On the flash route (`ops/attention.supports`, `cfg.use_flash`) the branch
is the Function; elsewhere (dense attention) it is the plain branch under
`torch.utils.checkpoint`, a full recompute, as the JAX package falls back
to replaying `jax.vjp` of its dense branch.  The MoE half of
`block_moe_selective` runs under `torch.utils.checkpoint` as the JAX
package wraps it in `jax.checkpoint`: its dispatch buffers and expert
activations are recomputed, and the router, a stable sort, gives the same
dispatch again.  Stochastic depth composes outside the branches, from the
keep flags drawn before the forward (`model.draw_masks`), so a recomputed
branch sees the same flags.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..config import ViTConfig
from ..ops import basic
from ..ops import flash_attention as FA
from ..ops import flash_attention_gqa as FG
from ..ops.attention import supports as flash_supports
from ..ops.fused_qkv_attention import qkv_projection_bwd

ATTN_KEYS = ("ln1w", "ln1b", "qkvw", "qkvb", "attprojw", "attprojb")
MLP_KEYS = ("ln2w", "ln2b", "fcw", "fcb", "fcprojw", "fcprojb")


def _norm_from_stats(x, w, b, mean, rstd):
    """The LN output from saved fp32 statistics: `basic.layernorm`'s
    formula, so the same bits."""
    xf = x.float()
    out = (xf - mean[..., None]) * rstd[..., None] * w.float() + b.float()
    return out.to(x.dtype)


def _linear_bwd(dy, x, w, with_bias):
    """(dx, dw, db) of y = x @ w.T (+ b), as autograd takes them for
    `basic.linear` with a contiguous w: dx = dy @ w, dw = dy^T x (the
    products autograd's mm backward forms for a transposed weight), db =
    dy summed over the leading axes, all in dy's dtype."""
    dx = torch.matmul(dy, w)
    x2, dy2 = x.reshape(-1, x.shape[-1]), dy.reshape(-1, dy.shape[-1])
    dw = torch.mm(dy2.t(), x2)
    db = dy.sum(dim=tuple(range(dy.dim() - 1))) if with_bias else None
    return dx, dw, db


def _project(ln1, qkvw, qkvb):
    """The packed qkv projection as the fused op runs it: the weight and
    bias cast to the activations' dtype (returns (qkv, the cast weight))."""
    w = qkvw.to(ln1.dtype)
    return basic.linear(ln1, w, qkvb.to(ln1.dtype)), w


class _AttnBranch(torch.autograd.Function):
    """x -> attproj(flash(qkv(ln1(x)))), saving x, out, lse, mean, rstd."""

    @staticmethod
    def forward(ctx, x, ln1w, ln1b, qkvw, qkvb, attprojw, attprojb,
                num_heads, kv_heads, causal, window, rope):
        ln1, mean, rstd = basic.layernorm(x, ln1w, ln1b)
        qkv, _ = _project(ln1, qkvw, qkvb)
        if kv_heads == num_heads:
            out, lse = FA.flash_attention_fwd(qkv, num_heads, causal,
                                              window=window, rope=rope)
        else:
            out, lse = FG.flash_gqa_attention_fwd(qkv, num_heads, kv_heads,
                                                  causal, window=window,
                                                  rope=rope)
        ctx.save_for_backward(x, ln1w, ln1b, qkvw, qkvb, attprojw, mean,
                              rstd, out, lse)
        ctx.args = (num_heads, kv_heads, causal, window, rope)
        return basic.linear(out, attprojw, attprojb)

    @staticmethod
    def backward(ctx, db):
        (x, ln1w, ln1b, qkvw, qkvb, attprojw, mean, rstd, out,
         lse) = ctx.saved_tensors
        num_heads, kv_heads, causal, window, rope = ctx.args
        # recompute ln1 and the packed qkv: the only matmul redone
        ln1 = _norm_from_stats(x, ln1w, ln1b, mean, rstd)
        qkv, w = _project(ln1, qkvw, qkvb)
        datty, dattprojw, dattprojb = _linear_bwd(db, out, attprojw, True)
        # the flash backward from the saved (out, lse): no K1-fwd re-run
        do = datty.contiguous()
        if kv_heads == num_heads:
            dq, dk, dv = FA.flash_attention_bwd(qkv, out, lse, do, num_heads,
                                                causal, window=window,
                                                rope=rope)
        else:
            dq, dk, dv = FG.flash_gqa_attention_bwd(
                qkv, out, lse, do, num_heads, kv_heads, causal,
                window=window, rope=rope)
        dln1, dqkvw, dqkvb = qkv_projection_bwd(dq, dk, dv, ln1, w)
        dx, dln1w, dln1b = basic.layernorm_bwd_from_stats(
            x, ln1w, mean, rstd, dln1.to(ln1.dtype))
        return (dx, dln1w, dln1b, dqkvw.to(qkvw.dtype), dqkvb.to(qkvb.dtype),
                dattprojw, dattprojb, None, None, None, None, None)


def attn_branch(x: torch.Tensor, p: Mapping[str, torch.Tensor],
                cfg: ViTConfig, causal: bool) -> torch.Tensor:
    """The pre-LN attention residual branch with lean saved state (p: one
    layer's params as `model.train_params` gives them)."""
    if cfg.use_flash and flash_supports(cfg.num_heads, cfg.head_size,
                                        cfg.kv_heads, cfg.pos_emb == "rope"):
        return _AttnBranch.apply(x, *(p[k] for k in ATTN_KEYS),
                                 cfg.num_heads, cfg.kv_heads, causal,
                                 cfg.window, cfg.pos_emb == "rope")
    from .model import _attn_branch
    return checkpoint(_attn_branch, x, p, cfg, causal, use_reentrant=False,
                      preserve_rng_state=False)


class _MlpBranch(torch.autograd.Function):
    """x -> fcproj(gelu(fc(ln2(x)))), saving x, mean, rstd."""

    @staticmethod
    def forward(ctx, x, ln2w, ln2b, fcw, fcb, fcprojw, fcprojb, erf):
        ln2, mean, rstd = basic.layernorm(x, ln2w, ln2b)
        h = basic.linear(ln2, fcw, fcb)
        g = basic.gelu_fwd_op(h, erf)
        ctx.save_for_backward(x, ln2w, ln2b, fcw, fcb, fcprojw, mean, rstd)
        ctx.erf = erf
        return basic.linear(g, fcprojw, fcprojb)

    @staticmethod
    def backward(ctx, db):
        x, ln2w, ln2b, fcw, fcb, fcprojw, mean, rstd = ctx.saved_tensors
        ln2 = _norm_from_stats(x, ln2w, ln2b, mean, rstd)
        h = basic.linear(ln2, fcw, fcb)
        g = basic.gelu_fwd_op(h, ctx.erf)
        dg, dfcprojw, dfcprojb = _linear_bwd(db, g, fcprojw, True)
        dh = basic.gelu_bwd_op(h, dg.contiguous(), ctx.erf)
        dln2, dfcw, dfcb = _linear_bwd(dh, ln2, fcw, True)
        dx, dln2w, dln2b = basic.layernorm_bwd_from_stats(x, ln2w, mean, rstd,
                                                          dln2)
        return dx, dln2w, dln2b, dfcw, dfcb, dfcprojw, dfcprojb, None


def mlp_branch(x: torch.Tensor, p: Mapping[str, torch.Tensor],
               cfg: ViTConfig) -> torch.Tensor:
    """The pre-LN MLP residual branch; saves only (x, mean, rstd) and
    recomputes fc and GELU in the backward."""
    return _MlpBranch.apply(x, *(p[k] for k in MLP_KEYS),
                            cfg.act == "gelu_erf")


def block_selective(x: torch.Tensor, p: Mapping[str, torch.Tensor],
                    cfg: ViTConfig, causal: bool,
                    keep: Optional[torch.Tensor] = None,
                    rate: float = 0.0) -> torch.Tensor:
    """`model._block` with the lean branches: the same function."""
    from .model import _drop_path
    a = attn_branch(x, p, cfg, causal)
    if keep is not None:
        a = _drop_path(a, keep[0], rate)
    x = x + a
    b = mlp_branch(x, p, cfg)
    if keep is not None:
        b = _drop_path(b, keep[1], rate)
    return x + b


def block_moe_selective(x: torch.Tensor, p: Mapping[str, torch.Tensor],
                        cfg: ViTConfig, causal: bool,
                        keep: Optional[torch.Tensor] = None,
                        rate: float = 0.0, ep_group=None):
    """`model._block_moe` under the selective policy: the lean attention
    branch, then the MoE half (ln2, router, experts, the weighted router
    loss; its all-to-all hops under expert parallelism) under
    `torch.utils.checkpoint`.  Returns (x, weighted aux)."""
    from .model import _drop_path, _moe_half
    a = attn_branch(x, p, cfg, causal)
    if keep is not None:
        a = _drop_path(a, keep[0], rate)
    x = x + a
    out, aux = checkpoint(_moe_half, x, p, cfg, ep_group,
                          use_reentrant=False, preserve_rng_state=False)
    if keep is not None:
        out = _drop_path(out, keep[1], rate)
    return x + out, aux
