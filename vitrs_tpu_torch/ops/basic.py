"""Core ops — the port of `vitrs_tpu/ops/basic.py`.

Plain functions on tensors, with the JAX package's dtype rules: LayerNorm
statistics in fp32, tanh-GELU in the input dtype, linear with an fp32
accumulator and an output in the input dtype.  The matmuls are left to
torch.matmul (cuBLAS on the card), as the JAX package left them to XLA.
`patchify` / `unpatchify` are vit mode's layout-only patch extraction, with
the JAX package's element order inside a patch (row, column, channel).

The JAX package's custom-VJP ops (`layernorm_cv`, `gelu_cv`,
`gelu_erf_cv`) are autograd.Functions here with the same saved tensors and
the same hand-written backward; everything else differentiates through
PyTorch's autograd, as it does through jax.grad there.  GELU's two
directions are the ops `vitrs::gelu_fwd` / `vitrs::gelu_bwd`: on the card
one hand-written kernel each (`ops/fused_gelu.py`), on the CPU the plain
functions of this module.

The quirk ops reproduce the reference's math as written (quirks=True):
G5, the causal softmax leaves a token's own weight unnormalised; G11, the
row max starts at -1e4 (`QUIRK_MAX_INIT`), not -inf; G6, the loss is the
negated probability, no log (`cross_entropy_quirk`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..utils import trace
from . import _build, fused_gelu

LN_EPS = 1e-5
GELU_COEF = 0.044715
INV_SQRT2 = 0.7071067811865476
INV_SQRT_2PI = 0.3989422804014327
QUIRK_MAX_INIT = -10000.0    # rusty_vit.rs:524,640 (gap G11)


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


def layernorm_bwd_from_stats(x: torch.Tensor, w: torch.Tensor,
                             mean: torch.Tensor, rstd: torch.Tensor,
                             dout: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LN backward from the saved (mean, rstd), in fp32: (dx in x's dtype,
    dw and db in w's dtype), reduced over every leading axis."""
    xf, df = x.float(), dout.float()
    norm = (xf - mean[..., None]) * rstd[..., None]
    dnorm = df * w.float()
    red = tuple(range(dout.dim() - 1))
    db = df.sum(dim=red)
    dw = (norm * df).sum(dim=red)
    dnorm_mean = dnorm.mean(dim=-1, keepdim=True)
    dnorm_norm_mean = (dnorm * norm).mean(dim=-1, keepdim=True)
    dx = (dnorm - dnorm_mean - norm * dnorm_norm_mean) * rstd[..., None]
    return dx.to(x.dtype), dw.to(w.dtype), db.to(w.dtype)


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        with trace.span("op.layernorm"):
            out, mean, rstd = layernorm(x, w, b)
        ctx.save_for_backward(x, w, mean, rstd)
        return out

    @staticmethod
    def backward(ctx, dout):
        with trace.span("op.layernorm"):
            return layernorm_bwd_from_stats(*ctx.saved_tensors, dout)


def layernorm_cv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """LayerNorm's output with the hand-written backward: saves only
    (x in its own dtype, w, mean, rstd) and recomputes the normalisation."""
    return _LayerNorm.apply(x, w, b)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximation GELU, computed in x's dtype as the JAX op is."""
    s = math.sqrt(2.0 / math.pi)
    cube = GELU_COEF * x * x * x
    return 0.5 * x * (1.0 + torch.tanh(s * (x + cube)))


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU 0.5·x·(1 + erf(x/√2)), in fp32, output in x's dtype."""
    xf = x.float()
    return (0.5 * xf * (1.0 + torch.erf(xf * INV_SQRT2))).to(x.dtype)

def gelu_grad_local(xf: torch.Tensor) -> torch.Tensor:
    """d gelu(x)/dx in fp32 (the analytic tanh-GELU gradient)."""
    s = math.sqrt(2.0 / math.pi)
    t = torch.tanh(s * (xf + GELU_COEF * xf * xf * xf))
    sech2 = 1.0 - t * t
    return 0.5 * (1.0 + t) + xf * 0.5 * sech2 * s * (1.0 + 3.0 * GELU_COEF * xf * xf)


def gelu_erf_grad_local(xf: torch.Tensor) -> torch.Tensor:
    """d gelu_erf(x)/dx in fp32: Phi(x) + x phi(x)."""
    cdf = 0.5 * (1.0 + torch.erf(xf * INV_SQRT2))
    pdf = INV_SQRT_2PI * torch.exp(-0.5 * xf * xf)
    return cdf + xf * pdf


def gelu_fwd_plain(x: torch.Tensor, erf: bool) -> torch.Tensor:
    """`vitrs::gelu_fwd` in plain PyTorch: `gelu_erf` or `gelu`."""
    return gelu_erf(x) if erf else gelu(x)


def gelu_bwd_plain(x: torch.Tensor, dy: torch.Tensor,
                   erf: bool) -> torch.Tensor:
    """`vitrs::gelu_bwd` in plain PyTorch: dx at x in fp32, rounded once to
    x's dtype."""
    local = (gelu_erf_grad_local if erf else gelu_grad_local)(x.float())
    return (local * dy.float()).to(x.dtype)


gelu_fwd_op = _build.kernel_op(
    "gelu_fwd", "(Tensor x, bool erf) -> Tensor",
    lambda *a: gelu_fwd_plain(*a), lambda *a: fused_gelu.gelu_fwd_cuda(*a),
    lambda x, erf: x.new_empty(x.shape))

gelu_bwd_op = _build.kernel_op(
    "gelu_bwd", "(Tensor x, Tensor dy, bool erf) -> Tensor",
    lambda *a: gelu_bwd_plain(*a), lambda *a: fused_gelu.gelu_bwd_cuda(*a),
    lambda x, dy, erf: x.new_empty(x.shape))


class _Gelu(torch.autograd.Function):
    """GELU saving only its input; the gradient is recomputed in fp32.  Both
    directions are the ops above: one kernel on the card, the plain
    functions on the CPU."""

    @staticmethod
    def forward(ctx, x, erf):
        x = x.contiguous()
        ctx.save_for_backward(x)
        ctx.erf = erf
        with trace.span("op.gelu"):
            return gelu_fwd_op(x, erf)

    @staticmethod
    def backward(ctx, dout):
        (x,) = ctx.saved_tensors
        with trace.span("op.gelu"):
            return gelu_bwd_op(x, dout.contiguous(), ctx.erf), None


def gelu_cv(x: torch.Tensor) -> torch.Tensor:
    """tanh-GELU with the hand-written backward (the JAX `gelu_cv`)."""
    return _Gelu.apply(x, False)


def gelu_erf_cv(x: torch.Tensor) -> torch.Tensor:
    """erf-GELU with the hand-written backward (the JAX `gelu_erf_cv`)."""
    return _Gelu.apply(x, True)


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


def attention_dense(qkv: torch.Tensor, num_heads: int, causal: bool = True,
                    window: int = 0, quirks: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materialised multi-head attention over packed qkv (B, T, 3C).

    Returns (out (B, T, C), att (B, NH, T, T) fp32) like the JAX op.
    window > 0 (causal only) is sliding-window attention: query t sees keys
    in (t - window, t].  Scores and the softmax in fp32; the probabilities
    round to v's dtype before the product with V.  quirks=True is the
    reference's softmax as written, step by step as in the JAX op: the row
    max floored at -1e4 (G11), the expsum == 0 guard, and under causal the
    diagonal's weight left unnormalised (G5); gradients reach the row max
    through the diagonal, as under jax.grad."""
    if window and not causal:
        raise ValueError("sliding-window attention is causal-only")
    B, T, C3 = qkv.shape
    C = C3 // 3
    D = C // num_heads

    def heads(t):
        return t.reshape(B, T, num_heads, D).transpose(1, 2).float()

    q, k, v = (heads(t) for t in qkv.split(C, dim=-1))
    scores = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(D))
    if causal:
        mask = torch.ones(T, T, dtype=torch.bool, device=qkv.device).tril()
        if window:
            mask = mask & ~mask.tril(-window)
        scores = scores.masked_fill(~mask, -math.inf)
    if quirks:
        m = torch.maximum(scores.amax(dim=-1, keepdim=True),
                          scores.new_tensor(QUIRK_MAX_INIT))
        e = torch.exp(scores - m)
        if causal:
            e = torch.where(mask, e, 0.0)
        s = e.sum(dim=-1, keepdim=True)
        att = e * torch.where(s == 0.0, 0.0, 1.0 / s)
        if causal:
            eye = torch.eye(T, dtype=torch.bool, device=qkv.device)
            att = torch.where(eye, e, att)
    else:
        att = torch.softmax(scores, dim=-1)
    out = torch.matmul(att.to(qkv.dtype).float(), v).to(qkv.dtype)
    return out.transpose(1, 2).reshape(B, T, C), att


def softmax(logits: torch.Tensor, quirks: bool = False) -> torch.Tensor:
    """Row softmax with max subtraction (rusty_vit.rs:634-658); quirks
    floors the max at -1e4 (G11)."""
    m = logits.amax(dim=-1, keepdim=True)
    if quirks:
        m = torch.maximum(m, m.new_tensor(QUIRK_MAX_INIT))
    e = torch.exp(logits - m)
    return e / e.sum(dim=-1, keepdim=True)


def cross_entropy_from_logits(logits: torch.Tensor,
                              targets: torch.Tensor) -> torch.Tensor:
    """-log softmax(logits)[target] per row, in fp32."""
    lf = logits.float()
    picked = lf.gather(-1, targets.long()[..., None])[..., 0]
    return torch.logsumexp(lf, dim=-1) - picked


def cross_entropy_smoothed(logits: torch.Tensor, targets: torch.Tensor,
                           smoothing: float = 0.1) -> torch.Tensor:
    """Label-smoothed CE: (1 - s) CE(target) + s mean-over-classes CE."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    return (1.0 - smoothing) * nll + smoothing * -logp.mean(dim=-1)


def cross_entropy_quirk(probs: torch.Tensor,
                        targets: torch.Tensor) -> torch.Tensor:
    """G6: the reference negates the raw probability of the target (no
    log)."""
    return -probs.gather(-1, targets.long()[..., None])[..., 0]


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, N, P*P*C), N = (H/P)(W/P) patches in row-major
    order, each patch's values in (row, column, channel) order: a reshape
    and a transpose, as in the JAX op, so the patch embedding that follows
    is one matmul."""
    B, H, W, C = images.shape
    ph, pw = H // patch, W // patch
    x = images.reshape(B, ph, patch, pw, patch, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, ph * pw, patch * patch * C)


def unpatchify(patches: torch.Tensor, patch: int, img_size: int,
               chans: int = 3) -> torch.Tensor:
    """The inverse of `patchify` for square images: (B, N, P*P*C) ->
    (B, img_size, img_size, chans)."""
    B = patches.shape[0]
    ph = img_size // patch
    x = patches.reshape(B, ph, ph, patch, patch, chans).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, img_size, img_size, chans)
