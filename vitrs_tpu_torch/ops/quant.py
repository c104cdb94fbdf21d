"""int8 post-training quantization for inference and serving — the port of
`vitrs_tpu/ops/quant.py`.

Two modes, with symmetric per-out-channel weight scales (scale = amax/127,
no zero point):

* weight-only (`linear_w8`): int8 weights and fp32 scales, dequantized to
  the activation dtype before the product; the matmul runs in that dtype.
  It halves the weight bytes a decode step reads against bf16.
* dynamic w8a8 (`linear_w8a8`): each row of the activations is quantized
  to int8 with its own absmax scale, and the int8 x int8 -> int32 product
  runs on the int8 tensor cores through `torch._int_mm` (cuBLASLt), as the
  JAX package leaves its int8 `dot_general` to XLA: no Pallas kernel
  computes it, so no hand-written kernel replaces one.

cuBLASLt takes an int8 product only with more than 16 rows and K and N
multiples of 8.  `int8_matmul` pads the rows, the contraction and the
output channels with zeros (a decode step's few rows) and slices the
result, on every device, so the CPU runs the same shapes as the card; the
zeros add nothing to any sum, so the product is the unpadded one.  There is
no float fallback.  A weight's output channels are padded once, where its
dict is prepared (`pad_out_channels`, from `model.prepare_params`: the GPT
head's N = 50257), and the linears read a weight's true N from the length
of its scale, so a product copies no weight.

The order of operations is the JAX package's: `wq * scale` in the
activation dtype before the product (w8); `acc * ax * scale` in fp32 after
it (w8a8).  `torch.round` rounds half to even, as `jnp.round` does.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

# the weight leaves each mode quantizes; LN, biases, wpe and the CLS token
# stay in their dtype (vitrs_tpu/ops/quant.py:37-38)
_QUANT_KEYS_GPT = ("qkvw", "attprojw", "fcw", "fcprojw", "wte")
_QUANT_KEYS_VIT = ("qkvw", "attprojw", "fcw", "fcprojw", "patchw", "headw")

_MIN_ROWS = 17          # _int_mm on CUDA: more than 16 rows
_ALIGN = 8              # ... and K, N multiples of 8


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., OC, C) -> (int8 of the same shape, fp32 scale (..., OC)):
    scale = amax/127 over the contraction axis (1 for an all-zero row), so
    the weight dequantizes as wq * scale[..., None]."""
    w = w.float()
    amax = w.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    wq = torch.clamp(torch.round(w / scale[..., None]), -127, 127)
    return wq.to(torch.int8), scale


def pad_out_channels(wq: torch.Tensor) -> torch.Tensor:
    """wq (..., OC, C) with zero rows appended up to a multiple of 8 output
    channels (wq itself where OC already is one); its scale keeps OC
    entries, which the linears read as the weight's true N."""
    pad = _round_up(wq.shape[-2], _ALIGN) - wq.shape[-2]
    return F.pad(wq, (0, 0, 0, pad)) if pad else wq


def linear_w8(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
              b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weight-only int8 linear: y = x @ (wq * scale).T (+ b), W (OC, C)
    (rows past OC = len(scale), `pad_out_channels`' zeros, are left out);
    the weight dequantized in x's dtype, the product accumulated in fp32
    and returned in x's dtype, the bias added in x's dtype."""
    wq = wq[..., :scale.shape[-1], :]
    w = wq.to(x.dtype) * scale[..., None].to(x.dtype)
    y = torch.matmul(x, w.t())
    return y if b is None else y + b.to(x.dtype)


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """xq (M, K) int8 @ wq (N, K).T int8 -> (M, N) int32, exact, through
    `torch._int_mm` on operands padded with zeros to M >= 17 rows and K, N
    multiples of 8 (see the module docstring)."""
    M, K = xq.shape
    N = wq.shape[0]
    Mp, Kp, Np = (_round_up(max(M, _MIN_ROWS), _ALIGN),
                  _round_up(K, _ALIGN), _round_up(N, _ALIGN))
    if (Mp, Kp) != (M, K):
        xq = F.pad(xq, (0, Kp - K, 0, Mp - M))
    if (Np, Kp) != (N, K):
        wq = F.pad(wq, (0, Kp - K, 0, Np - N))
    acc = torch._int_mm(xq.contiguous(), wq.contiguous().t())
    return acc[:M, :N]


def linear_w8a8(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dynamic-activation int8 linear: each row of x quantized with its
    own absmax scale ax, then
    y[r, o] = (sum_c xq[r, c] wq[o, c]) * ax[r] * scale[o] (+ b[o])
    for o < OC = len(scale), with exact int32 sums, in fp32, returned in
    x's dtype."""
    xf = x.float()
    ax = xf.abs().amax(dim=-1, keepdim=True)
    ax = torch.where(ax > 0, ax / 127.0, 1.0)
    xq = torch.clamp(torch.round(xf / ax), -127, 127).to(torch.int8)
    N = scale.shape[-1]
    acc = int8_matmul(xq.reshape(-1, x.shape[-1]), wq)[:, :N]
    y = acc.reshape(*x.shape[:-1], N).float() * ax * scale.float()
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def quantize_params(params: Mapping[str, torch.Tensor], mode: str = "vit"
                    ) -> Dict[str, torch.Tensor]:
    """A new dict in which each of the mode's weight leaves `k` is int8
    plus `k + '_scale'` (fp32 per out channel, stacked over L where the
    weight is); every other leaf passes through."""
    keys = _QUANT_KEYS_GPT if mode == "gpt" else _QUANT_KEYS_VIT
    out: Dict[str, torch.Tensor] = {}
    for k, v in params.items():
        if k in keys:
            out[k], out[k + "_scale"] = quantize_weight(v.detach())
        else:
            out[k] = v
    return out


def dequantize_params(qparams: Mapping[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """The inverse of `quantize_params` up to the int8 rounding: fp32
    weights for the float forward (weight-only semantics)."""
    out = {}
    for k, v in qparams.items():
        if k.endswith("_scale"):
            continue
        if k + "_scale" in qparams:
            out[k] = v.float() * qparams[k + "_scale"][..., None].float()
        else:
            out[k] = v
    return out
