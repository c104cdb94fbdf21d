"""Plain PyTorch forward passes of GPT-2 and ViT: the reference that decides
`correct`.  It imports nothing of the program: it reads the canonical
tensors (`layout.py`) and follows the published models as the port's
configurations state them (pre-LN blocks, LayerNorm at the config's eps,
the GELU the configuration names (GPT-2's tanh form, ViT-B/16's exact erf
form), a tied GPT-2 head without bias, ViT's CLS
token and learned positions, patches in (row, column, channel) order).

Every product goes through `mm`, which computes in fp32 with TF32 off
(`PRECISIONS["fp32"]`, the reference), or, for the control, with both
operands rounded to fp8 e4m3 under a per-tensor scale first
(`PRECISIONS["fp8"]`: the precision a later change would be tempted to
take below the configuration's bf16).  The rounding is a straight-through
one: the backward flows through it as through the identity, so the
gradient's products use the rounded operands.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

E4M3_MAX = 448.0


def fp32_exact():
    """TF32 off for every fp32 product of the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(t: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        scale = t.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
        q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t).detach()


PRECISIONS = {"fp32": lambda t: t, "fp8": _fp8}


class Ref:
    """The reference at one precision: `mm(a, w)` is a @ w^T."""

    def __init__(self, s, precision: str = "fp32"):
        self.s = s
        self.round = PRECISIONS[precision]

    def mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.round(a), self.round(w).transpose(-1, -2))

    def linear(self, x, w, b=None):
        y = self.mm(x, w)
        return y if b is None else y + b

    def ln(self, x, w, b):
        return torch.nn.functional.layer_norm(x, (x.shape[-1],), w, b,
                                              self.s.ln_eps)

    def gelu(self, x):
        if self.s.act == "gelu_erf":
            return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))
        return 0.5 * x * (1.0 + torch.tanh(
            math.sqrt(2.0 / math.pi) * (x + 0.044715 * x * x * x)))

    def attention(self, q, k, v, causal: bool):
        """q, k, v (B, H, T, D) -> (B, H, T, D)."""
        T = q.shape[-2]
        scores = self.mm(q, k) * (1.0 / math.sqrt(q.shape[-1]))
        if causal:
            mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
            scores = scores.masked_fill(~mask, -math.inf)
        att = torch.softmax(scores, dim=-1)
        return self.mm(att, v.transpose(-1, -2))

    def block(self, x, w, i: int, causal: bool,
              kv: Optional[List] = None):
        s = self.s
        B, T, C = x.shape
        NH, D = s.num_heads, s.head_size
        h = self.ln(x, w["ln1w"][i], w["ln1b"][i])
        qkvw, qkvb = w["qkvw"][i], w["qkvb"][i]
        q, k, v = (self.linear(h, qkvw[j * C:(j + 1) * C],
                               qkvb[j * C:(j + 1) * C]) for j in range(3))
        if kv is not None:
            kv.append((k.detach(), v.detach()))

        def heads(t):
            return t.reshape(B, T, NH, D).transpose(1, 2)

        y = self.attention(heads(q), heads(k), heads(v), causal)
        y = y.transpose(1, 2).reshape(B, T, C)
        x = x + self.linear(y, w["attprojw"][i], w["attprojb"][i])
        h = self.ln(x, w["ln2w"][i], w["ln2b"][i])
        h = self.gelu(self.linear(h, w["fcw"][i], w["fcb"][i]))
        return x + self.linear(h, w["fcprojw"][i], w["fcprojb"][i])

    # -- GPT-2 ---------------------------------------------------------------

    def gpt_hidden(self, w, tokens: torch.Tensor,
                   kv: Optional[List] = None) -> torch.Tensor:
        """tokens (B, T) -> the final LayerNorm's output (B, T, C); kv, a
        list, receives each layer's (K, V) as (B, T, C)."""
        T = tokens.shape[-1]
        x = w["wte"][tokens] + w["wpe"][:T][None]
        for i in range(self.s.num_layers):
            x = self.block(x, w, i, True, kv)
        return self.ln(x, w["lnfw"], w["lnfb"])

    def gpt_logits(self, w, hidden: torch.Tensor) -> torch.Tensor:
        return self.mm(hidden, w["wte"])

    # -- ViT ---------------------------------------------------------------

    def vit_logits(self, w, images: torch.Tensor, mean, std) -> torch.Tensor:
        """uint8 images (B, H, W, C) -> class logits (B, classes): the
        normalisation ((x / 255 - mean) / std), patches in (row, column,
        channel) order, the patch embedding, positions, the CLS token."""
        s = self.s
        x = images.float() / 255.0
        x = (x - torch.as_tensor(mean, device=x.device)) \
            / torch.as_tensor(std, device=x.device)
        B, Hh, Ww, Cc = x.shape
        P = s.patch_size
        x = x.reshape(B, Hh // P, P, Ww // P, P, Cc).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, (Hh // P) * (Ww // P), P * P * Cc)
        x = self.linear(x, w["patchw"], w["patchb"]) + w["wpe"][1:][None]
        cls = (w["cls"] + w["wpe"][None, :1]).expand(B, 1, s.channels)
        x = torch.cat([cls, x], dim=1)
        for i in range(s.num_layers):
            x = self.block(x, w, i, False)
        x = self.ln(x, w["lnfw"], w["lnfb"])
        return self.linear(x[:, 0], w["headw"], w["headb"])


def ce_sum(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Summed cross-entropy over the rows."""
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]).float(), targets.reshape(-1),
        reduction="sum")


def to_device(tensors: Dict[str, torch.Tensor], device
              ) -> Dict[str, torch.Tensor]:
    return {k: t.to(device, torch.float32) for k, t in tensors.items()}


KV = List[Tuple[torch.Tensor, torch.Tensor]]


def gpt_served(ref: Ref, w, prompt: torch.Tensor) -> Tuple[torch.Tensor, KV]:
    """One prompt (T0,) -> (the logits at its last position (V,), each
    layer's (K, V) (T0, C))."""
    kv: List = []
    with torch.no_grad():
        h = ref.gpt_hidden(w, prompt[None], kv)
        logits = ref.gpt_logits(w, h[0, -1:])[0]
    return logits, [(k[0], v[0]) for k, v in kv]
