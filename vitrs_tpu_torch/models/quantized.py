"""int8 inference forwards — the port of `vitrs_tpu/models/quantized.py`.

The float forwards of models/model.py with every matmul through
`model.plin`, which picks the quantized linear of ops/quant.py: weight-only
(`w8a8=False`) or dynamic int8 activations (`w8a8=True`).  LayerNorm,
GELU, the residuals and the attention stay in cfg.dtype, and attention is
ops/attention.attention, so on the card it runs K1-fwd: non-causal at
T=197 for a ViT, causal for GPT.  The ViT classifier head stays
weight-only under w8a8, as in the JAX package.

qparams: `quant.quantize_params` of the canonical tensors (or that dict
through `model.prepare_params`, which casts the biases once and pads the
int8 output channels once); the biases are cast to the activation dtype
where they are used.  Like the JAX functions, these forwards compute MHA
attention with learned positions over the whole sequence: a GQA, rope,
windowed or MoE config raises.
"""

from __future__ import annotations

from typing import Mapping

import torch

from ..config import ViTConfig
from ..ops import basic
from ..ops.attention import attention
from .model import plin

QBLOCK_KEYS = ("ln1w", "ln1b", "qkvw", "qkvw_scale", "qkvb",
               "attprojw", "attprojw_scale", "attprojb",
               "ln2w", "ln2b", "fcw", "fcw_scale", "fcb",
               "fcprojw", "fcprojw_scale", "fcprojb")


def _check(cfg: ViTConfig) -> None:
    if (cfg.kv_heads != cfg.num_heads or cfg.pos_emb == "rope"
            or cfg.window or cfg.is_moe or cfg.quirks):
        raise ValueError("the int8 forwards take MHA attention with learned "
                         "positions and a dense MLP, as the JAX package's "
                         "do: no GQA, rope, window, MoE or quirks")


def _qblock(x: torch.Tensor, p: Mapping[str, torch.Tensor], cfg: ViTConfig,
            causal: bool, w8a8: bool) -> torch.Tensor:
    ln1 = basic.layernorm_cv(x, p["ln1w"], p["ln1b"])
    qkv = plin(p, "qkvw", "qkvb", ln1, w8a8)
    atty = attention(qkv, cfg.num_heads, causal=causal,
                     use_flash=cfg.use_flash)
    x = x + plin(p, "attprojw", "attprojb", atty, w8a8)
    ln2 = basic.layernorm_cv(x, p["ln2w"], p["ln2b"])
    fch = basic.gelu_cv(plin(p, "fcw", "fcb", ln2, w8a8))
    return x + plin(p, "fcprojw", "fcprojb", fch, w8a8)


def _qtransformer(x: torch.Tensor, qparams: Mapping[str, torch.Tensor],
                  cfg: ViTConfig, causal: bool, w8a8: bool) -> torch.Tensor:
    for i in range(cfg.num_layers):
        x = _qblock(x, {k: qparams[k][i] for k in QBLOCK_KEYS}, cfg, causal,
                    w8a8)
    return x


def vit_forward_q(qparams: Mapping[str, torch.Tensor], images: torch.Tensor,
                  cfg: ViTConfig, w8a8: bool = True) -> torch.Tensor:
    """The quantized twin of `model.vit_forward`: (B, H, W, C) images ->
    class logits (B, NC) in fp32."""
    _check(cfg)
    dtype = getattr(torch, cfg.dtype)
    patches = basic.patchify(images, cfg.patch_size).to(dtype)
    x = plin(qparams, "patchw", "patchb", patches, w8a8)
    n_prefix = 1 if cfg.pool == "cls" else 0
    x = x + qparams["wpe"][n_prefix:n_prefix + x.shape[1]].to(dtype)
    if cfg.pool == "cls":
        cls = (qparams["cls"] + qparams["wpe"][None, :1]).to(dtype)
        x = torch.cat([cls.expand(x.shape[0], 1, x.shape[2]), x], dim=1)
    x = _qtransformer(x, qparams, cfg, causal=False, w8a8=w8a8)
    lnf = basic.layernorm_cv(x, qparams["lnfw"], qparams["lnfb"])
    pooled = lnf[:, 0] if cfg.pool == "cls" else lnf.mean(dim=1)
    # the classifier head is weight-only in both modes: it is small, and
    # its error feeds the argmax directly
    return plin(qparams, "headw", "headb", pooled).float()


def gpt_forward_q(qparams: Mapping[str, torch.Tensor], tokens: torch.Tensor,
                  cfg: ViTConfig, w8a8: bool = False) -> torch.Tensor:
    """The quantized twin of `model.gpt_forward`: tokens (B, T) -> logits
    (B, T, V) in cfg.dtype.  The embedding dequantizes only the gathered
    rows of the int8 wte, which is also the tied head."""
    _check(cfg)
    dtype = getattr(torch, cfg.dtype)
    T = tokens.shape[-1]
    emb = (qparams["wte"][tokens].to(dtype)
           * qparams["wte_scale"][tokens][..., None].to(dtype))
    x = emb + qparams["wpe"][None, :T].to(dtype)
    x = _qtransformer(x, qparams, cfg, causal=True, w8a8=w8a8)
    lnf = basic.layernorm_cv(x, qparams["lnfw"], qparams["lnfb"])
    return plin(qparams, "wte", None, lnf, w8a8)
