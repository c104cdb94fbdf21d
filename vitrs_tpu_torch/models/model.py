"""Transformer forward in GPT mode — the port of the forward half of
`vitrs_tpu/models/model.py`.

The JAX package scans one block body over the stacked-L parameter slabs;
PyTorch runs eagerly, so a Python loop over the layers takes the place of
`lax.scan`, reading layer l as views `params[key][l]` of the same stacked
tensors.  Forward only, dense MLP only: training, ViT mode and MoE come in
later slices (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from ..config import ViTConfig
from ..ops import basic
from ..ops.attention import attention

BLOCK_KEYS = ("ln1w", "ln1b", "qkvw", "qkvb", "attprojw", "attprojb",
              "ln2w", "ln2b", "fcw", "fcb", "fcprojw", "fcprojb")
# the tensors that meet a matmul, cast once to the compute dtype
MATMUL_KEYS = ("qkvw", "qkvb", "attprojw", "attprojb",
               "fcw", "fcb", "fcprojw", "fcprojb")


def check_supported(cfg: ViTConfig) -> None:
    """Raise NotImplementedError for a config this slice of the port does
    not run yet, naming the ROADMAP item that brings it."""
    if cfg.mode != "gpt":
        raise NotImplementedError(
            "vit mode: ROADMAP.md Queue 1 item 5 (models/model.py)")
    if cfg.quirks:
        raise NotImplementedError(
            "quirks=True: ROADMAP.md Queue 1 item 3 (ops/basic.py quirk ops)")
    if cfg.is_moe:
        raise NotImplementedError("MoE MLP: ROADMAP.md Queue 1 item 14")
    if cfg.is_gqa or cfg.window or cfg.pos_emb != "learned":
        raise NotImplementedError(
            "GQA, sliding window and rope: ROADMAP.md Queue 1 item 12")


def prepare_params(params: Mapping[str, torch.Tensor], cfg: ViTConfig
                   ) -> Dict[str, torch.Tensor]:
    """The dict every forward path reads, built once per model or engine.

    The tensors stay on their device and leave autograd.  The matmul
    weights and biases are cast once to cfg.dtype, and "head" holds the
    tied head (wte) in cfg.dtype: the JAX
    package casts these on every call, with the same result.  LN params and
    the embedding tables keep their own dtype, because the JAX package
    computes LayerNorm in fp32 and adds the embeddings before its cast."""
    check_supported(cfg)
    dtype = getattr(torch, cfg.dtype)
    out = {k: v.detach() for k, v in params.items()}
    for k in MATMUL_KEYS:
        out[k] = out[k].to(dtype)
    out["head"] = out["wte"].to(dtype)
    return out


def layer(params: Mapping[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    """Layer i's block params: views into the stacked tensors."""
    return {k: params[k][i] for k in BLOCK_KEYS}


def mlp(p: Mapping[str, torch.Tensor], cfg: ViTConfig,
        x: torch.Tensor) -> torch.Tensor:
    """ln2 output -> fc, GELU, fcproj."""
    h = basic.linear(x, p["fcw"], p["fcb"])
    h = basic.gelu_erf(h) if cfg.act == "gelu_erf" else basic.gelu(h)
    return basic.linear(h, p["fcprojw"], p["fcprojb"])


def _block(x: torch.Tensor, p: Mapping[str, torch.Tensor],
           cfg: ViTConfig) -> torch.Tensor:
    """The pre-LN block (rusty_vit.rs:322-331 op order), causal."""
    ln1 = basic.layernorm(x, p["ln1w"], p["ln1b"])[0]
    qkv = basic.linear(ln1, p["qkvw"], p["qkvb"])
    atty = attention(qkv, cfg.num_heads, causal=True)
    x = x + basic.linear(atty, p["attprojw"], p["attprojb"])
    return x + mlp(p, cfg, basic.layernorm(x, p["ln2w"], p["ln2b"])[0])


def gpt_encode(tokens: torch.Tensor, params: Mapping[str, torch.Tensor],
               dtype: torch.dtype) -> torch.Tensor:
    """wte lookup + learned positional embedding, summed in the parameter
    dtype, then cast."""
    T = tokens.shape[-1]
    return (params["wte"][tokens] + params["wpe"][:T][None]).to(dtype)


def gpt_forward(params: Mapping[str, torch.Tensor], tokens: torch.Tensor,
                cfg: ViTConfig) -> torch.Tensor:
    """tokens (B, T) -> logits (B, T, V) in cfg.dtype; params from
    `prepare_params`.  The head is tied to wte, with no bias."""
    x = gpt_encode(tokens, params, getattr(torch, cfg.dtype))
    for i in range(cfg.num_layers):
        x = _block(x, layer(params, i), cfg)
    lnf = basic.layernorm(x, params["lnfw"], params["lnfb"])[0]
    return basic.linear(lnf, params["head"])
