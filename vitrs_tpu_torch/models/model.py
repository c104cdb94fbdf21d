"""Transformer in GPT mode — the port of `vitrs_tpu/models/model.py`.

The JAX package scans one block body over the stacked-L parameter slabs;
PyTorch runs eagerly, so a Python loop over the layers takes the place of
`lax.scan`, reading layer l as views of the same stacked tensors
(`unbind`, whose backward stacks the layers' gradients in one op).

Two ways in, one block body:
* serving: `prepare_params` once per model, then `gpt_forward`;
* training: `loss_fn` / `gpt_loss` on the fp32 master parameters, which
  casts what meets a matmul to cfg.dtype inside the autograd graph on every
  call (`train_params`), so that gradients reach the fp32 leaves.
The block uses the custom-backward ops of ops/basic.py and, on the flash
path, the fused qkv projection + attention op; the GPT loss pads the tied
head to 50304 columns and runs the fused CE (K5/K6) where the JAX package
would, or, with `fused_head_ce.ENABLE` set, the fused head + CE (K8).
GQA/MQA (cfg.num_kv_heads) projects with the small (C + 2*kv_dim, C)
weight into K3 on the flash path, and expands the weight on the dense path,
as the JAX package does.  Rope (cfg.pos_emb == "rope") rotates q and k
inside the flash kernels and with an explicit `rope_qk` on the dense path;
the wpe table is then not read.  cfg.window is the sliding-window band on
both paths.  ViT mode and MoE come in later slices (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import torch
import torch.nn.functional as F

from ..config import ViTConfig
from ..ops import basic, fused_ce, fused_head_ce
from ..ops.attention import (expand_qkv_weight, rope_packed,
                             supports as flash_supports)
from ..ops.fused_qkv_attention import qkv_attention

BLOCK_KEYS = ("ln1w", "ln1b", "qkvw", "qkvb", "attprojw", "attprojb",
              "ln2w", "ln2b", "fcw", "fcb", "fcprojw", "fcprojb")
# the tensors that meet a matmul, cast to the compute dtype
MATMUL_KEYS = ("qkvw", "qkvb", "attprojw", "attprojb",
               "fcw", "fcb", "fcprojw", "fcprojb")
_VIT = "vit mode: ROADMAP.md Queue 1 item 5 (models/model.py)"


def check_supported(cfg: ViTConfig) -> None:
    """Raise NotImplementedError for a config this slice of the port does
    not run yet, naming the ROADMAP item that brings it."""
    if cfg.mode != "gpt":
        raise NotImplementedError(_VIT)
    if cfg.quirks:
        raise NotImplementedError(
            "quirks=True: ROADMAP.md Queue 1 item 3 (ops/basic.py quirk ops)")
    if cfg.is_moe:
        raise NotImplementedError("MoE MLP: ROADMAP.md Queue 1 item 14")


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


def train_params(params: Mapping[str, torch.Tensor], cfg: ViTConfig
                 ) -> Dict[str, torch.Tensor]:
    """The training counterpart of `prepare_params`, called on every step:
    the fp32 master tensors (which may require grad), with the matmul
    weights and biases cast to cfg.dtype inside the autograd graph, once
    per step per stacked tensor.  qkvw and qkvb stay in their dtype: the
    fused qkv-attention op casts them itself and returns their gradients in
    fp32, as the JAX op does.  No "head": `gpt_loss` builds it from wte."""
    check_supported(cfg)
    dtype = getattr(torch, cfg.dtype)
    out = dict(params)
    for k in MATMUL_KEYS:
        if k not in ("qkvw", "qkvb"):
            out[k] = params[k].to(dtype)
    return out


def layer(params: Mapping[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    """Layer i's block params: views into the stacked tensors."""
    return {k: params[k][i] for k in BLOCK_KEYS}


def layers(params: Mapping[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
    """Every layer's block params, as `layer` gives them, from one unbind
    per stacked tensor."""
    per = {k: params[k].unbind(0) for k in BLOCK_KEYS}
    return [{k: per[k][i] for k in BLOCK_KEYS}
            for i in range(len(per[BLOCK_KEYS[0]]))]


def mlp(p: Mapping[str, torch.Tensor], cfg: ViTConfig,
        x: torch.Tensor) -> torch.Tensor:
    """ln2 output -> fc, GELU, fcproj."""
    h = basic.linear(x, p["fcw"], p["fcb"])
    h = basic.gelu_erf_cv(h) if cfg.act == "gelu_erf" else basic.gelu_cv(h)
    return basic.linear(h, p["fcprojw"], p["fcprojb"])


def _project_and_attend(ln1: torch.Tensor, p: Mapping[str, torch.Tensor],
                        cfg: ViTConfig, causal: bool) -> torch.Tensor:
    """qkv projection + attention: the fused op on the flash path (whose
    backward never builds the packed dqkv; K3 under GQA; rope and the band
    inside the kernels), else the plain composition with dense attention,
    the GQA weight expanded to MHA and q, k rotated explicitly
    (JAX model.py:54-68), as the JAX package routes them."""
    rope = cfg.pos_emb == "rope"
    if cfg.use_flash and flash_supports(cfg.num_heads, cfg.head_size,
                                        cfg.kv_heads):
        return qkv_attention(ln1, p["qkvw"], p["qkvb"], cfg.num_heads, causal,
                             cfg.window, rope, kv_heads=cfg.kv_heads)
    w, b = expand_qkv_weight(p["qkvw"], p["qkvb"], cfg.num_heads,
                             cfg.kv_heads)
    qkv = basic.linear(ln1, w.to(ln1.dtype), b.to(ln1.dtype))
    if rope:
        qkv = rope_packed(qkv, cfg.num_heads)
    return basic.attention_dense(qkv, cfg.num_heads, causal=causal,
                                 window=cfg.window)[0]


def _block(x: torch.Tensor, p: Mapping[str, torch.Tensor],
           cfg: ViTConfig) -> torch.Tensor:
    """The pre-LN block (rusty_vit.rs:322-331 op order), causal."""
    ln1 = basic.layernorm_cv(x, p["ln1w"], p["ln1b"])
    atty = _project_and_attend(ln1, p, cfg, causal=True)
    x = x + basic.linear(atty, p["attprojw"], p["attprojb"])
    return x + mlp(p, cfg, basic.layernorm_cv(x, p["ln2w"], p["ln2b"]))


def gpt_encode(tokens: torch.Tensor, params: Mapping[str, torch.Tensor],
               dtype: torch.dtype, rope: bool = False) -> torch.Tensor:
    """wte lookup + learned positional embedding, summed in the parameter
    dtype, then cast.  rope=True skips the wpe add (positions enter
    attention through the rotation), so wpe gets an exact zero gradient."""
    if rope:
        return params["wte"][tokens].to(dtype)
    T = tokens.shape[-1]
    return (params["wte"][tokens] + params["wpe"][:T][None]).to(dtype)


def gpt_trunk(params: Mapping[str, torch.Tensor], tokens: torch.Tensor,
              cfg: ViTConfig) -> torch.Tensor:
    """Everything up to and including the final LayerNorm: (B, T, C) in
    cfg.dtype.  params from `prepare_params` or `train_params`."""
    x = gpt_encode(tokens, params, getattr(torch, cfg.dtype),
                   rope=cfg.pos_emb == "rope")
    for p in layers(params):
        x = _block(x, p, cfg)
    return basic.layernorm_cv(x, params["lnfw"], params["lnfb"])


def gpt_forward(params: Mapping[str, torch.Tensor], tokens: torch.Tensor,
                cfg: ViTConfig) -> torch.Tensor:
    """tokens (B, T) -> logits (B, T, V) in cfg.dtype; params from
    `prepare_params`.  The head is tied to wte, with no bias."""
    return basic.linear(gpt_trunk(params, tokens, cfg), params["head"])


def gpt_loss(params: Mapping[str, torch.Tensor], tokens: torch.Tensor,
             targets: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """Mean CE over B*T from the master parameters; differentiable in them.

    Where the fused CE takes the shape (`fused_ce.supports`, the JAX rule),
    the tied head is padded to a multiple of 128 rows (50257 -> 50304) with
    zeros and the pad columns are masked out of the logsumexp, as
    model.py:253-270 of the JAX package does; else plain CE on the
    unpadded logits.  On that route, with `fused_head_ce.ENABLE` set and a
    shape K8 takes, the head matmul and the CE statistics are one op (K8),
    as the JAX package routes them."""
    tp = train_params(params, cfg)
    lnf = gpt_trunk(tp, tokens, cfg)
    head = params["wte"].to(lnf.dtype)
    V = cfg.vocab_size
    Vp = fused_ce.pad_vocab(V)
    R = lnf.shape[0] * lnf.shape[1]
    if cfg.use_flash and fused_ce.supports(R, Vp):
        wte_p = F.pad(head, (0, 0, 0, Vp - V))
        if fused_head_ce.ENABLE and fused_head_ce.supports(R, Vp,
                                                           lnf.shape[-1]):
            return fused_head_ce.head_ce_mean(lnf, wte_p, targets, V)
        logits = basic.linear(lnf, wte_p)
        return fused_ce.cross_entropy_mean(logits, targets, real_vocab=V)
    logits = basic.linear(lnf, head)
    return basic.cross_entropy_from_logits(logits, targets).mean()


def loss_fn(params: Mapping[str, torch.Tensor], batch_inputs: torch.Tensor,
            batch_targets: torch.Tensor, cfg: ViTConfig,
            rng=None) -> torch.Tensor:
    """The unified loss entry; gpt mode only in this slice."""
    if cfg.mode == "vit":
        raise NotImplementedError(_VIT)
    return gpt_loss(params, batch_inputs, batch_targets, cfg)


def forward_with_loss(params: Mapping[str, torch.Tensor],
                      batch_inputs: torch.Tensor, batch_targets: torch.Tensor,
                      cfg: ViTConfig):
    """(logits, mean loss) from one forward pass; params from
    `prepare_params`.  The loss is the plain CE on the unpadded logits, as
    in the JAX package."""
    if cfg.mode == "vit":
        raise NotImplementedError(_VIT)
    logits = gpt_forward(params, batch_inputs, cfg)
    return logits, basic.cross_entropy_from_logits(logits,
                                                   batch_targets).mean()
