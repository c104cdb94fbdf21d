"""The transformer in GPT and ViT mode — the port of
`vitrs_tpu/models/model.py`.

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
both paths.

ViT mode (cfg.mode == "vit"): `vit_encode` patchifies (B, H, W, C) images
into one matmul, adds wpe and the CLS token; the blocks attend
bidirectionally (the flash kernels at causal=False); `vit_forward` pools
(CLS or mean) into the classifier head.  Training draws stochastic depth
and head dropout from an explicit torch.Generator (`draw_masks`); the
masks are drawn on the generator's device and moved to the activations',
so a CPU generator gives the same masks to a run on the card and on the
CPU.

MoE (cfg.num_experts > 0): every block's MLP is the routed expert layer of
ops/moe.py (`_block_moe`), reading the layer's (E, ...) expert slabs and
its fp32 router (routerw, not a matmul key: the router runs in fp32); the
blocks sum each layer's weighted router loss (moe_aux_weight load balance
+ moe_zloss_weight z-loss) and `transformer` returns its mean over the
layers, which `gpt_loss` adds on every CE route and `vit_loss` adds too.
Under expert parallelism `gpt_loss(ep_group=)` threads the expert
group down to `moe_mlp`, whose expert leaves are then the rank's
(L, E/ep, ...) shards (parallel/expert_parallel.py).

quirks=True is the reference's math as written (G5, G6, G11): attention
always takes the dense route with the quirk softmax (no kernel computes
it), the GPT loss is the negated target probability of the quirk softmax,
and under any remat the block is checkpointed whole, as in the JAX
package.

cfg.remat picks the block body (`block_body`): the plain block, the
selective blocks of models/selective.py (True), or the plain block under
`torch.utils.checkpoint` ("full"), as the JAX package's layer scan does.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import ViTConfig
from ..ops import basic, fused_ce, fused_head_ce, quant
from ..ops._build import to_device
from ..ops.attention import (expand_qkv_weight, rope_packed,
                             supports as flash_supports)
from ..ops.fused_qkv_attention import qkv_attention
from ..ops.moe import moe_mlp
from ..utils import trace

BLOCK_KEYS = ("ln1w", "ln1b", "qkvw", "qkvb", "attprojw", "attprojb",
              "ln2w", "ln2b", "fcw", "fcb", "fcprojw", "fcprojb")
# the tensors that meet a matmul, cast to the compute dtype
MATMUL_KEYS = ("qkvw", "qkvb", "attprojw", "attprojb",
               "fcw", "fcb", "fcprojw", "fcprojb")
# vit mode's patch embedding and classifier head, which meet a matmul too
VIT_MATMUL_KEYS = ("patchw", "patchb", "headw", "headb")


def prepare_params(params: Mapping[str, torch.Tensor], cfg: ViTConfig
                   ) -> Dict[str, torch.Tensor]:
    """The dict every forward path reads, built once per model or engine.

    The tensors stay on their device and leave autograd.  The matmul
    weights and biases are cast once to cfg.dtype (vit mode: the patch
    embedding and the classifier head too), and in gpt mode "head" holds
    the tied head (wte) in cfg.dtype: the JAX package casts these on every
    call, with the same result.  LN params, the embedding tables and the
    CLS token keep their own dtype, because the JAX package computes
    LayerNorm in fp32 and adds the embeddings (and cls + wpe[0]) before its
    cast.

    A dict of int8 weights (`ops/quant.quantize_params`) keeps them in int8
    beside their fp32 `_scale` companions, each padded once with zero
    output channels to a multiple of 8 (`quant.pad_out_channels`, so that
    no int8 product copies a weight to pad it), and gets no float head: the
    forwards read the int8 wte with its scales (models/generate.py,
    models/quantized.py).  A MoE config with int8 weights raises
    ValueError: the JAX package does not wire int8 expert slabs either."""
    dtype = getattr(torch, cfg.dtype)
    out = {k: v.detach() for k, v in params.items()}
    quantized = any(k.endswith("_scale") for k in out)
    if quantized and cfg.is_moe:
        raise ValueError("int8 weights with a MoE config: the expert slabs "
                         "have no int8 path (as in the JAX package)")
    for k in MATMUL_KEYS + (VIT_MATMUL_KEYS if cfg.mode == "vit" else ()):
        if out[k].dtype != torch.int8:
            out[k] = out[k].to(dtype)
    for k in out:
        if k + "_scale" in out:
            out[k] = quant.pad_out_channels(out[k])
    if cfg.mode == "gpt" and not quantized:
        out["head"] = out["wte"].to(dtype)
    return out


def train_params(params: Mapping[str, torch.Tensor], cfg: ViTConfig
                 ) -> Dict[str, torch.Tensor]:
    """The training counterpart of `prepare_params`, called on every step:
    the fp32 master tensors (which may require grad), with the matmul
    weights and biases cast to cfg.dtype inside the autograd graph, once
    per step per stacked tensor.  qkvw and qkvb stay in their dtype: the
    fused qkv-attention op casts them itself and returns their gradients in
    fp32, as the JAX op does.  No "head": `gpt_loss` builds it from wte;
    vit mode's patch embedding and head are cast where they are used
    (`vit_encode`, `vit_forward`), as the JAX package casts them."""
    dtype = getattr(torch, cfg.dtype)
    out = dict(params)
    for k in MATMUL_KEYS:
        if k not in ("qkvw", "qkvb"):
            out[k] = params[k].to(dtype)
    return out


def block_keys(params: Mapping[str, torch.Tensor]) -> Tuple[str, ...]:
    """The stacked per-layer keys: BLOCK_KEYS, + routerw under MoE, + the
    `_scale` companions of int8 weights (the JAX `_block_keys`)."""
    return (BLOCK_KEYS + (("routerw",) if "routerw" in params else ())
            + tuple(k + "_scale" for k in BLOCK_KEYS
                    if k + "_scale" in params))


def layer(params: Mapping[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    """Layer i's block params: views into the stacked tensors."""
    return {k: params[k][i] for k in block_keys(params)}


def layers(params: Mapping[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
    """Every layer's block params, as `layer` gives them, from one unbind
    per stacked tensor."""
    keys = block_keys(params)
    per = {k: params[k].unbind(0) for k in keys}
    return [{k: per[k][i] for k in keys}
            for i in range(len(per[BLOCK_KEYS[0]]))]


def plin(p: Mapping[str, torch.Tensor], wkey: str, bkey: Optional[str],
         x: torch.Tensor, w8a8: bool = False) -> torch.Tensor:
    """x @ p[wkey].T (+ p[bkey]); an int8 weight, the one with a
    `wkey + '_scale'` companion, goes through `quant.linear_w8`
    (weight-only, as the JAX package's `_plin`), or `quant.linear_w8a8`
    when w8a8 (models/quantized.py)."""
    b = p[bkey] if bkey is not None else None
    if wkey + "_scale" in p:
        f = quant.linear_w8a8 if w8a8 else quant.linear_w8
        return f(x, p[wkey], p[wkey + "_scale"], b)
    return basic.linear(x, p[wkey], b)


def mlp(p: Mapping[str, torch.Tensor], cfg: ViTConfig,
        x: torch.Tensor) -> torch.Tensor:
    """ln2 output -> fc, GELU, fcproj (int8 weights through `plin`)."""
    h = plin(p, "fcw", "fcb", x)
    h = basic.gelu_erf_cv(h) if cfg.act == "gelu_erf" else basic.gelu_cv(h)
    return plin(p, "fcprojw", "fcprojb", h)


def _project_and_attend(ln1: torch.Tensor, p: Mapping[str, torch.Tensor],
                        cfg: ViTConfig, causal: bool) -> torch.Tensor:
    """qkv projection + attention: the fused op on the flash path (whose
    backward never builds the packed dqkv; K3 under GQA; rope and the band
    inside the kernels), else the plain composition with dense attention,
    the GQA weight expanded to MHA and q, k rotated explicitly
    (JAX model.py:54-68), as the JAX package routes them.  A quirk config
    takes the plain composition with the quirk softmax."""
    rope = cfg.pos_emb == "rope"
    if (cfg.use_flash and not cfg.quirks
            and flash_supports(cfg.num_heads, cfg.head_size, cfg.kv_heads,
                               rope)):
        return qkv_attention(ln1, p["qkvw"], p["qkvb"], cfg.num_heads, causal,
                             cfg.window, rope, kv_heads=cfg.kv_heads)
    w, b = expand_qkv_weight(p["qkvw"], p["qkvb"], cfg.num_heads,
                             cfg.kv_heads)
    qkv = basic.linear(ln1, w.to(ln1.dtype), b.to(ln1.dtype))
    if rope:
        qkv = rope_packed(qkv, cfg.num_heads)
    return basic.attention_dense(qkv, cfg.num_heads, causal=causal,
                                 window=cfg.window, quirks=cfg.quirks)[0]


def _drop_path(branch: torch.Tensor, keep: torch.Tensor,
               rate: float) -> torch.Tensor:
    """Stochastic depth: zero the residual branch of the samples whose keep
    flag (B,) is False and scale the rest by 1/(1 - rate), so the
    expectation is kept.  The scale stays in the branch's dtype; the JAX
    op's traced fp32 rate promotes a bf16 branch to fp32, which its layer
    scan then refuses (ROADMAP.md Queue 3)."""
    return torch.where(keep[:, None, None], branch / (1.0 - rate), 0.0)


def drop_path_rates(cfg: ViTConfig) -> List[float]:
    """Layer l's stochastic-depth rate: linspace(0, drop_path, L)[l]."""
    return np.linspace(0.0, cfg.drop_path, cfg.num_layers,
                       dtype=np.float32).tolist()


def _attn_branch(x: torch.Tensor, p: Mapping[str, torch.Tensor],
                 cfg: ViTConfig, causal: bool) -> torch.Tensor:
    """attproj(attention(qkv(ln1(x)))): the attention residual branch."""
    ln1 = basic.layernorm_cv(x, p["ln1w"], p["ln1b"])
    atty = _project_and_attend(ln1, p, cfg, causal)
    return basic.linear(atty, p["attprojw"], p["attprojb"])


def _attn_residual(x: torch.Tensor, p: Mapping[str, torch.Tensor],
                   cfg: ViTConfig, causal: bool,
                   keep: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """x + the attention branch, dropped by keep[0]: the first half of the
    dense and the MoE block."""
    branch = _attn_branch(x, p, cfg, causal)
    if keep is not None:
        branch = _drop_path(branch, keep[0], rate)
    return x + branch


def _block(x: torch.Tensor, p: Mapping[str, torch.Tensor], cfg: ViTConfig,
           causal: bool = True, keep: Optional[torch.Tensor] = None,
           rate: float = 0.0) -> torch.Tensor:
    """The pre-LN block (rusty_vit.rs:322-331 op order).  keep (2, B):
    stochastic depth's keep flags of the attention and MLP branches, at
    `rate`."""
    x = _attn_residual(x, p, cfg, causal, keep, rate)
    branch = mlp(p, cfg, basic.layernorm_cv(x, p["ln2w"], p["ln2b"]))
    if keep is not None:
        branch = _drop_path(branch, keep[1], rate)
    return x + branch


def _moe_half(x: torch.Tensor, p: Mapping[str, torch.Tensor],
              cfg: ViTConfig, ep_group=None):
    """ln2, then the MoE layer: (its output, this layer's weighted router
    loss moe_aux_weight load_balance + moe_zloss_weight z_loss).  ep_group:
    expert parallelism (the expert leaves the rank's (E/ep, ...) shards;
    ops/moe.py)."""
    out, aux = moe_mlp(basic.layernorm_cv(x, p["ln2w"], p["ln2b"]),
                       p["routerw"], p["fcw"], p["fcb"], p["fcprojw"],
                       p["fcprojb"], top_k=cfg.moe_top_k,
                       cap_factor=cfg.moe_cap_factor,
                       erf=cfg.act == "gelu_erf", ep_group=ep_group)
    return out, (cfg.moe_aux_weight * aux.load_balance
                 + cfg.moe_zloss_weight * aux.z_loss)


def _block_moe(x: torch.Tensor, p: Mapping[str, torch.Tensor],
               cfg: ViTConfig, causal: bool = True,
               keep: Optional[torch.Tensor] = None, rate: float = 0.0,
               ep_group=None):
    """The block with the dense MLP replaced by the MoE layer.  Returns
    (x, this layer's weighted router loss)."""
    x = _attn_residual(x, p, cfg, causal, keep, rate)
    out, aux = _moe_half(x, p, cfg, ep_group)
    if keep is not None:
        out = _drop_path(out, keep[1], rate)
    return x + out, aux


def block_body(cfg: ViTConfig):
    """The block function of one layer under cfg.remat, with `_block`'s
    signature (x, p, cfg, causal, keep, rate): False, the plain block;
    True, the selective blocks (models/selective.py: the flash out + lse
    and the LN statistics kept, the qkv projection and the MLP recomputed);
    "full", the plain block under `torch.utils.checkpoint`, which runs its
    forward again in the backward (K1-fwd twice a layer); a quirk config
    under any remat takes "full", as in the JAX package.  The stochastic
    depth flags are inputs, drawn before the forward, so a recomputed block
    sees the same ones.  A forward without autograd takes the plain
    block."""
    plain = _block_moe if cfg.is_moe else _block
    if not cfg.remat or not torch.is_grad_enabled():
        return plain
    if cfg.remat == "full" or cfg.quirks:
        def full(x, p, cfg, causal, keep, rate, **ep):
            return checkpoint(plain, x, p, cfg, causal, keep, rate, **ep,
                              use_reentrant=False, preserve_rng_state=False)
        return full
    from .selective import block_moe_selective, block_selective
    return block_moe_selective if cfg.is_moe else block_selective


def transformer(x: torch.Tensor, params: Mapping[str, torch.Tensor],
                cfg: ViTConfig, causal: bool,
                keep: Optional[torch.Tensor] = None,
                return_aux: bool = False, ep_group=None):
    """The blocks over every layer, each under cfg.remat (`block_body`).
    keep (L, 2, B): stochastic depth's keep flags (`draw_masks`), layer l
    at rate `drop_path_rates(cfg)[l]`.  return_aux: also return the mean
    over the layers of the weighted MoE router loss (an fp32 zero for a
    dense config), which the losses add.  ep_group: expert parallelism for
    the MoE blocks (`_moe_half`)."""
    rates = drop_path_rates(cfg)
    body = block_body(cfg)
    ep_kw = {} if ep_group is None else dict(ep_group=ep_group)
    aux = None
    for i, p in enumerate(layers(params)):
        k = None if keep is None else keep[i]
        if cfg.is_moe:
            x, a = body(x, p, cfg, causal, k, rates[i], **ep_kw)
            aux = a if aux is None else aux + a
        else:
            x = body(x, p, cfg, causal, k, rates[i])
    if not return_aux:
        return x
    if aux is None:
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux / cfg.num_layers


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
              cfg: ViTConfig, return_aux: bool = False, ep_group=None):
    """Everything up to and including the final LayerNorm: (B, T, C) in
    cfg.dtype; with return_aux, (that, the mean weighted MoE router loss).
    params from `prepare_params` or `train_params`."""
    x = gpt_encode(tokens, params, getattr(torch, cfg.dtype),
                   rope=cfg.pos_emb == "rope")
    x = transformer(x, params, cfg, causal=True, return_aux=return_aux,
                    ep_group=ep_group)
    if return_aux:
        x, aux = x
        return basic.layernorm_cv(x, params["lnfw"], params["lnfb"]), aux
    return basic.layernorm_cv(x, params["lnfw"], params["lnfb"])


def gpt_forward(params: Mapping[str, torch.Tensor], tokens: torch.Tensor,
                cfg: ViTConfig) -> torch.Tensor:
    """tokens (B, T) -> logits (B, T, V) in cfg.dtype; params from
    `prepare_params`.  The head is tied to wte, with no bias."""
    return basic.linear(gpt_trunk(params, tokens, cfg), params["head"])


def gpt_loss(params: Mapping[str, torch.Tensor], tokens: torch.Tensor,
             targets: torch.Tensor, cfg: ViTConfig,
             ep_group=None) -> torch.Tensor:
    """Mean CE over B*T from the master parameters; differentiable in them.

    Where the fused CE takes the shape (`fused_ce.supports`, the JAX rule),
    the tied head is padded to a multiple of 128 rows (50257 -> 50304) with
    zeros and the pad columns are masked out of the logsumexp, as
    model.py:253-270 of the JAX package does; else plain CE on the
    unpadded logits.  On that route, with `fused_head_ce.ENABLE` set and a
    shape K8 takes, the head matmul and the CE statistics are one op (K8),
    as the JAX package routes them.  Every route adds the mean weighted
    MoE router loss (an exact 0 for a dense config).  quirks=True: the
    reference's loss as written, -mean p_target of the quirk softmax of the
    fp32 logits (G6, G11).  ep_group: expert parallelism, the expert
    leaves the rank's (L, E/ep, ...) shards (parallel/expert_parallel.py);
    the loss is then the rank's own mean."""
    tp = train_params(params, cfg)
    lnf, aux = gpt_trunk(tp, tokens, cfg, return_aux=True, ep_group=ep_group)
    if cfg.quirks:
        return quirk_loss(basic.linear(lnf, params["wte"].to(lnf.dtype)),
                          targets)
    return gpt_head_loss(lnf, params["wte"], targets, cfg) + aux


def gpt_head_loss(lnf: torch.Tensor, wte: torch.Tensor,
                  targets: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """Mean CE of the tied head over the final LN's output (B, T, C): the
    fused CE (K5/K6) on the head padded to 50304 rows, or K8 with
    `fused_head_ce.ENABLE`, where they take the shape, else plain CE on the
    unpadded logits (`gpt_loss`'s routes; the mesh families' replicated
    heads take it too)."""
    head = wte.to(lnf.dtype)
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


def quirk_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The reference's mean loss as written: -p_target of the G11 softmax
    of the fp32 logits (G6)."""
    probs = basic.softmax(logits.float(), quirks=True)
    return basic.cross_entropy_quirk(probs, targets).mean()


# ---------------------------------------------------------------------------
# ViT mode
# ---------------------------------------------------------------------------

def vit_encode(images: torch.Tensor, params: Mapping[str, torch.Tensor],
               cfg: ViTConfig,
               keep_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, H, W, C) images -> (B, T, C) tokens in cfg.dtype: patchify, one
    matmul with the patch embedding (its weight cast to cfg.dtype, the
    product rounded, then the bias added, as `linear` does), wpe rows
    n_prefix.. added in cfg.dtype, then the CLS token (cls + wpe[0], summed
    in the parameter dtype, then cast) in front.  keep_ids (B, K) keeps a
    subset of each example's patches (the MAE masking hook), after the
    positions are added."""
    dtype = getattr(torch, cfg.dtype)
    patches = basic.patchify(images, cfg.patch_size).to(dtype)
    x = basic.linear(patches, params["patchw"].to(dtype),
                     params["patchb"].to(dtype))
    n_prefix = 1 if cfg.pool == "cls" else 0
    x = x + params["wpe"][n_prefix:n_prefix + x.shape[1]].to(dtype)
    if keep_ids is not None:
        x = torch.gather(x, 1, keep_ids.long()[..., None].expand(
            -1, -1, x.shape[2]))
    if cfg.pool == "cls":
        cls = (params["cls"] + params["wpe"][None, :1]).to(dtype)
        x = torch.cat([cls.expand(x.shape[0], 1, x.shape[2]), x], dim=1)
    return x


def draw_masks(cfg: ViTConfig, batch: int, generator: torch.Generator,
               device) -> Dict[str, torch.Tensor]:
    """The keep flags of one training forward, drawn from `generator` on
    its own device in a fixed order, then moved to `device` (`to_device`,
    which does not wait for the card): "drop_path"
    (L, 2, B), Bernoulli(1 - rate) for each (layer, branch) where
    cfg.drop_path > 0; then "head" (B, C), Bernoulli(1 - drop_rate), where
    cfg.drop_rate > 0."""
    gdev = generator.device
    out = {}
    if cfg.drop_path > 0.0:
        keep_p = 1.0 - torch.tensor(drop_path_rates(cfg), device=gdev)
        u = torch.rand((cfg.num_layers, 2, batch), generator=generator,
                       device=gdev)
        out["drop_path"] = u < keep_p[:, None, None]
    if cfg.drop_rate > 0.0:
        u = torch.rand((batch, cfg.channels), generator=generator,
                       device=gdev)
        out["head"] = u < 1.0 - cfg.drop_rate
    return {k: to_device(v, device) for k, v in out.items()}


def vit_forward(params: Mapping[str, torch.Tensor], images: torch.Tensor,
                cfg: ViTConfig, train: bool = False,
                generator: Optional[torch.Generator] = None,
                return_aux: bool = False):
    """(B, H, W, C) images -> class logits (B, num_classes) in fp32: the
    encoder, the blocks (bidirectional), the final LN, the CLS token or
    the mean over tokens, head dropout, the head in cfg.dtype.  With train
    and a generator, stochastic depth and head dropout draw their flags
    from it (`draw_masks`); otherwise neither runs, as in the JAX function
    without an rng.  params from `prepare_params` or `train_params`.
    return_aux: (logits, the mean weighted MoE router loss)."""
    with trace.span("model.vit_forward"):
        x = vit_encode(images, params, cfg)
        masks = (draw_masks(cfg, x.shape[0], generator, x.device)
                 if train and generator is not None else {})
        x = transformer(x, params, cfg, causal=False,
                        keep=masks.get("drop_path"), return_aux=return_aux)
        aux = None
        if return_aux:
            x, aux = x
        lnf = basic.layernorm_cv(x, params["lnfw"], params["lnfb"])
        pooled = lnf[:, 0] if cfg.pool == "cls" else lnf.mean(dim=1)
        if "head" in masks:
            pooled = torch.where(masks["head"],
                                 pooled / (1.0 - cfg.drop_rate), 0.0)
        logits = basic.linear(pooled, params["headw"].to(pooled.dtype),
                              params["headb"].to(pooled.dtype)).float()
    return (logits, aux) if return_aux else logits


def vit_loss(params: Mapping[str, torch.Tensor], images: torch.Tensor,
             labels: torch.Tensor, cfg: ViTConfig, train: bool = True,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Mean CE over the batch from the master parameters (cast inside the
    graph, `train_params`); label smoothing when training with
    cfg.label_smoothing > 0; plus the mean weighted MoE router loss."""
    logits, aux = vit_forward(train_params(params, cfg), images, cfg,
                              train=train, generator=generator,
                              return_aux=True)
    if train and cfg.label_smoothing > 0.0:
        return basic.cross_entropy_smoothed(logits, labels,
                                            cfg.label_smoothing).mean() + aux
    return basic.cross_entropy_from_logits(logits, labels).mean() + aux


def loss_fn(params: Mapping[str, torch.Tensor], batch_inputs: torch.Tensor,
            batch_targets: torch.Tensor, cfg: ViTConfig,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The unified loss entry, by cfg.mode; the generator feeds vit mode's
    stochastic depth and head dropout."""
    if cfg.mode == "vit":
        return vit_loss(params, batch_inputs, batch_targets, cfg,
                        generator=generator)
    return gpt_loss(params, batch_inputs, batch_targets, cfg)


def forward_with_loss(params: Mapping[str, torch.Tensor],
                      batch_inputs: torch.Tensor, batch_targets: torch.Tensor,
                      cfg: ViTConfig):
    """(logits, mean loss) from one forward pass; params from
    `prepare_params`.  The loss is the plain CE on the unpadded logits, as
    in the JAX package (vit mode: no smoothing, no dropout); a quirk gpt
    config's is `quirk_loss`."""
    if cfg.mode == "vit":
        logits = vit_forward(params, batch_inputs, cfg, train=False)
    else:
        logits = gpt_forward(params, batch_inputs, cfg)
        if cfg.quirks:
            return logits, quirk_loss(logits, batch_targets)
    return logits, basic.cross_entropy_from_logits(logits,
                                                   batch_targets).mean()
