"""CLIP image tower + contrastive loss — the port of
`vitrs_tpu/models/clip.py`.

The image tower is the ViT trunk with an L2-normalised linear projection
into the shared embedding space (the `clip-l-14` preset maps channels 1024
to 768-dim embeddings through the head tensors).  `contrastive_loss` takes
any batch of text or label embeddings (B, E) and computes the symmetric
InfoNCE objective with a learnable log temperature (`logit_scale`, an
fp32 scalar beside the ViT tensors), clamped at log 100.  Parameters are
fp32 masters, cast to cfg.dtype inside the graph (`model.train_params`).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from ..config import ViTConfig
from ..ops import basic
from . import model as M


def init_clip_params(cfg: ViTConfig, generator: torch.Generator,
                     init_temp: float = 0.07) -> Dict[str, torch.Tensor]:
    """The ViT dict (`params.init_params`) + logit_scale = log(1 /
    init_temp), on `generator.device`."""
    from .. import params as P
    params = P.init_params(cfg, generator)
    params["logit_scale"] = torch.tensor(math.log(1.0 / init_temp),
                                         dtype=torch.float32,
                                         device=generator.device)
    return params


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def image_embed(params: Dict, images: torch.Tensor,
                cfg: ViTConfig) -> torch.Tensor:
    """(B, H, W, C) -> L2-normalised (B, E) fp32 embeddings; the
    projection is the head tensors (headw: (E, channels))."""
    tp = M.train_params(params, cfg)
    x = M.vit_encode(images, tp, cfg)
    x = M.transformer(x, tp, cfg, causal=False)
    lnf = basic.layernorm_cv(x, tp["lnfw"], tp["lnfb"])
    pooled = lnf[:, 0] if cfg.pool == "cls" else lnf.mean(dim=1)
    emb = basic.linear(pooled, tp["headw"].to(pooled.dtype),
                       tp["headb"].to(pooled.dtype))
    return _unit(emb.float())


def contrastive_loss(img_emb: torch.Tensor, txt_emb: torch.Tensor,
                     logit_scale: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE over in-batch negatives; the diagonal holds the
    positives."""
    scale = torch.exp(torch.clamp(logit_scale, max=math.log(100.0)))
    logits = scale * img_emb @ _unit(txt_emb).T                # (B, B)
    labels = torch.arange(logits.shape[0], device=logits.device)
    li = basic.cross_entropy_from_logits(logits, labels)
    lt = basic.cross_entropy_from_logits(logits.T, labels)
    return 0.5 * (li.mean() + lt.mean())


def clip_loss(params: Dict, images: torch.Tensor, txt_emb: torch.Tensor,
              cfg: ViTConfig) -> torch.Tensor:
    return contrastive_loss(image_embed(params, images, cfg), txt_emb,
                            params["logit_scale"])


def zero_shot_classify(params: Dict, images: torch.Tensor,
                       class_embs: torch.Tensor,
                       cfg: ViTConfig) -> torch.Tensor:
    """Cosine-similarity logits against per-class embedding prototypes."""
    return image_embed(params, images, cfg) @ _unit(class_embs).T
