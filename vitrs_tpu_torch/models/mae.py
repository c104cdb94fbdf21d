"""MAE masked-patch pretraining — the port of `vitrs_tpu/models/mae.py`.

Visible patches are gathered after the position embedding is added and
only they run through the encoder (`vit_encode(keep_ids=)`, then the
blocks at causal=False: 1 + K tokens, 50 at ViT-B/16 with 75% masked).  A
narrower, shallower decoder reinserts the mask tokens, unshuffles with
`restore`, and predicts every patch's pixels; the loss is the MSE on the
masked patches, against per-patch normalised targets (`norm_pix`).

Parameters: {"encoder": the ViT dict (params.py), "decoder": its own dict
(the stacked block tensors plus embw/embb/mask_token/wpe/lnfw/lnfb/
predw/predb)}, fp32 masters; the forward casts what meets a matmul to
cfg.dtype inside the graph (`model.train_params`), and casts mask_token
and the decoder's wpe to the activation dtype, as the JAX function does;
pred and target come out in fp32.

The random split takes the (B, N) uniform noise as an input
(`masking_from_noise`, stable argsorts as jnp.argsort is stable), drawn
from an explicit torch.Generator by `draw_noise`, so that a test can hand
both packages the JAX draw's noise.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..config import ViTConfig
from ..ops import basic
from . import model as M


def decoder_config(cfg: ViTConfig, width: int = 0, depth: int = 0,
                   heads: int = 0) -> ViTConfig:
    """MAE decoder geometry: default 512x8 for L-sized encoders, scaled-down
    otherwise."""
    width = width or min(512, cfg.channels)
    depth = depth or (8 if cfg.channels >= 1024 else 4)
    heads = heads or max(1, width // 64)
    return cfg.replace(channels=width, num_layers=depth, num_heads=heads)


def decoder_shapes(cfg: ViTConfig, dcfg: ViTConfig) -> Dict[str, tuple]:
    """The decoder dict's shapes, in the JAX package's order."""
    from .. import params as P
    Dw = dcfg.channels
    patch_dim = cfg.patch_size ** 2 * cfg.in_chans
    shapes = {k: v for k, v in P.param_shapes(dcfg).items()
              if k in M.BLOCK_KEYS}
    shapes.update(embw=(Dw, cfg.channels), embb=(Dw,), mask_token=(1, 1, Dw),
                  wpe=(cfg.num_patches, Dw), lnfw=(Dw,), lnfb=(Dw,),
                  predw=(patch_dim, Dw), predb=(patch_dim,))
    return shapes


def init_decoder_params(cfg: ViTConfig, dcfg: ViTConfig,
                        generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The decoder on `generator.device`: blocks as `params.init_params`,
    embw / wpe / predw N(0, 0.02), mask_token and biases 0, LN scales 1.
    The numbers differ from jax.random's; tests carry one package's
    parameters into the other (`params.from_numpy`)."""
    from .. import params as P
    dev = generator.device
    shapes = decoder_shapes(cfg, dcfg)
    blocks = {k: v for k, v in P.init_params(dcfg, generator).items()
              if k in M.BLOCK_KEYS}

    def normal(name):
        return torch.randn(shapes[name], generator=generator,
                           device=dev) * 0.02

    def const(name, value):
        return torch.full(shapes[name], value, device=dev)

    return {**blocks, "embw": normal("embw"), "embb": const("embb", 0.0),
            "mask_token": const("mask_token", 0.0), "wpe": normal("wpe"),
            "lnfw": const("lnfw", 1.0), "lnfb": const("lnfb", 0.0),
            "predw": normal("predw"), "predb": const("predb", 0.0)}


def init_mae_params(cfg: ViTConfig, generator: torch.Generator) -> Dict:
    from .. import params as P
    return {"encoder": P.init_params(cfg, generator),
            "decoder": init_decoder_params(cfg, decoder_config(cfg),
                                           generator)}


def draw_noise(generator: torch.Generator, B: int, N: int,
               device=None) -> torch.Tensor:
    """The (B, N) uniform [0, 1) noise of one masking draw, drawn on the
    generator's device and moved to `device`."""
    noise = torch.rand((B, N), generator=generator, device=generator.device)
    return noise if device is None else noise.to(device)


def masking_from_noise(noise: torch.Tensor, mask_ratio: float
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-example random patch split from the (B, N) noise: (keep_ids
    (B, K), restore (B, N), mask (B, N) fp32, 1 = masked), K = max(1,
    int(N (1 - mask_ratio))).  The argsort of the noise is the shuffle;
    both argsorts are stable, as jnp.argsort is."""
    B, N = noise.shape
    K = max(1, int(N * (1.0 - mask_ratio)))
    shuffle = torch.argsort(noise, dim=1, stable=True)
    keep_ids = shuffle[:, :K]
    restore = torch.argsort(shuffle, dim=1, stable=True)
    mask = torch.ones((B, N), device=noise.device)
    mask[:, :K] = 0.0
    return keep_ids, restore, torch.gather(mask, 1, restore)


def random_masking(generator: torch.Generator, B: int, N: int,
                   mask_ratio: float, device=None):
    """`masking_from_noise` of a fresh draw (`draw_noise`)."""
    return masking_from_noise(draw_noise(generator, B, N, device), mask_ratio)


def _infer_decoder_config(cfg: ViTConfig, dec: Dict) -> ViTConfig:
    """Decoder geometry from the decoder params (width from lnfw, depth from
    the stacked ln1w), so a decoder built with a custom width or depth
    cannot mismatch at forward time; a custom head count still needs an
    explicit dcfg."""
    width = int(dec["lnfw"].shape[0])
    depth = int(dec["ln1w"].shape[0])
    return decoder_config(cfg, width=width, depth=depth)


def mae_forward(params: Dict, images: torch.Tensor, cfg: ViTConfig,
                noise: torch.Tensor, mask_ratio: float = 0.75,
                dcfg: ViTConfig = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(pred (B, N, patch_dim) fp32, target (B, N, patch_dim) fp32, mask
    (B, N)); differentiable in the fp32 master params.  noise: the (B, N)
    masking draw (`draw_noise`)."""
    enc, dec = params["encoder"], params["decoder"]
    if dcfg is None:
        dcfg = _infer_decoder_config(cfg, dec)
    if (int(dec["lnfw"].shape[0]) != dcfg.channels
            or int(dec["ln1w"].shape[0]) != dcfg.num_layers):
        raise ValueError(
            f"decoder params geometry ({int(dec['lnfw'].shape[0])}w x "
            f"{int(dec['ln1w'].shape[0])}L) does not match decoder config "
            f"({dcfg.channels}w x {dcfg.num_layers}L)")
    B = images.shape[0]
    N = cfg.num_patches
    keep_ids, restore, mask = masking_from_noise(noise, mask_ratio)
    enc, dec = M.train_params(enc, cfg), M.train_params(dec, dcfg)

    # ---- the encoder on the visible patches (+ CLS if configured) ----
    x = M.vit_encode(images, enc, cfg, keep_ids=keep_ids)
    x = M.transformer(x, enc, cfg, causal=False)
    x = basic.layernorm_cv(x, enc["lnfw"], enc["lnfb"])

    # ---- the decoder over the full token set ----
    dtype = x.dtype
    y = basic.linear(x, dec["embw"].to(dtype), dec["embb"].to(dtype))
    n_prefix = 1 if cfg.pool == "cls" else 0
    cls_tok, vis = y[:, :n_prefix], y[:, n_prefix:]
    K, Dw = vis.shape[1], vis.shape[-1]
    mask_tok = dec["mask_token"].to(dtype).expand(B, N - K, Dw)
    full = torch.cat([vis, mask_tok], dim=1)             # shuffled order
    full = torch.gather(full, 1, restore[..., None].expand(-1, -1, Dw))
    full = full + dec["wpe"][None].to(dtype)
    if n_prefix:
        full = torch.cat([cls_tok, full], dim=1)
    z = M.transformer(full, dec, dcfg, causal=False)
    z = basic.layernorm_cv(z, dec["lnfw"], dec["lnfb"])[:, n_prefix:]
    pred = basic.linear(z, dec["predw"].to(dtype), dec["predb"].to(dtype))
    target = basic.patchify(images, cfg.patch_size)
    return pred.float(), target.float(), mask


def mae_loss(params: Dict, images: torch.Tensor, cfg: ViTConfig,
             noise: torch.Tensor, mask_ratio: float = 0.75,
             norm_pix: bool = True, dcfg: ViTConfig = None) -> torch.Tensor:
    """MSE on the masked patches only; targets normalised per patch."""
    pred, target, mask = mae_forward(params, images, cfg, noise, mask_ratio,
                                     dcfg=dcfg)
    if norm_pix:
        mu = target.mean(-1, keepdim=True)
        var = target.var(-1, unbiased=False, keepdim=True)
        target = (target - mu) / torch.sqrt(var + 1e-6)
    per_patch = ((pred - target) ** 2).mean(-1)               # (B, N)
    return (per_patch * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def reconstruct(params: Dict, images: torch.Tensor, cfg: ViTConfig,
                noise: torch.Tensor, mask_ratio: float = 0.75,
                dcfg: ViTConfig = None) -> torch.Tensor:
    """The full image with the masked patches predicted and the visible
    ones pasted back, for inspection."""
    pred, target, mask = mae_forward(params, images, cfg, noise, mask_ratio,
                                     dcfg=dcfg)
    mixed = torch.where(mask[..., None] > 0, pred, target)
    return basic.unpatchify(mixed, cfg.patch_size, cfg.img_size, cfg.in_chans)
