"""Exponential moving average of the parameters (Polyak averaging), the
eval weights of the standard ViT and MAE recipes: the port of
`vitrs_tpu/ops/ema.py`.

The port's trainer keeps its parameters as views into one flat fp32
vector (`params.unflatten_params`), so the EMA is one flat fp32 vector too
and an update is one `lerp_` over it after each optimizer step:
ema + (1 - decay) (p - ema), which is the JAX package's
decay * ema + (1 - decay) * p in exact arithmetic.  Its parameter dict,
for the side tree and the evaluation, is `params.unflatten_params(ema)`.
"""

from __future__ import annotations

import torch


def init_ema(flat: torch.Tensor) -> torch.Tensor:
    """An fp32 copy of the flat parameter vector."""
    return flat.detach().float().clone()


def update_ema(ema: torch.Tensor, flat: torch.Tensor,
               decay: float = 0.9999) -> torch.Tensor:
    """ema <- decay * ema + (1 - decay) * flat in fp32, in place (one
    `lerp_`); returns ema."""
    with torch.no_grad():
        return ema.lerp_(flat.detach().float(), 1.0 - decay)
