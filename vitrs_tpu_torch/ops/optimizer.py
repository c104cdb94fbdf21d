"""Optimizers over the flat parameter vector and over parameter dicts —
the port of `vitrs_tpu/ops/optimizer.py`.

  * sgd_step    — the reference-as-written update p -= lr g;
  * adamw_step  — bias-corrected AdamW with decoupled weight decay over the
                  flat fp32 vector: the fused kernel K7 on a CUDA tensor
                  (ops/fused_adamw.py), its plain version on a CPU one;
  * adamw_tree  — the same update per tensor of a parameter dict, in plain
                  PyTorch (the JAX package leaves it to XLA), with fp32 or
                  bf16 optimizer state;
  * the learning-rate schedules, computed on the host.

The JAX functions return new arrays; `sgd_step` and `adamw_step` update
their inputs in place here (on the card that saves a copy of every
parameter per step) and return them.  `adamw_tree` returns new dicts, as
the JAX function does.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from . import fused_adamw


def sgd_step(flat_params: torch.Tensor, flat_grads: torch.Tensor,
             lr: float) -> torch.Tensor:
    """p[i] -= lr * g[i], in place (train_vit.rs:737-743 semantics)."""
    with torch.no_grad():
        return flat_params.sub_(flat_grads * lr)


def adamw_step(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
               v: torch.Tensor, step, lr, beta1: float = 0.9,
               beta2: float = 0.999, eps: float = 1e-8,
               weight_decay: float = 0.0
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused AdamW on the flat vector, in place: K7 on CUDA, its plain
    version on the CPU, and no other path."""
    with torch.no_grad():
        fused_adamw.adamw_op(p, g, m, v, float(step), float(lr), beta1, beta2,
                             eps, float(weight_decay))
    return p, m, v


def decay_mask_2d(params: Mapping[str, torch.Tensor]) -> Dict[str, bool]:
    """The JAX package's decay rule: decay a tensor when it has >= 2 axes.
    Meant as llm.c's policy (biases and LN parameters not decayed), but the
    stacked per-layer biases and LN gains are (L, C), so they are decayed
    too; the port keeps that for parity (ROADMAP.md Queue 3)."""
    return {k: p.dim() >= 2 for k, p in params.items()}


def adamw_tree(params: Mapping[str, torch.Tensor],
               grads: Mapping[str, torch.Tensor],
               m: Mapping[str, torch.Tensor], v: Mapping[str, torch.Tensor],
               step, lr, beta1: float = 0.9, beta2: float = 0.999,
               eps: float = 1e-8, weight_decay: float = 0.0,
               decay_mask: Optional[Mapping[str, bool]] = None):
    """AdamW per tensor of a dict: returns new (params, m, v) dicts.  The
    state keeps its dtype (fp32 is exact AdamW; bf16 state computes in fp32
    and rounds back); the update itself runs in fp32.  decay_mask: tensors
    marked False get weight_decay 0.  A nested dict (the MAE tree
    {"encoder", "decoder"}) is walked as the JAX function walks a pytree:
    grads, m, v and decay_mask nest alike."""
    f32 = dict(dtype=torch.float32)
    new_p, new_m, new_v = {}, {}, {}
    with torch.no_grad():
        for k, p in params.items():
            if isinstance(p, Mapping):
                new_p[k], new_m[k], new_v[k] = adamw_tree(
                    p, grads[k], m[k], v[k], step, lr, beta1, beta2, eps,
                    weight_decay, None if decay_mask is None else decay_mask[k])
                continue
            t = torch.tensor(float(step), device=p.device, **f32)
            bc1 = 1.0 - torch.pow(torch.tensor(beta1, device=p.device, **f32), t)
            bc2 = 1.0 - torch.pow(torch.tensor(beta2, device=p.device, **f32), t)
            wd = weight_decay if decay_mask is None or decay_mask[k] else 0.0
            g = grads[k].float()
            mf = m[k].float() * beta1 + g * (1.0 - beta1)
            vf = v[k].float() * beta2 + g * (1.0 - beta2) * g
            pf = p.float()
            pf = pf - ((mf / bc1) / (torch.sqrt(vf / bc2) + eps) + pf * wd) * lr
            new_p[k] = pf.to(p.dtype)
            new_m[k] = mf.to(m[k].dtype)
            new_v[k] = vf.to(v[k].dtype)
    return new_p, new_m, new_v


def cosine_lr_host(step: int, base_lr: float, warmup: int, total: int,
                   min_lr: float = 0.0) -> float:
    """Linear warmup + cosine decay, computed on the host in float32 as the
    JAX package's host schedule is."""
    s = np.float32(step)
    if s < warmup:
        return float(np.float32(base_lr) * s / np.float32(max(1.0, warmup)))
    prog = np.clip((s - warmup) / np.float32(max(1.0, total - warmup)),
                   np.float32(0), np.float32(1))
    return float(np.float32(min_lr) + np.float32(0.5)
                 * (np.float32(base_lr) - np.float32(min_lr))
                 * (np.float32(1.0) + np.cos(np.float32(np.pi) * prog)))


def wsd_lr_host(step: int, base_lr: float, warmup: int, total: int,
                decay_frac: float = 0.1, min_lr: float = 0.0) -> float:
    """Warmup-Stable-Decay: linear warmup, a flat plateau at base_lr, then a
    linear cooldown over the final `decay_frac` of training."""
    s = np.float32(step)
    if s < warmup:
        return float(np.float32(base_lr) * s / np.float32(max(1.0, warmup)))
    decay_steps = np.float32(max(1.0, decay_frac * total))
    decay_start = np.float32(total) - decay_steps
    if s < decay_start:
        return float(base_lr)
    prog = np.clip((s - decay_start) / decay_steps, np.float32(0),
                   np.float32(1))
    return float(np.float32(base_lr)
                 + (np.float32(min_lr) - np.float32(base_lr)) * prog)
