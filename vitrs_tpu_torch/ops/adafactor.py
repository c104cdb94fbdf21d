"""Adafactor (Shazeer & Stern 2018) — the port of `vitrs_tpu/ops/adafactor.py`
on one device.  The JAX package leaves it to XLA, outside any Pallas kernel;
the port computes it in plain PyTorch, per tensor of the parameter dict, in
fp32.

The semantics are the JAX step's:
  * β2_t = 1 − t^−0.8, with EPS1 = 1e-30 added to g² inside the square root;
  * a tensor factors only when both trailing dims reach MIN_FACTOR (128):
    v̂ = (R ⊗ C) / mean(R) over its LAST TWO dims, per trailing matrix, so
    the stacked (L, OC, IC) blocks and (L, E, OC, IC) expert slabs factor
    each matrix on its own; the router (L, E, C), the (L, E, 4C) biases and
    the LN stacks keep a full second moment vf;
  * the update clip u / max(1, RMS(u)) and the relative step's RMS(param)
    are taken per trailing matrix for factored tensors, per trailing vector
    for the other stacks (ndim >= 2), over the whole tensor for vectors;
  * decoupled decay is lr · wd · p (not the relative step's alpha), masked
    by the caller (`ops/optimizer.decay_mask_2d`);
  * the first moment m is off at beta1 = 0 (an empty dict).

The state has the JAX layout, leaf for leaf: a factored tensor keeps vr
(…, OC), vc (…, IC) and a 0-d vf placeholder; any other keeps 0-d vr, vc
and a full vf.  So a state written to a side tree (checkpoint_tree.py) by
one package loads in the other.  Not ported: the tensor-parallel arguments
(shard_axes, axis_name, factored) and `shard_axes_from_specs` /
`state_specs` (ROADMAP.md Queue 1 item 18).
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch

EPS1 = 1e-30     # inside-sqrt regularizer on g²
EPS2 = 1e-3      # RMS(param) floor for the relative step size
CLIP_D = 1.0
MIN_FACTOR = 128  # min trailing-dim size to rank-factor (optax convention)


class AdafactorState(NamedTuple):
    """Dicts mirroring the params: vr/vc the factored row/column EMAs, vf
    the full second moment, m the first moment (empty when beta1 = 0)."""
    vr: Dict[str, torch.Tensor]
    vc: Dict[str, torch.Tensor]
    vf: Dict[str, torch.Tensor]
    m: Dict[str, torch.Tensor]


def factored(p: torch.Tensor) -> bool:
    return p.dim() >= 2 and min(p.shape[-2:]) >= MIN_FACTOR


def init_state(params: Mapping[str, torch.Tensor],
               beta1: float = 0.0) -> AdafactorState:
    """Zero state on each parameter's device, in the JAX layout."""
    vr, vc, vf = {}, {}, {}
    for k, p in params.items():
        z = lambda shape: torch.zeros(shape, dtype=torch.float32,  # noqa: E731
                                      device=p.device)
        if factored(p):
            vr[k] = z(p.shape[:-1])
            vc[k] = z(p.shape[:-2] + p.shape[-1:])
            vf[k] = z(())
        else:
            vr[k], vc[k] = z(()), z(())
            vf[k] = z(p.shape)
    m = ({k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
          for k, p in params.items()} if beta1 > 0.0 else {})
    return AdafactorState(vr, vc, vf, m)


def _rms(x: torch.Tensor, dims=None) -> torch.Tensor:
    """sqrt(mean(x²)) over `dims` (kept), or over the whole tensor."""
    if dims is None:
        return x.square().mean().sqrt()
    return x.square().mean(dim=dims, keepdim=True).sqrt()


def step(params: Mapping[str, torch.Tensor],
         grads: Mapping[str, torch.Tensor], state: AdafactorState, t, lr,
         beta1: float = 0.0, weight_decay: float = 0.0,
         decay_mask: Optional[Mapping[str, bool]] = None,
         relative_step: bool = True):
    """One Adafactor step over the parameter dict: returns (new params in
    each parameter's dtype, new state), as the JAX function does.  t is the
    1-based step (the β2 schedule), lr the schedule's value (times
    max(RMS(param), EPS2) under relative_step)."""
    # β2 in fp32 on the host, as the JAX step computes it from t
    tf = np.float32(max(float(t), 1.0))
    beta2 = float(np.float32(1.0) - tf ** np.float32(-0.8))
    lr = float(lr)
    new_p, new_vr, new_vc, new_vf, new_m = {}, {}, {}, {}, {}
    with torch.no_grad():
        for k, p in params.items():
            fac = factored(p)
            g = grads[k].float()
            g2 = g.square() + EPS1
            if fac:
                vr = beta2 * state.vr[k] + (1.0 - beta2) * g2.mean(dim=-1)
                vc = beta2 * state.vc[k] + (1.0 - beta2) * g2.mean(dim=-2)
                denom = vr.mean(dim=-1, keepdim=True).clamp_min(EPS1)
                u = (g * torch.rsqrt(vr / denom)[..., None]
                     * torch.rsqrt(vc)[..., None, :])
                new_vr[k], new_vc[k], new_vf[k] = vr, vc, state.vf[k]
                dims = (-2, -1)      # per trailing matrix
            else:
                vf = beta2 * state.vf[k] + (1.0 - beta2) * g2
                u = g * torch.rsqrt(vf)
                new_vf[k] = vf
                new_vr[k], new_vc[k] = state.vr[k], state.vc[k]
                # per trailing vector of a stack, whole tensor for a vector
                dims = -1 if p.dim() >= 2 else None
            u = u / torch.clamp(_rms(u, dims) / CLIP_D, min=1.0)
            if beta1 > 0.0:
                u = beta1 * state.m[k] + (1.0 - beta1) * u
                new_m[k] = u
            pf = p.float()
            alpha = (lr * torch.clamp(_rms(pf, dims), min=EPS2)
                     if relative_step else lr)
            wd = (weight_decay if decay_mask is None or decay_mask[k]
                  else 0.0)
            pf = pf - alpha * u - lr * wd * pf
            new_p[k] = pf.to(p.dtype)
    return new_p, AdafactorState(new_vr, new_vc, new_vf, new_m)


def state_bytes(state: AdafactorState) -> int:
    """Total optimizer-state footprint (the point of Adafactor)."""
    return sum(t.numel() * t.element_size()
               for tree in state for t in tree.values())
