"""Muon — MomentUm Orthogonalized by Newton-Schulz (Jordan et al., 2024);
the port of `vitrs_tpu/ops/muon.py` on one device.

For each per-layer weight matrix Muon replaces the elementwise Adam update
with the nearest semi-orthogonal matrix to the (Nesterov) momentum,
approximated by five quintic Newton-Schulz iterations in bf16.  The JAX
package computes the iteration as batched matmuls in XLA, outside any
Pallas kernel; the port runs the same chain as bf16 batched `torch.matmul`
(fp32 accumulation, bf16 results), over the stacked (L, OC, IC) and
(L, E, OC, IC) layouts at once.

Hybrid policy, as in the JAX package: Muon for MUON_KEYS (the per-layer
matrices and vit mode's patch embedding), AdamW (`optimizer.adamw_tree`,
decay masked by `decay_mask_2d`) for everything else; the Muon update is
scaled by max(1, rows/cols) ** 0.5 over the last two dims.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Tuple

import torch

from . import optimizer as opt

# the per-layer 2-D matrices Muon owns; everything else goes to AdamW
MUON_KEYS = ("qkvw", "attprojw", "fcw", "fcprojw", "patchw")

MOMENTUM = 0.95  # Muon's (Nesterov) momentum
NS_STEPS = 5     # Newton-Schulz iterations
NS_EPS = 1e-7    # added to the Frobenius norm

# quintic Newton-Schulz coefficients (Jordan's tuned values 3.4445, -4.7750,
# 2.0315) as the JAX package applies them: a Python float meeting a bf16
# array is rounded to bf16 there (weak-type promotion), while torch would
# keep it in fp32, so the port rounds them itself (3.4375, -4.78125,
# 2.03125); with that, the chain matches the JAX package's bit for bit on
# small matrices
_NS_A, _NS_B, _NS_C = (float(torch.tensor(c, dtype=torch.bfloat16))
                       for c in (3.4445, -4.7750, 2.0315))


def newton_schulz5(g: torch.Tensor) -> torch.Tensor:
    """Approximate U Vᵀ of the SVD of g (..., n, m), in bf16: the norm in
    fp32, then NS_STEPS iterations of bf16 products."""
    x = g.to(torch.bfloat16)
    tall = x.shape[-2] > x.shape[-1]
    if tall:
        x = x.transpose(-1, -2)
    xf = x.float()
    norm = xf.square().sum(dim=(-2, -1), keepdim=True).sqrt() + NS_EPS
    x = (xf / norm).to(torch.bfloat16)
    for _ in range(NS_STEPS):
        a = x @ x.transpose(-1, -2)
        b = _NS_B * a + _NS_C * (a @ a)
        x = _NS_A * x + b @ x
    if tall:
        x = x.transpose(-1, -2)
    return x


class MuonState(NamedTuple):
    momentum: Dict[str, torch.Tensor]     # Muon leaves
    m: Dict[str, torch.Tensor]            # AdamW first moment (the rest)
    v: Dict[str, torch.Tensor]            # AdamW second moment


def split_muon(params: Mapping[str, torch.Tensor]) -> Tuple[Dict, Dict]:
    """(muon_leaves, adamw_leaves) by the hybrid policy."""
    muon = {k: v for k, v in params.items() if k in MUON_KEYS}
    rest = {k: v for k, v in params.items() if k not in MUON_KEYS}
    return muon, rest


def init_state(params: Mapping[str, torch.Tensor]) -> MuonState:
    """Zero state on each parameter's device, in its dtype."""
    muon, rest = split_muon(params)
    z = lambda t: {k: torch.zeros_like(v) for k, v in t.items()}  # noqa: E731
    return MuonState(momentum=z(muon), m=z(rest), v=z(rest))


def orthogonalize(key: str, eff: torch.Tensor):
    """(Newton-Schulz of eff in fp32, the aspect scale max(1, rows/cols)
    ** 0.5 over the last two dims): Muon's update direction for one
    matrix."""
    scale = max(1.0, eff.shape[-2] / eff.shape[-1]) ** 0.5
    return newton_schulz5(eff).float(), scale


def step(params: Mapping[str, torch.Tensor],
         grads: Mapping[str, torch.Tensor], state: MuonState, step_i,
         lr: float, adamw_lr: float, weight_decay: float = 0.0,
         ortho=orthogonalize):
    """One hybrid Muon/AdamW step: returns (new params, new state).  lr is
    the Muon learning rate, adamw_lr AdamW's; weight_decay is decoupled on
    the Muon matrices and AdamW's own elsewhere.  step_i is AdamW's 1-based
    step.  `ortho(key, eff)` gives the update direction and its scale
    (`orthogonalize`; the FSDP step's gathers the sharded matrix first and
    keeps the rank's slice)."""
    lr = float(lr)
    muon_p, rest_p = split_muon(params)
    new_mom, new_p = {}, {}
    with torch.no_grad():
        for k, p in muon_p.items():
            gf = grads[k].float()
            buf = MOMENTUM * state.momentum[k] + gf
            eff = gf + MOMENTUM * buf       # Nesterov
            o, scale = ortho(k, eff)
            pf = p.float()
            if weight_decay:
                pf = pf * (1.0 - lr * weight_decay)
            new_p[k] = (pf - lr * scale * o).to(p.dtype)
            new_mom[k] = buf
    rest_new, m, v = opt.adamw_tree(
        rest_p, {k: grads[k] for k in rest_p}, state.m, state.v, step_i,
        float(adamw_lr), weight_decay=weight_decay,
        decay_mask=opt.decay_mask_2d(rest_p))
    new_p.update(rest_new)
    return new_p, MuonState(momentum=new_mom, m=m, v=v)
