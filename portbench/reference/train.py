"""The plain training step the training cells are held to: the mean
cross-entropy of the batch, its gradient by autograd (in blocks of rows,
summed, so that it fits beside nothing else on the card), the clip to a
global norm, and AdamW with bias correction and decoupled weight decay on
the tensors `layout.decayed` names, all in fp32 at the `Ref`'s precision.

`follow` runs it from the same weights over the same batches as the
program's first steps and returns what the comparison reads: each step's
loss, the per-leaf norms of the first step's clipped gradient (what the
optimizer gets) and the per-leaf norms of the weights' change after the
last step; and the first step's clipped gradient itself, on the host.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

from . import layout
from .model import Ref, ce_sum


def leaf_norms(tensors: Dict[str, torch.Tensor], s) -> Dict[str, float]:
    return {k: float(t.detach().double().norm())
            for k, t in layout.leaves(tensors, s).items()}


def _loss_and_grads(ref: Ref, w, x, y, block: int, vit_norm) -> float:
    """Mean CE over the batch, backpropagated block by block into w's
    .grad; returns the loss."""
    s = ref.s
    n_rows = x.shape[0]
    count = y.numel()
    total = 0.0
    for lo in range(0, n_rows, block):
        xb, yb = x[lo:lo + block], y[lo:lo + block]
        if s.mode == "vit":
            logits = ref.vit_logits(w, xb, *vit_norm)
        else:
            logits = ref.gpt_logits(w, ref.gpt_hidden(w, xb))
        loss = ce_sum(logits, yb) / count
        loss.backward()
        total += float(loss.detach())
        del logits, loss
    return total


def follow(ref: Ref, w0: Dict[str, torch.Tensor],
           batches: Sequence[Tuple[torch.Tensor, torch.Tensor]], hp: dict,
           block: int, vit_norm=None) -> dict:
    """Run len(batches) reference steps from w0 (fp32, not modified).
    hp: lr, weight_decay, clip_norm, beta1, beta2, eps."""
    s = ref.s
    w = {k: t.detach().clone().requires_grad_(True) for k, t in w0.items()}
    m = {k: torch.zeros_like(t) for k, t in w0.items()}
    v = {k: torch.zeros_like(t) for k, t in w0.items()}
    b1, b2, eps = hp["beta1"], hp["beta2"], hp["eps"]
    lr, wd = hp["lr"], hp["weight_decay"]
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    for t, (x, y) in enumerate(batches, start=1):
        for p in w.values():
            p.grad = None
        losses.append(_loss_and_grads(ref, w, x, y, block, vit_norm))
        with torch.no_grad():
            grads = {k: (p.grad if p.grad is not None
                         else torch.zeros_like(p)) for k, p in w.items()}
            gnorm = math.sqrt(sum(float(g.double().square().sum())
                                  for g in grads.values()))
            scale = (min(1.0, hp["clip_norm"] / (gnorm + 1e-6))
                     if hp["clip_norm"] > 0 else 1.0)
            for g in grads.values():
                g.mul_(scale)
            if t == 1:
                grad_norms = leaf_norms(grads, s)
                first = {k: g.to("cpu", copy=True) for k, g in grads.items()}
            bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
            for k, p in w.items():
                g = grads[k]
                m[k].mul_(b1).add_(g * (1.0 - b1))
                v[k].mul_(b2).add_(g * g * (1.0 - b2))
                upd = (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + eps)
                if layout.decayed(k, s):
                    upd = upd + p * wd
                p.sub_(upd * lr)
    with torch.no_grad():
        change = {k: w[k] - w0[k] for k in w}
        change_norms = leaf_norms(change, s)
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change_norms, "first_grads": first}
