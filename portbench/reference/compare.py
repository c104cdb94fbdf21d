"""The numbers that decide `correct`, each a gap between the program's
reading and the reference's, and the check of each against its limit.

Training: `loss_gap`, the largest relative gap of a step's loss;
`grad_gap`, the worst leaf's gap between the two norms of the first
step's clipped gradient; `change_gap`, the worst leaf's gap between the
two norms of the weights' change after the checked steps; `grad_err`,
the worst leaf's norm of the difference between the two first gradients
(over the same denominator), which sees rounding that the norms average
away.  A leaf's gap is
|program norm - reference norm| over the larger of the reference's norm of
that leaf and of the median leaf.  Leaves whose reference gradient is
under a thousandth of the median leaf's (nought to rounding, as the k
bias under softmax, or unused, as a vit model's token table) move under
Adam by round-off alone and are left out of `change_gap`.

Serving: `token_gap`, the widest gap by which a served token's reference
logit lies below the reference's best at that position; `kv_over`, the
share (%) of the K and V values the engine's cache holds for the checked
prompts that lie off the reference's by more than TAU times the rms of
their (prompt, layer, K or V) tensor.

Inference: `logit_over`, the share (%) of the checked logits off by more
than TAU times the rms of the reference's logits; `row_over`, the same
share for the worst single image (an answer judged by itself).

A share beyond TAU separates what the configuration's bf16 arithmetic
does (a thin tail past 4% of the rms) from what int8 does (a fifth of all
values past it): every statistic that scales with the error, its rms or
its largest value, reads only 1.5-2.5x higher under int8 (PERF.md
section 2).
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence

import torch

EXCLUDE_BELOW = 1e-3
TAU = 0.04


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep=None) -> float:
    names = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in ref)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in names)


def moved_leaves(ref_grads: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grads.values())
    return [k for k, g in ref_grads.items() if g >= EXCLUDE_BELOW * med]


def grad_err(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]
             ) -> float:
    """The worst leaf's norm of the difference of two gradients over the
    larger of the reference's norm of that leaf and of the median leaf."""
    diff = {k: float((prog[k].double() - ref[k].double()).norm())
            for k in ref}
    norms = {k: float(ref[k].double().norm()) for k in ref}
    med = statistics.median(norms.values())
    return max(diff[k] / max(norms[k], med) for k in ref)


def train_numbers(prog: dict, ref: dict, s) -> Dict[str, float]:
    from . import layout
    return {
        "loss_gap": loss_gap(prog["losses"], ref["losses"]),
        "grad_gap": leaf_gap(prog["grad_norms"], ref["grad_norms"]),
        "change_gap": leaf_gap(prog["change_norms"], ref["change_norms"],
                               keep=moved_leaves(ref["grad_norms"])),
        "grad_err": grad_err(layout.leaves(prog["first_grads"], s),
                             layout.leaves(ref["first_grads"], s)),
    }


def token_gap(ref_logits: torch.Tensor, token: int) -> float:
    return float(ref_logits.max() - ref_logits[token])


def off(prog: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """A bool tensor: where prog lies off ref by more than TAU times the
    rms of ref."""
    p, r = prog.double(), ref.double()
    return (p - r).abs() > TAU * r.square().mean().sqrt()


def check(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """{name: {"value", "limit", "ok"}} for every limit; a number that is
    missing or not finite fails."""
    out = {}
    for name, limit in limits.items():
        value = numbers.get(name)
        ok = value is not None and value == value and value <= limit
        out[name] = {"value": value, "limit": limit, "ok": bool(ok)}
    return out
