"""LoRA, low-rank adaptation for parameter-efficient finetuning — the port
of `vitrs_tpu/models/lora.py`.

The base weights stay frozen and each target matrix learns a rank-r update
W' = W + (alpha / r) B A.  Adapters are stacked on the leading L axis like
the canonical tensors: {name + "_a": (L, r, IC), name + "_b": (L, OC, r)},
B zero at init so that the adapted model starts equal to the base.

The merge is recomputed every step and the merged weights feed the
ordinary model, so every kernel of the training step (the fused qkv +
flash attention op, K5/K6 on the loss) serves LoRA unchanged; autograd
reaches the adapters through the merge and through the fused qkv op's
backward.  The base tensors take no gradient (requires_grad stays False)
and have no optimizer state: `lora_train_step` differentiates in the
adapters only.  The product B A is an fp32 matmul with TF32 off in both
directions (`_delta`), then the sum is cast to the parameter's dtype, as
the JAX function computes it (`preferred_element_type=float32`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..config import ViTConfig
from ..ops.optimizer import adamw_tree
from ..params import param_shapes
from . import model as M

# the four per-layer weight matrices (attention + MLP): "all linear layers"
LORA_TARGETS = ("qkvw", "attprojw", "fcw", "fcprojw")


class _no_tf32:
    """Plain fp32 products inside the block (cuBLAS may otherwise take
    TF32 for an fp32 matmul when the process allows it)."""

    def __enter__(self):
        self.prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.prev


class _Delta(torch.autograd.Function):
    """B A per layer, (L, OC, r) x (L, r, IC) -> (L, OC, IC), in fp32
    without TF32 in the forward and in the backward."""

    @staticmethod
    def forward(ctx, b, a):
        ctx.save_for_backward(b, a)
        with _no_tf32():
            return torch.bmm(b, a)

    @staticmethod
    def backward(ctx, g):
        b, a = ctx.saved_tensors
        with _no_tf32():
            return (torch.bmm(g, a.transpose(1, 2)),
                    torch.bmm(b.transpose(1, 2), g))


def init_lora(cfg: ViTConfig, generator: torch.Generator, rank: int = 8,
              targets: Tuple[str, ...] = LORA_TARGETS
              ) -> Dict[str, torch.Tensor]:
    """A ~ N(0, 0.02), B = 0 (adapted == base at init), fp32 on
    `generator.device`."""
    shapes = param_shapes(cfg)
    lora = {}
    for name in targets:
        L, OC, IC = shapes[name]
        lora[name + "_a"] = torch.randn((L, rank, IC), generator=generator,
                                        device=generator.device) * 0.02
        lora[name + "_b"] = torch.zeros((L, OC, rank),
                                        device=generator.device)
    return lora


def lora_rank(lora: Dict[str, torch.Tensor]) -> int:
    for name, t in lora.items():
        if name.endswith("_a"):
            return t.shape[1]
    raise ValueError("empty lora tree")


def apply_lora(params: Dict[str, torch.Tensor], lora: Dict[str, torch.Tensor],
               alpha: float = 16.0) -> Dict[str, torch.Tensor]:
    """The merged weights W + (alpha / r) B A for every adapted target, in
    the parameter's dtype; the other tensors pass through as they are."""
    scale = alpha / lora_rank(lora)
    out = dict(params)
    for name in params:
        if name + "_a" in lora:
            delta = _Delta.apply(lora[name + "_b"].float(),
                                 lora[name + "_a"].float())
            out[name] = (params[name].float() + scale * delta).to(
                params[name].dtype)
    return out


def merge_lora(params: Dict[str, torch.Tensor], lora: Dict[str, torch.Tensor],
               alpha: float = 16.0) -> Dict[str, torch.Tensor]:
    """The adapters baked into a standalone parameter dict (for serving, or
    a checkpoint through the standard writer), outside autograd."""
    with torch.no_grad():
        return {k: v.detach() for k, v in apply_lora(params, lora,
                                                     alpha).items()}


def init_lora_opt(lora: Dict[str, torch.Tensor]):
    """AdamW's (m, v) for the adapters only: fp32 zeros."""
    return ({k: torch.zeros_like(t) for k, t in lora.items()},
            {k: torch.zeros_like(t) for k, t in lora.items()})


def lora_train_step(lora: Dict[str, torch.Tensor], m: Dict, v: Dict, step,
                    params: Dict[str, torch.Tensor], inputs: torch.Tensor,
                    targets: torch.Tensor, cfg: ViTConfig, lr: float = 1e-4,
                    alpha: float = 16.0, weight_decay: float = 0.0):
    """One AdamW step on the adapters only (AdamW's step count is step +
    1, as in the JAX function): (loss before the update, adapters, m, v).
    The base `params` are read, never differentiated."""
    leaves = {k: t.detach().requires_grad_(True) for k, t in lora.items()}
    loss = M.loss_fn(apply_lora(params, leaves, alpha), inputs, targets, cfg)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    lora, m, v = adamw_tree(lora, dict(zip(leaves, grads)), m, v,
                            int(step) + 1, lr, weight_decay=weight_decay)
    return loss.detach(), lora, m, v
