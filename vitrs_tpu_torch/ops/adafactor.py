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
one package loads in the other.

Under tensor parallelism (parallel/tensor_parallel.py, threed.py) `step`
takes the JAX arguments: `shard_axes` marks which trailing dim of a leaf
is sliced over the model group (`group`, the JAX `axis_name`), and every
mean that crosses it is completed by a mean over the group (gathered
statistics: the one-device update up to the order of the sums);
`factored` fixes each leaf's factored / full decision from its whole
shape, which a rank's slice may not show (C/tp < 128).
`shard_axes_from_specs` derives the map from the leaves' specs.
Slicing a leading (stack) axis, as the pipeline does, needs no entry.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

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
    return factored_shape(tuple(p.shape))


def factored_shape(shape: Sequence[int], min_factor: int = MIN_FACTOR) -> bool:
    """Whether a tensor of `shape` keeps factored row / column statistics."""
    return len(shape) >= 2 and min(shape[-2:]) >= min_factor


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


def _mean_sq(x: torch.Tensor, dims, group, sharded: bool) -> torch.Tensor:
    """mean(x²) over `dims` (kept; None: the whole tensor), completed over
    `group` when the dims cross a sharded one (equal-sized slices, so the
    mean of the slices' means)."""
    m = (x.square().mean() if dims is None
         else x.square().mean(dim=dims, keepdim=True))
    return _group_mean(m, group, sharded)


def _group_mean(x: torch.Tensor, group, sharded: bool) -> torch.Tensor:
    if not sharded or group is None:
        return x
    from ..parallel import collectives as C
    return C.all_reduce(x.contiguous().clone(), group) / dist.get_world_size(
        group)


def step(params: Mapping[str, torch.Tensor],
         grads: Mapping[str, torch.Tensor], state: AdafactorState, t, lr,
         beta1: float = 0.0, weight_decay: float = 0.0,
         decay_mask: Optional[Mapping[str, bool]] = None,
         relative_step: bool = True,
         shard_axes: Optional[Mapping[str, Optional[int]]] = None,
         group=None, factored: Optional[Mapping[str, bool]] = None):
    """One Adafactor step over the parameter dict: returns (new params in
    each parameter's dtype, new state), as the JAX function does.  t is the
    1-based step (the β2 schedule), lr the schedule's value (times
    max(RMS(param), EPS2) under relative_step).  shard_axes, group and
    factored: the tensor-parallel arguments (module docstring)."""
    # β2 in fp32 on the host, as the JAX step computes it from t
    tf = np.float32(max(float(t), 1.0))
    beta2 = float(np.float32(1.0) - tf ** np.float32(-0.8))
    lr = float(lr)
    new_p, new_vr, new_vc, new_vf, new_m = {}, {}, {}, {}, {}
    with torch.no_grad():
        for k, p in params.items():
            sd = (shard_axes or {}).get(k)
            fac = (factored[k] if factored is not None
                   else factored_shape(tuple(p.shape)))
            g = grads[k].float()
            g2 = g.square() + EPS1
            if fac:
                vr = beta2 * state.vr[k] + (1.0 - beta2) * _group_mean(
                    g2.mean(dim=-1), group, sd == -1)
                vc = beta2 * state.vc[k] + (1.0 - beta2) * _group_mean(
                    g2.mean(dim=-2), group, sd == -2)
                # vr's last dim is p's row dim: sharded iff sd == -2
                denom = _group_mean(vr.mean(dim=-1, keepdim=True), group,
                                    sd == -2).clamp_min(EPS1)
                u = (g * torch.rsqrt(vr / denom)[..., None]
                     * torch.rsqrt(vc)[..., None, :])
                new_vr[k], new_vc[k], new_vf[k] = vr, vc, state.vf[k]
                # per trailing matrix
                dims, sharded = (-2, -1), sd is not None
            else:
                vf = beta2 * state.vf[k] + (1.0 - beta2) * g2
                u = g * torch.rsqrt(vf)
                new_vf[k] = vf
                new_vr[k], new_vc[k] = state.vr[k], state.vc[k]
                # per trailing vector of a stack, whole tensor for a vector
                dims = -1 if p.dim() >= 2 else None
                sharded = p.dim() >= 2 and sd == -1
            rms_u = _mean_sq(u, dims, group, sharded).sqrt()
            u = u / torch.clamp(rms_u / CLIP_D, min=1.0)
            if beta1 > 0.0:
                u = beta1 * state.m[k] + (1.0 - beta1) * u
                new_m[k] = u
            pf = p.float()
            if relative_step:
                rms_p = _mean_sq(pf, dims, group, sharded).sqrt()
                alpha = lr * torch.clamp(rms_p, min=EPS2)
            else:
                alpha = lr
            wd = (weight_decay if decay_mask is None or decay_mask[k]
                  else 0.0)
            pf = pf - alpha * u - lr * wd * pf
            new_p[k] = pf.to(p.dtype)
    return new_p, AdafactorState(new_vr, new_vc, new_vf, new_m)


def shard_axes_from_specs(shapes: Mapping[str, Sequence[int]],
                          specs: Mapping[str, tuple], axis: str
                          ) -> Dict[str, Optional[int]]:
    """The `step(shard_axes=...)` map from each leaf's whole shape and spec
    (a tuple naming the mesh axis of each sharded dim): -1 / -2 where that
    trailing dim is sliced over `axis`, else None (a sliced leading dim
    needs nothing)."""
    out = {}
    for k, shape in shapes.items():
        nd = len(shape)
        sp = tuple(specs[k]) + (None,) * (nd - len(tuple(specs[k])))
        sd = None
        if nd >= 2:
            if sp[-1] == axis:
                sd = -1
            elif sp[-2] == axis:
                sd = -2
        out[k] = sd
    return out


def state_specs(shapes: Mapping[str, Sequence[int]],
                specs: Mapping[str, tuple],
                factored: Optional[Mapping[str, bool]] = None
                ) -> AdafactorState:
    """The spec of each state leaf, given each parameter's whole shape and
    spec: vr drops the last dim, vc the second-to-last, a full vf is
    sliced like its parameter, the 0-d placeholders are whole.  factored:
    the decision per leaf (default: from the whole shape)."""
    vr, vc, vf = {}, {}, {}
    for k, shape in shapes.items():
        nd = len(shape)
        sp = tuple(specs[k]) + (None,) * (nd - len(tuple(specs[k])))
        if factored[k] if factored is not None else factored_shape(shape):
            vr[k], vc[k], vf[k] = sp[:-1], sp[:-2] + sp[-1:], ()
        else:
            vr[k], vc[k], vf[k] = (), (), sp
    return AdafactorState(vr, vc, vf, {})


def state_shapes(shapes: Mapping[str, Sequence[int]],
                 factored: Optional[Mapping[str, bool]] = None
                 ) -> AdafactorState:
    """The whole shape of each state leaf (`init_state`'s layout)."""
    vr, vc, vf = {}, {}, {}
    for k, shape in shapes.items():
        shape = tuple(shape)
        if factored[k] if factored is not None else factored_shape(shape):
            vr[k], vc[k], vf[k] = shape[:-1], shape[:-2] + shape[-1:], ()
        else:
            vr[k], vc[k], vf[k] = (), (), shape
    return AdafactorState(vr, vc, vf, {})


def state_bytes(state: AdafactorState) -> int:
    """Total optimizer-state footprint (the point of Adafactor)."""
    return sum(t.numel() * t.element_size()
               for tree in state for t in tree.values())
