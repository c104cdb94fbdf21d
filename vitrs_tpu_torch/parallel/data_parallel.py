"""The data-parallel training step — the port of
`vitrs_tpu/parallel/data_parallel.py` at world size 1.

The JAX step reduce-scatters the flat gradient over a mesh, runs the fused
AdamW on each device's shard (ZeRO-1) and all-gathers the parameters.  On
one device the collectives are identities and the shard is the whole flat
vector, so the port's step is: loss and gradients (with optional
accumulation), the flat gradient's global norm and clip, the optional
matrix-only decay through the flat mask, and one fused AdamW (K7 on the
card) over the flat vector.  More than one device comes with
torch.distributed (ROADMAP.md Queue 1 item 18).

The flat arena: the parameters must be views into one flat fp32 vector in
canonical order (`params.unflatten_params`, as the trainer keeps them).
The step updates that vector in place and writes the gradients into one
flat buffer through the parameters' `.grad` views, so AdamW runs once over
all 124,439,808 values with no flatten copy.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence, Tuple

import torch

from .. import params as PRM
from ..config import ViTConfig
from ..models import model as M
from ..ops import optimizer as opt

_MULTI = ("data parallelism over more than one device: ROADMAP.md Queue 1 "
          "item 18 (torch.distributed)")
_VIT = "vit mode (mixup, normalize): ROADMAP.md Queue 1 item 5"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices of a one-axis ("data") mesh."""
    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int = 0, devices: Sequence = None) -> Mesh:
    """The data mesh over `devices`, else over every CUDA device (the first
    `n_devices` of them).  Without `devices` and without a CUDA device it
    raises: a CPU mesh is asked for by name (devices=["cpu"])."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        devices = devices[:n_devices] if n_devices else devices
        if not devices:
            raise RuntimeError("make_mesh: torch sees no CUDA device; pass "
                               "devices=['cpu'] for a CPU mesh")
    return Mesh(tuple(torch.device(d) for d in devices))


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def opt_state_shard_size(cfg: ViTConfig, mesh: Mesh) -> int:
    return _ceil_to(PRM.num_parameters(cfg), mesh.size) // mesh.size


def init_sharded_opt_state(cfg: ViTConfig, mesh: Mesh):
    """Flat fp32 m and v (one shard: the whole vector at world size 1)."""
    if mesh.size != 1:
        raise NotImplementedError(_MULTI)
    n_pad = opt_state_shard_size(cfg, mesh) * mesh.size
    zeros = functools.partial(torch.zeros, n_pad, dtype=torch.float32,
                              device=mesh.devices[0])
    return zeros(), zeros()


def make_dp_train_step(cfg: ViTConfig, mesh: Mesh, accum_steps: int = 1,
                       return_grad_norm: bool = False,
                       mixup_alpha: float = 0.0,
                       normalize=None, clip_norm: float = 0.0,
                       decay_2d_only: bool = False):
    """Build the training step.

    Signature: (params, m, v, inputs, targets, step, lr, wd)
            -> (params, m, v, loss[, grad_norm])
    as in the JAX package: params a parameter dict (fp32 views into one
    flat vector, `params.unflatten_params`; anything else raises), m and v
    the flat
    AdamW state, inputs and targets a batch (numpy or tensors), step the
    1-based AdamW step, lr and wd scalars.  loss and grad_norm come back as
    0-d tensors on the device (reading them waits for the step).  params, m
    and v are updated in place and returned.

    accum_steps > 1 splits the batch into that many micro-batches whose
    gradients are averaged; clip_norm > 0 clips to that global norm
    (grad_norm is the norm before the clip); decay_2d_only decays only the
    tensors `_decay_mask_flat` marks."""
    if mesh.size != 1:
        raise NotImplementedError(_MULTI)
    if cfg.mode == "vit" or mixup_alpha > 0.0 or normalize is not None:
        raise NotImplementedError(_VIT)
    device = mesh.devices[0]
    n = PRM.num_parameters(cfg)
    grad_buf = {}

    def step_fn(params, m, v, inputs, targets, step, lr, wd):
        flat_p = PRM.flat_base(params, cfg)
        if flat_p is None:
            raise ValueError("make_dp_train_step: params must be views into "
                             "one flat vector (params.unflatten_params)")
        if "g" not in grad_buf:
            grad_buf["g"] = torch.empty_like(flat_p)
        flat_g = grad_buf["g"].zero_()
        for name, g in PRM.unflatten_params(flat_g, cfg).items():
            params[name].requires_grad_(True)
            params[name].grad = g
        x = torch.as_tensor(inputs, device=device).long()
        y = torch.as_tensor(targets, device=device).long()
        micro = x.shape[0] // accum_steps
        loss = torch.zeros((), device=device)
        for i in range(accum_steps):
            rows = slice(i * micro, (i + 1) * micro)
            li = M.loss_fn(params, x[rows], y[rows], cfg)
            li.backward()
            loss += li.detach()
        if accum_steps > 1:
            loss /= accum_steps
            flat_g.mul_(1.0 / accum_steps)
        gnorm = None
        if clip_norm > 0.0 or return_grad_norm:
            # the JAX form; torch.linalg.vector_norm's fp32 CPU reduction
            # loses ~1e-4 relative over millions of values
            gnorm = flat_g.square().sum().sqrt()
        if clip_norm > 0.0:
            flat_g.mul_(torch.clamp(clip_norm / (gnorm + 1e-6), max=1.0))
        lr, wd = float(lr), float(wd)
        if decay_2d_only:
            # AdamW without decay, then the masked decoupled term from the
            # pre-update vector: exact, since AdamW's decay term reads the
            # old p too
            p_old = flat_p.clone()
            opt.adamw_step(flat_p, flat_g, m, v, step, lr, weight_decay=0.0)
            with torch.no_grad():
                flat_p.sub_(_decay_mask_flat(cfg, n, device) * p_old
                            * (lr * wd))
        else:
            opt.adamw_step(flat_p, flat_g, m, v, step, lr, weight_decay=wd)
        if return_grad_norm:
            return params, m, v, loss, gnorm
        return params, m, v, loss

    return step_fn


@functools.lru_cache(maxsize=2)
def _decay_mask_flat(cfg: ViTConfig, n_pad: int, device: torch.device
                     ) -> torch.Tensor:
    """Flat 0/1 mask over the canonical parameter vector: 1 where the
    tensor has >= 2 axes (decayed), 0 elsewhere, zero-padded to n_pad.  As
    in the JAX package, the stacked (L, C) biases and LN parameters count
    as 2-D and are decayed (ROADMAP.md Queue 3)."""
    shapes = PRM.param_shapes(cfg)
    parts = [torch.full((int(torch.Size(shapes[k]).numel()),),
                        1.0 if len(shapes[k]) >= 2 else 0.0)
             for k in PRM.tensor_order(cfg)]
    flat = torch.cat(parts)
    flat = torch.nn.functional.pad(flat, (0, n_pad - flat.shape[0]))
    return flat.to(device)
