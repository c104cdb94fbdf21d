"""Fully sharded data parallelism (FSDP, ZeRO-3) and its hybrid form: the
port of `vitrs_tpu/parallel/fsdp.py` (and the FSDP half of
`parallel/muon_parallel.py`) on `torch.distributed`.

The JAX module states only the layout at rest and lets GSPMD insert the
collectives.  Here they are written out, one process a rank:

  * each parameter is stored as the rank's slice along the axis `spec_for`
    picks (the largest axis the shard count divides, ties to the later
    axis; the JAX rule, so that the slices equal JAX's shards), or whole
    where no axis divides;
  * the step all-gathers each tensor over the fsdp group for use, runs the
    loss and backward on the rank's share of the batch, reduce-scatters
    each gradient back to the slice (all-reduces a replicated one), then,
    in the hybrid form, all-reduces the slice over the replica group, and
    divides by the world size: the rank's slice of the global mean
    gradient;
  * AdamW (`optimizer.adamw_tree`, as in JAX: not K7) updates the slices,
    with m and v sharded like their parameters: nothing of the state
    exists whole.

The hybrid mesh (`make_hybrid_mesh(replica, shard)`) is replica x fsdp
process subgroups: rank r is shard r % shard of replica r // shard, as the
JAX mesh's devices reshape to (replica, shard); the batch is split over
all ranks in rank order.

Adafactor's factored statistics need whole rows and columns: its step
gathers each gradient whole (an all-reduce) and runs the one-device
`adafactor.step` on whole tensors, with the state (O(rows + cols) a matrix,
whole for 1-D leaves) kept on every rank; each rank keeps its slice of the
new parameters.  Muon's state is sharded like its parameters: the momentum
updates its slice, and Newton-Schulz, which needs the whole matrix,
gathers it, iterates and keeps the rank's slice of the result.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..config import ViTConfig
from ..models import model as M
from ..ops import optimizer as opt
from ..ops._build import to_device
from . import collectives as C

AXIS = "fsdp"
REPLICA = "replica"


@dataclasses.dataclass(frozen=True)
class FsdpMesh:
    """One rank's view of a (replica, fsdp) mesh: its device, its global
    rank, the two axis sizes and their process groups (None: the default
    group)."""
    device: torch.device
    rank: int
    replica: int
    shard: int
    fsdp_group: object = None
    replica_group: object = None

    @property
    def size(self) -> int:
        return self.replica * self.shard

    @property
    def shard_rank(self) -> int:
        return self.rank % self.shard


def _world(n: int, device) -> tuple:
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n != world:
        raise RuntimeError(f"an FSDP mesh of {n} ranks in a world of {world}:"
                           f" one process a rank (parallel/multihost."
                           f"initialize, or torchrun)")
    return torch.device(device), (dist.get_rank() if world > 1 else 0)


def make_mesh(n_devices: int = 0, device="cuda") -> FsdpMesh:
    """FSDP over every rank of the world (n_devices, if given, must equal
    the world size); `device` is this rank's."""
    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    dev, rank = _world(n, device)
    return FsdpMesh(dev, rank, 1, n)


def make_hybrid_mesh(replica: int, shard: int, device="cuda") -> FsdpMesh:
    """FSDP inside groups of `shard` ranks x plain DP across `replica` of
    them.  Every rank builds every subgroup, in one order (new_group's
    contract)."""
    dev, rank = _world(replica * shard, device)
    fsdp_group = replica_group = None
    for r in range(replica):
        g = dist.new_group([r * shard + i for i in range(shard)])
        if rank // shard == r:
            fsdp_group = g
    for i in range(shard):
        g = dist.new_group([r * shard + i for r in range(replica)])
        if rank % shard == i:
            replica_group = g
    return FsdpMesh(dev, rank, replica, shard, fsdp_group, replica_group)


def spec_for(shape: Sequence[int], n: int) -> Optional[int]:
    """The axis to shard over n ranks: the largest that n divides (ties to
    the later axis), else None (replicated)."""
    best, best_dim = None, -1
    for i, d in enumerate(shape):
        if d % n == 0 and d >= best_dim:
            best, best_dim = i, d
    return best


def param_specs(params, mesh: FsdpMesh) -> Dict[str, Optional[int]]:
    """{name: sharded axis or None} of a dict of tensors, arrays or
    shapes."""
    return {k: spec_for(tuple(getattr(v, "shape", v)), mesh.shard)
            for k, v in params.items()}


def take_shard(t: torch.Tensor, axis: Optional[int],
               mesh: FsdpMesh) -> torch.Tensor:
    """The rank's slice of a whole tensor (a copy; the whole tensor for a
    replicated leaf)."""
    if axis is None:
        return t.clone()
    size = t.shape[axis] // mesh.shard
    return t.narrow(axis, mesh.shard_rank * size, size).contiguous()


def gather(t: torch.Tensor, axis: Optional[int],
           mesh: FsdpMesh) -> torch.Tensor:
    """The whole tensor from the ranks' slices (fsdp group)."""
    if axis is None or mesh.shard == 1:
        return t
    moved = t.movedim(axis, 0).contiguous()
    out = moved.new_empty((moved.shape[0] * mesh.shard, *moved.shape[1:]))
    C.all_gather(out, moved, mesh.fsdp_group)
    return out.movedim(0, axis).contiguous()


def reduce_grad(g: torch.Tensor, axis: Optional[int],
                mesh: FsdpMesh) -> torch.Tensor:
    """The rank's slice of the mean over all ranks of a whole gradient:
    reduce-scatter over the fsdp group, all-reduce over the replica group,
    divide by the world size (a replicated leaf: all-reduce over all)."""
    if mesh.size == 1:
        return g
    if axis is None:
        return C.all_reduce(g.contiguous(), None) / mesh.size
    moved = g.movedim(axis, 0).contiguous()
    out = moved.new_empty((moved.shape[0] // mesh.shard, *moved.shape[1:]))
    C.reduce_scatter(out, moved, mesh.fsdp_group)
    if mesh.replica > 1:
        C.all_reduce(out, mesh.replica_group)
    return (out / mesh.size).movedim(0, axis).contiguous()


def place_params(params, mesh: FsdpMesh) -> Dict[str, torch.Tensor]:
    """A whole parameter dict (numpy or tensors, equal on every rank) ->
    the rank's slices on its device, in fp32."""
    specs = param_specs(params, mesh)
    out = {}
    for k, v in params.items():
        t = to_device(np.asarray(v, np.float32) if not isinstance(
            v, torch.Tensor) else v.float(), mesh.device)
        out[k] = take_shard(t, specs[k], mesh)
    return out


def to_canonical(params: Dict[str, torch.Tensor], specs: Dict,
                 mesh: FsdpMesh) -> Dict[str, np.ndarray]:
    """Whole tensors on the host (every rank gets them)."""
    return {k: gather(t, specs[k], mesh).detach().cpu().numpy()
            for k, t in params.items()}


def init_opt_state(params: Dict[str, torch.Tensor], mesh: FsdpMesh):
    """AdamW (m, v): zeros shaped like each parameter's slice."""
    return tuple({k: torch.zeros_like(v) for k, v in params.items()}
                 for _ in range(2))


def batch_tensors(x, y, cfg: ViTConfig, device):
    """A rank's rows (numpy or tensors) on its device: tokens as int64 or
    images as fp32, and int64 targets."""
    x = to_device(x, device)
    y = to_device(y, device).long()
    return (x.long() if cfg.mode != "vit" else x.float()), y


def _loss_and_full_grads(params, specs, mesh, cfg, inputs, targets):
    """Gather every tensor, run the loss and backward on the rank's batch:
    (loss on this rank, whole params, whole gradients)."""
    full = {k: gather(t, specs[k], mesh).detach().requires_grad_(True)
            for k, t in params.items()}
    x, y = batch_tensors(inputs, targets, cfg, mesh.device)
    loss = M.loss_fn(full, x, y, cfg)
    loss.backward()
    return loss.detach(), full, {k: t.grad for k, t in full.items()}


def _mean_loss(loss, mesh):
    return C.all_reduce(loss, None) / mesh.size if mesh.size > 1 else loss


def make_fsdp_train_step(cfg: ViTConfig, mesh: FsdpMesh, params,
                         weight_decay: float = 0.1):
    """The FSDP AdamW step: (params, m, v, inputs, targets, step, lr) ->
    (params, m, v, loss), params/m/v the rank's slices, inputs/targets the
    rank's share of the batch.  `params` gives the whole shapes (a dict of
    shapes or whole tensors), which fix the specs; so in the two other
    factories."""
    specs = param_specs(params, mesh)

    def step_fn(params, m, v, inputs, targets, step, lr):
        loss, _, grads = _loss_and_full_grads(params, specs, mesh, cfg,
                                              inputs, targets)
        grads = {k: reduce_grad(g, specs[k], mesh) for k, g in grads.items()}
        params, m, v = opt.adamw_tree(params, grads, m, v, step, float(lr),
                                      weight_decay=weight_decay)
        return params, m, v, _mean_loss(loss, mesh)

    return step_fn


# --- Adafactor under FSDP ---------------------------------------------------

def init_af_state(shapes, mesh: FsdpMesh):
    """Adafactor state of the whole tensors, on the rank's device; `shapes`
    a dict of whole shapes (or whole tensors)."""
    from ..ops import adafactor as AF
    return AF.init_state({
        k: torch.zeros(tuple(getattr(v, "shape", v)), dtype=torch.float32,
                       device=mesh.device) for k, v in shapes.items()})


def make_fsdp_train_step_adafactor(cfg: ViTConfig, mesh: FsdpMesh, params,
                                   weight_decay_2d_only: bool = True,
                                   relative_step: bool = True):
    """The FSDP Adafactor step: (params, state, inputs, targets, step, lr,
    wd) -> (params, state, loss); params the rank's slices, state whole."""
    from ..ops import adafactor as AF
    specs = param_specs(params, mesh)

    def step_fn(params, st, inputs, targets, step, lr, wd):
        loss, full, grads = _loss_and_full_grads(params, specs, mesh, cfg,
                                                 inputs, targets)
        if mesh.size > 1:
            grads = {k: C.all_reduce(g, None) / mesh.size
                     for k, g in grads.items()}
        full = {k: t.detach() for k, t in full.items()}
        mask = opt.decay_mask_2d(full) if weight_decay_2d_only else None
        new_full, st = AF.step(full, grads, st, step, lr, weight_decay=wd,
                               decay_mask=mask, relative_step=relative_step)
        params = {k: take_shard(t, specs[k], mesh)
                  for k, t in new_full.items()}
        return params, st, _mean_loss(loss, mesh)

    return step_fn


# --- Muon under FSDP (vitrs_tpu/parallel/muon_parallel.py:292-342) ---------

def init_fsdp_muon_state(params: Dict[str, torch.Tensor], mesh: FsdpMesh):
    """MuonState with every leaf shaped like its parameter's slice."""
    from ..ops import muon as MU
    return MU.init_state(params)


def make_fsdp_muon_train_step(cfg: ViTConfig, mesh: FsdpMesh, params,
                              weight_decay: float = 0.0):
    """The FSDP hybrid Muon/AdamW step: (params, state, inputs, targets,
    step, lr, alr) -> (params, state, loss), AdamW's step being step + 1
    as in JAX.  The momentum and the AdamW moments update the rank's
    slices; Newton-Schulz gathers each matrix whole, iterates, and keeps
    the slice."""
    from ..ops import muon as MU
    specs = param_specs(params, mesh)

    def ortho(key, eff):
        axis = specs[key]
        o, scale = MU.orthogonalize(key, gather(eff, axis, mesh))
        return take_shard(o, axis, mesh), scale

    def step_fn(params, state, inputs, targets, step, lr, alr):
        loss, _, grads = _loss_and_full_grads(params, specs, mesh, cfg,
                                              inputs, targets)
        grads = {k: reduce_grad(g, specs[k], mesh) for k, g in grads.items()}
        params, state = MU.step(params, grads, state, step + 1, lr,
                                adamw_lr=alr, weight_decay=weight_decay,
                                ortho=ortho)
        return params, state, _mean_loss(loss, mesh)

    return step_fn
