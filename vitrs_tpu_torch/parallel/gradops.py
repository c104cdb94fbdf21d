"""Gradient transforms over sharded gradient trees: the port of
`vitrs_tpu/parallel/gradops.py`.

The JAX functions run inside a shard_map body and psum over the mesh axes
a leaf's PartitionSpec names.  Here a leaf's spec is the axis it is sharded
on over `group` (parallel/fsdp.py's `spec_for`), or None for a replicated
leaf, which every rank holds whole and which counts once.

* `global_grad_norm`: the global L2 norm; the sharded leaves' sum of
  squares is all-reduced over `group` once.  Equal to the one-device
  sqrt(sum(g**2)) up to the order of the sums.  `mesh_grad_norm` is the
  same on an N-D mesh (tensor_parallel's layouts): a leaf's squares are
  summed over exactly the axes its spec names, once an axis set, as the
  JAX function psums over a PartitionSpec's axes.
* `clip_by_global_norm`: the DP step's clip, scale min(1, clip/(norm +
  1e-6)); the returned norm is the one before the clip.
* `accumulate_microbatches`: the mean loss and mean fp32 gradients over
  `accum_steps` slices of the rank's batch.
* `sum_tree`: a set of tensors summed over one or more groups in one
  all-reduce a group (one flat fp32 buffer), scaled: the gradient
  completion of the expert- and context-parallel steps.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.distributed as dist

from . import collectives as C


def global_grad_norm(grads: Dict[str, torch.Tensor], specs: Dict,
                     group=None) -> torch.Tensor:
    """The global L2 norm of a tree whose leaf k is sharded on axis
    specs[k] over `group` (None: replicated)."""
    some = next(iter(grads.values()))
    zero = torch.zeros((), dtype=torch.float32, device=some.device)
    sharded, replicated = zero.clone(), zero.clone()
    for k, g in grads.items():
        sq = g.float().square().sum()
        if specs[k] is None:
            replicated += sq
        else:
            sharded += sq
    if dist.is_initialized() and dist.get_world_size(group) > 1:
        C.all_reduce(sharded, group)
    return (sharded + replicated).sqrt()


def mesh_grad_norm(grads: Dict[str, torch.Tensor], specs: Dict,
                   mesh) -> torch.Tensor:
    """The global L2 norm of a tree whose leaf k is sliced by the spec
    specs[k] (a tuple of mesh axis names or None per dim) over `mesh`
    (collectives.MeshGroups)."""
    by_axes: Dict[tuple, torch.Tensor] = {}
    for k, g in grads.items():
        axes = tuple(sorted({a for a in specs[k]
                             if a is not None and mesh.size(a) > 1}))
        sq = g.float().square().sum()
        by_axes[axes] = by_axes[axes] + sq if axes in by_axes else sq
    total = None
    for axes, sq in by_axes.items():
        for a in axes:
            C.all_reduce(sq, mesh.group(a))
        total = sq if total is None else total + sq
    return total.sqrt()


def clip_by_global_norm(grads: Dict[str, torch.Tensor], specs: Dict,
                        clip_norm: float, group=None):
    """(clipped grads, the norm before the clip)."""
    gnorm = global_grad_norm(grads, specs, group)
    scale = torch.clamp(clip_norm / (gnorm + 1e-6), max=1.0)
    return {k: g * scale for k, g in grads.items()}, gnorm


def accumulate_microbatches(loss_and_grads: Callable, params, inputs,
                            targets, accum_steps: int):
    """Mean (loss, grads) over `accum_steps` slices of the batch:
    loss_and_grads(params, x, y) -> (loss, grad dict); the gradients are
    summed in fp32."""
    if accum_steps == 1:
        return loss_and_grads(params, inputs, targets)
    micro = inputs.shape[0] // accum_steps
    if micro * accum_steps != inputs.shape[0]:
        raise ValueError(f"local batch {inputs.shape[0]} must divide into "
                         f"accum_steps {accum_steps}")
    loss_sum, g_sum = None, None
    for i in range(accum_steps):
        rows = slice(i * micro, (i + 1) * micro)
        loss, g = loss_and_grads(params, inputs[rows], targets[rows])
        if g_sum is None:
            loss_sum, g_sum = loss, {k: t.float() for k, t in g.items()}
        else:
            loss_sum = loss_sum + loss
            g_sum = {k: g_sum[k] + t.float() for k, t in g.items()}
    inv = 1.0 / accum_steps
    return loss_sum * inv, {k: t * inv for k, t in g_sum.items()}


def sum_tree(tensors: Dict[str, torch.Tensor], groups, scale: float = 1.0
             ) -> Dict[str, torch.Tensor]:
    """Each tensor summed over every group of `groups` (None entries
    skipped: an axis of size 1), times `scale`, as new fp32 tensors: the
    tensors travel as one flat buffer, one all-reduce a group."""
    groups = [g for g in groups if g is not None]
    if not tensors:
        return {}
    keys = list(tensors)
    flat = torch.cat([tensors[k].detach().float().reshape(-1) for k in keys])
    for g in groups:
        C.all_reduce(flat, g)
    if scale != 1.0:
        flat.mul_(scale)
    out, off = {}, 0
    for k in keys:
        n = tensors[k].numel()
        out[k] = flat[off:off + n].view(tensors[k].shape)
        off += n
    return out
