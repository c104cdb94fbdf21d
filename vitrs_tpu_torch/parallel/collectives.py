"""The collectives of the mesh families: reduce-scatter, all-gather,
all-reduce, broadcast, barrier over a `torch.distributed` process group
(None: the whole world); the differentiable tiled `all_to_all` (the MoE
dispatch of expert parallelism); point-to-point `send`, `recv` and
`exchange` (the pipeline's and the ring's hops); and `mesh_groups`, the
process groups of an N-D mesh.

The JAX package's steps name these as `lax.psum_scatter`, `all_gather`,
`psum`/`pmean` inside `shard_map`, or leave them to GSPMD; here each is one
call on a flat tensor.

* NCCL takes CUDA tensors in place.  gloo's CUDA forms cover only some
  collectives, so every gloo collective on a CUDA tensor is staged through
  host memory here, explicitly: copy to the CPU, run the collective there,
  copy back.  `route(group, device)` says which path a phase ran.
* The all-gather is `all_gather_single` where the installed torch has it,
  else `all_gather_into_tensor` (its earlier name), and the reduce-scatter
  `reduce_scatter_single`, else `reduce_scatter_tensor`, chosen once below.
* Sums only (and the max `all_reduce(op="max")`): the callers divide by
  the group size where the JAX code takes a mean.
* `mesh_groups` lays ranks out as the JAX meshes lay out devices: row-major
  over the named axes, so (data, model, pipe) puts rank (d*tp + m)*pp + p
  at coordinates (d, m, p), as `make_mesh_3d` reshapes jax.devices().
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_ALL_GATHER = (dist.all_gather_single if hasattr(dist, "all_gather_single")
               else dist.all_gather_into_tensor)
_REDUCE_SCATTER = (dist.reduce_scatter_single
                   if hasattr(dist, "reduce_scatter_single")
                   else dist.reduce_scatter_tensor)


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def route(group, device) -> str:
    """The backend, and whether CUDA tensors go through host memory."""
    backend = dist.get_backend(group)
    staged = torch.device(device).type == "cuda" and backend == "gloo"
    return f"{backend} (staged through host memory)" if staged else backend


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(t: torch.Tensor, group=None, op: str = "sum") -> torch.Tensor:
    """Sum (or max) `t` over the group, in place."""
    if _staged(t, group):
        h = t.cpu()
        dist.all_reduce(h, op=_OPS[op], group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=_OPS[op], group=group)
    return t


def reduce_scatter(out: torch.Tensor, inp: torch.Tensor,
                   group=None) -> torch.Tensor:
    """out = rank r's 1/N block of the group's sum of `inp` (N blocks of
    out's size along the first dimension)."""
    if _staged(inp, group):
        h = torch.empty(out.shape, dtype=out.dtype)
        _REDUCE_SCATTER(h, inp.cpu(), group=group)
        out.copy_(h)
    else:
        _REDUCE_SCATTER(out, inp.contiguous(), group=group)
    return out


def all_gather(out: torch.Tensor, inp: torch.Tensor,
               group=None) -> torch.Tensor:
    """out = the group's `inp` blocks in rank order along the first
    dimension."""
    if _staged(inp, group):
        h = torch.empty(out.shape, dtype=out.dtype)
        _ALL_GATHER(h, inp.cpu(), group=group)
        out.copy_(h)
    else:
        _ALL_GATHER(out, inp.contiguous(), group=group)
    return out


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """`t` from global rank `src` to every rank of the group, in place."""
    if _staged(t, group):
        h = t.cpu()
        dist.broadcast(h, src, group=group)
        t.copy_(h)
    else:
        dist.broadcast(t, src, group=group)
    return t


def barrier(group=None) -> None:
    dist.barrier(group=group)


def _all_to_all(t: torch.Tensor, split_dim: int, concat_dim: int,
                group) -> torch.Tensor:
    n = dist.get_world_size(group)
    parts = torch.stack(t.chunk(n, split_dim))     # (n, ...) contiguous
    if _staged(t, group):
        h = parts.cpu()
        got = torch.empty_like(h)
        dist.all_to_all_single(got, h, group=group)
        got = got.to(t.device)
    else:
        got = torch.empty_like(parts)
        dist.all_to_all_single(got, parts, group=group)
    return torch.cat(got.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, split_dim, concat_dim, group):
        ctx.args = (concat_dim, split_dim, group)
        return _all_to_all(t, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g.contiguous(), *ctx.args), None, None, None


def all_to_all(t: torch.Tensor, split_dim: int, concat_dim: int,
               group=None) -> torch.Tensor:
    """`jax.lax.all_to_all(t, axis, split_dim, concat_dim, tiled=True)`:
    `t` cut into N equal blocks along split_dim, block i sent to the
    group's rank i, the N blocks received concatenated along concat_dim in
    rank order.  Differentiable: the backward is the reverse all-to-all
    (split concat_dim, concat split_dim).  One `all_to_all_single` of the
    stacked blocks (gloo and NCCL both take it)."""
    if (dist.get_world_size(group) if dist.is_initialized() else 1) == 1:
        return t
    return _AllToAll.apply(t, split_dim, concat_dim, group)


# --- point to point ---------------------------------------------------------

def _p2p_staged(t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend() == "gloo"


def send(t: torch.Tensor, dst: int, tag: int = 0) -> None:
    """Send `t` to global rank `dst` (blocking)."""
    dist.send(t.cpu() if _p2p_staged(t) else t.contiguous(), dst, tag=tag)


def recv(t: torch.Tensor, src: int, tag: int = 0) -> torch.Tensor:
    """Receive into `t` from global rank `src` (blocking)."""
    if _p2p_staged(t):
        h = torch.empty(t.shape, dtype=t.dtype)
        dist.recv(h, src, tag=tag)
        t.copy_(h)
    else:
        dist.recv(t, src, tag=tag)
    return t


def exchange(sends: Sequence[Tuple[torch.Tensor, int, int]],
             recvs: Sequence[Tuple[torch.Tensor, int, int]]) -> None:
    """Post every send (tensor, dst, tag) and receive (buffer, src, tag) at
    once (isend / irecv) and wait for all of them: a step of a schedule in
    which neighbours send to each other in the same step cannot deadlock."""
    staged = [(h, t) for t, _, _ in recvs
              for h in [torch.empty(t.shape, dtype=t.dtype)
                        if _p2p_staged(t) else t]]
    work = [dist.isend(t.cpu() if _p2p_staged(t) else t.contiguous(), dst,
                       tag=tag) for t, dst, tag in sends]
    work += [dist.irecv(h, src, tag=tag)
             for (h, _), (_, src, tag) in zip(staged, recvs)]
    for w in work:
        w.wait()
    for h, t in staged:
        if h is not t:
            t.copy_(h)


# --- the groups of an N-D mesh ----------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshGroups:
    """One rank's view of an N-D mesh: its device and global rank, the
    axes' sizes in layout order, its coordinate on each, and each axis's
    process group (None for an axis of size 1: nothing to exchange)."""
    device: torch.device
    rank: int
    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, object]

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self.groups.get(axis)

    def peer(self, axis: str, index: int) -> int:
        """The global rank at `index` on `axis`, the other coordinates
        this rank's."""
        return _rank_of(self.shape, dict(self.coords, **{axis: index}))


def _rank_of(shape: Dict[str, int], coords: Dict[str, int]) -> int:
    r = 0
    for a, n in shape.items():
        r = r * n + coords[a]
    return r


def mesh_groups(shape: Dict[str, int], device,
                rank: Optional[int] = None) -> MeshGroups:
    """The groups of a mesh of `shape` ({axis: size} in layout order, e.g.
    {"data": 2, "model": 2, "pipe": 2}) over the whole world.  Every rank
    creates every group, in one order (new_group's contract)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = 1
    for v in shape.values():
        n *= v
    if n != world:
        raise RuntimeError(f"a mesh {dict(shape)} of {n} ranks in a world of "
                           f"{world}: one process a rank (parallel/multihost."
                           f"initialize, or torchrun)")
    rank = (dist.get_rank() if world > 1 else 0) if rank is None else rank
    coords, r = {}, rank
    for a in reversed(list(shape)):
        coords[a] = r % shape[a]
        r //= shape[a]
    coords = {a: coords[a] for a in shape}
    groups = {}
    for axis, size in shape.items():
        if size == 1:
            continue
        others = [a for a in shape if a != axis]
        grid = [{}]
        for a in others:
            grid = [dict(c, **{a: i}) for c in grid for i in range(shape[a])]
        for c in grid:
            ranks = [_rank_of(shape, dict(c, **{axis: i}))
                     for i in range(size)]
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = g
    return MeshGroups(torch.device(device), rank, dict(shape), coords, groups)
