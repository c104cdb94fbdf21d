"""The collectives of the data-parallel families (ZeRO-1, FSDP, hybrid):
reduce-scatter, all-gather, all-reduce, broadcast, barrier, over a
`torch.distributed` process group (None: the whole world).

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
* Sums only: the callers divide by the world size where the JAX code
  takes a mean.
"""

from __future__ import annotations

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


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum `t` over the group, in place."""
    if _staged(t, group):
        h = t.cpu()
        dist.all_reduce(h, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, group=group)
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
