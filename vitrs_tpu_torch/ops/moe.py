"""Mixture-of-Experts MLP — top-k token routing with static capacity; the
port of `vitrs_tpu/ops/moe.py` on one device.

The JAX package computes all of it in XLA, outside any Pallas kernel, so the
port computes it in plain PyTorch on either device, with the same shapes:

  * routing:   one (S, E) fp32 router matmul, softmax, the top k of E (ties
               to the lower expert index, as `lax.top_k` breaks them), and a
               cumulative sum over the one-hot assignments in k-major order
               for each assignment's slot in its expert's queue (all first
               choices claim slots before any second choice, the Switch
               rule);
  * dispatch:  a row gather into a dense (E·cap, C) buffer; assignments past
               an expert's capacity are dropped;
  * experts:   one batched matmul over the stacked (E, 4C, C) / (E, C, 4C)
               weights, accumulated in fp32 and rounded to the compute dtype
               before the bias adds, as the JAX `_expert_ffn` does;
  * combine:   a row gather back to token order, weighted by the
               renormalised top-k router probabilities, summed in fp32.

Dispatch and combine are `torch.autograd.Function`s whose backward, like the
JAX `custom_vjp`s, is row gathers only: with both directions of the slot map
at hand — dst (K, S), the slot of each assignment (E·cap where dropped), and
inv (E·cap,), the k-major assignment index of each slot (K·S where empty) —
every data movement forward and backward is a gather.  Autograd's own
backward of `index_select` or fancy indexing is `index_add_`, whose CUDA
atomics make a step that is not bitwise repeatable; these Functions keep the
MoE layer repeatable.  The one scatter left builds the int inv.

The auxiliary losses returned to the caller (weighted in models/model.py):
load balance E · Σ_e f_e · P_e (1.0 at uniform routing) and the router
z-loss mean(logsumexp(logits)²).

Expert parallelism (`moe_mlp(ep_group=)`, parallel/expert_parallel.py):
the expert leaves arrive as the rank's (E/ep, ...) shard; routing,
capacity (from the rank's own S) and dispatch stay local, then one tiled
all-to-all over the expert group sends each rank's slots for the peers'
experts out ((E, cap, C) -> (E/ep, ep*cap, C)), the expert FFN runs on the
rank's experts, and the inverse all-to-all brings the slots home before the
combine (`parallel/collectives.all_to_all`, whose backward is the reverse
hop).  With `tp_group` each expert's FFN is also split over a model group
(fcw/fcb column-sharded on 4C, fcprojw row-sharded): the conjugate
copy-in / reduce-out of parallel/tensor_parallel.py wrap it.

Not ported: the JAX module's timing switches (MOE_DIAG, BATCHED_GATHER).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import basic


class MoEAux(NamedTuple):
    """Router health: auxiliary losses and an occupancy diagnostic (0-d
    fp32 tensors)."""
    load_balance: torch.Tensor   # 1.0 at uniform routing
    z_loss: torch.Tensor         # mean squared router logsumexp
    # fraction of the S·top_k assignments that fit within capacity (1.0 =
    # no token dropped); a diagnostic, not differentiable
    kept_fraction: torch.Tensor


def capacity(num_tokens: int, num_experts: int, top_k: int,
             cap_factor: float) -> int:
    """Static per-expert slot count: ceil(S·K/E · factor), at least 8 and
    rounded up to a multiple of 8, as in the JAX package (which slots are
    kept depends on it)."""
    cap = math.ceil(num_tokens * top_k * cap_factor / num_experts)
    cap = max(cap, 8)
    return -(-cap // 8) * 8


def ordered_top_k(probs: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest values of each row and their indices, largest first and
    equal values in index order (`lax.top_k`'s order; `torch.topk` promises
    none).  Differentiable in the values."""
    v, i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def router(x_flat: torch.Tensor, routerw: torch.Tensor, k: int, cap: int):
    """Route S tokens to k of E experts under a static capacity.

    Returns (dst, weight, keep, aux):
      dst    (K, S) int64 — flat slot index into the (E·cap) dispatch
                            buffer; E·cap (one past the end) where dropped;
      weight (K, S) fp32  — the renormalised top-k router probability (the
                            mass of dropped assignments is lost);
      keep   (K, S) bool  — the assignment fit within capacity."""
    S = x_flat.shape[0]
    E = routerw.shape[0]
    # the router always runs in fp32: bf16 logits perturb the top-k order
    logits = x_flat.float() @ routerw.float().t()            # (S, E)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = ordered_top_k(probs, k)                     # (S, K)
    weight = (topv / topv.sum(dim=-1, keepdim=True)).t().contiguous()

    # slot assignment: one-hot over experts in k-major priority order, one
    # row per expert, so the cumulative sum runs along contiguous memory
    # (JAX sums down the (K·S, E) columns; PyTorch's scan over an outer dim
    # of E = 8 columns runs 8 threads and took a quarter of the step)
    oh = F.one_hot(topi, E).to(torch.int32).permute(2, 1, 0).reshape(
        E, k * S)                                             # (E, K·S)
    # 0-based position of each assignment within its expert's queue
    pos = (torch.cumsum(oh, dim=1, dtype=torch.int32) - 1) * oh
    slot = pos.sum(dim=0).reshape(k, S)                       # (K, S)
    expert = topi.t()
    keep = slot < cap
    dst = torch.where(keep, expert * cap + slot,
                      torch.full_like(expert, E * cap))

    f = oh.float().mean(dim=1)                                # (E,)
    p_mean = probs.mean(dim=0)
    lb = E * (f * p_mean).sum()
    zl = torch.logsumexp(logits, dim=-1).square().mean()
    return dst, weight, keep, MoEAux(lb, zl, keep.float().mean())


def build_inverse(dst: torch.Tensor, E: int, cap: int) -> torch.Tensor:
    """(K, S) slot map -> (E·cap,) k-major assignment index of each slot
    (K·S where the slot is empty).  Dropped assignments (dst = E·cap) land
    on one sink slot past the end, which is cut off."""
    K, S = dst.shape
    inv = torch.full((E * cap + 1,), K * S, dtype=torch.int64,
                     device=dst.device)
    inv.scatter_(0, dst.reshape(-1),
                 torch.arange(K * S, dtype=torch.int64, device=dst.device))
    return inv[:E * cap]


def _slot_tok(inv: torch.Tensor, K: int, S: int) -> torch.Tensor:
    """Slot -> source token row; empty slots -> S (one past the end)."""
    return torch.where(inv < K * S, inv % S, S)


def _pad_rows(a: torch.Tensor) -> torch.Tensor:
    """a (N, C) with a zero row N appended: the fill row of JAX's
    `jnp.take(..., mode="fill", fill_value=0)` at one-past-the-end
    indices.  Each Function pads a source once, for all its gathers."""
    return torch.cat([a, a.new_zeros(1, a.shape[1])])


def _rows(padded: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of a padded (N + 1, C) source at idx (any shape, values <= N;
    N gives zeros)."""
    return padded.index_select(0, idx.reshape(-1)).reshape(
        *idx.shape, padded.shape[1])


class _Dispatch(torch.autograd.Function):
    """xs (S, C) -> buf (E·cap, C) by a gather at inv; the backward
    gathers at dst and sums over k in the input dtype."""

    @staticmethod
    def forward(ctx, xs, inv, dst):
        K, S = dst.shape
        ctx.save_for_backward(dst)
        return _rows(_pad_rows(xs), _slot_tok(inv, K, S))

    @staticmethod
    def backward(ctx, dbuf):
        (dst,) = ctx.saved_tensors
        dbuf = _pad_rows(dbuf)
        dxs = _rows(dbuf, dst[0])
        for k in range(1, dst.shape[0]):
            dxs = dxs + _rows(dbuf, dst[k])
        return dxs, None, None


class _Combine(torch.autograd.Function):
    """out[s] = Σ_k weight[k, s] · ys[dst[k, s]] in fp32; the backward is
    gathers both ways (dys at inv, dweight at dst)."""

    @staticmethod
    def forward(ctx, ys, weight, inv, dst):
        K, S = dst.shape
        ys = _pad_rows(ys)               # kept padded for the backward
        ctx.save_for_backward(ys, weight, inv, dst)
        out = torch.zeros(S, ys.shape[1], dtype=torch.float32,
                          device=ys.device)
        for k in range(K):
            out = out + weight[k][:, None] * _rows(ys, dst[k]).float()
        return out

    @staticmethod
    def backward(ctx, dout):
        ys, weight, inv, dst = ctx.saved_tensors
        K, S = dst.shape
        # each slot's combine weight: the flat (K·S,) weight at inv
        wflat = torch.cat([weight.reshape(K * S), weight.new_zeros(1)])[inv]
        dys = (wflat[:, None] * _rows(_pad_rows(dout), _slot_tok(inv, K, S))
               ).to(ys.dtype)
        dw = torch.stack([
            (dout * _rows(ys, dst[k]).float()).sum(dim=-1)
            for k in range(K)])
        return dys, dw, None, None


dispatch = _Dispatch.apply     # (xs, inv, dst) -> buf
combine = _Combine.apply       # (ys, weight, inv, dst) -> out, fp32


def _expert_ffn(xe: torch.Tensor, fcw: torch.Tensor, fcb: torch.Tensor,
                fcprojw: torch.Tensor, fcprojb: torch.Tensor,
                erf: bool, tp_group=None) -> torch.Tensor:
    """Batched expert MLP (E, cap, C) -> (E, cap, C) in two batched
    matmuls.  Each product accumulates in fp32 and rounds to the compute
    dtype before its bias adds in that dtype (the JAX op's order, which
    `basic.linear` shares only for one matrix).  tp_group: fcw/fcb arrive
    column-sharded on 4C, fcprojw row-sharded; copy-in before the first
    product and reduce-out after the second make the activation gradients
    exact (the JAX `tp_axis`)."""
    dt = xe.dtype
    if tp_group is not None:
        from ..parallel.tensor_parallel import copy_in_group
        xe = copy_in_group(xe, tp_group)
    h = torch.matmul(xe, fcw.to(dt).transpose(1, 2))         # (E, cap, 4C)
    h = h + fcb.to(dt)[:, None, :]
    hg = basic.gelu_erf_cv(h) if erf else basic.gelu_cv(h)
    y = torch.matmul(hg, fcprojw.to(dt).transpose(1, 2))     # (E, cap, C)
    if tp_group is not None:
        from ..parallel.tensor_parallel import reduce_out_group
        y = reduce_out_group(y, tp_group)
    return y + fcprojb.to(dt)[:, None, :]


def moe_mlp(x: torch.Tensor, routerw: torch.Tensor, fcw: torch.Tensor,
            fcb: torch.Tensor, fcprojw: torch.Tensor, fcprojb: torch.Tensor,
            *, top_k: int, cap_factor: float, erf: bool = False,
            ep_group=None, tp_group=None
            ) -> Tuple[torch.Tensor, MoEAux]:
    """The MoE replacement for the dense MLP branch.

    x (B, T, C) or (S, C); expert-stacked weights routerw (E, C), fcw
    (E, 4C, C), fcb (E, 4C), fcprojw (E, C, 4C), fcprojb (E, C).  The
    capacity comes from this call's own token count S.  Returns (out, aux),
    out shaped and typed like x.  ep_group: expert parallelism over that
    group's ep ranks, the expert leaves the rank's (E/ep, ...) shard,
    routerw whole; tp_group: each expert's FFN split over that model group
    (module docstring)."""
    orig_shape = x.shape
    C = orig_shape[-1]
    xs = x.reshape(-1, C)
    S = xs.shape[0]
    E = routerw.shape[0]
    ep = 1 if ep_group is None else torch.distributed.get_world_size(
        ep_group)
    if ep > 1 and (E % ep or fcw.shape[0] != E // ep):
        raise ValueError(f"expert parallelism over {ep} ranks needs E ({E}) "
                         f"divisible by ep and fcw's E/ep shard, got "
                         f"{tuple(fcw.shape)}")
    cap = capacity(S, E, top_k, cap_factor)
    dst, weight, _, aux = router(xs, routerw, top_k, cap)
    inv = build_inverse(dst, E, cap)
    buf = dispatch(xs, inv, dst).reshape(E, cap, C)
    if ep > 1:
        from ..parallel.collectives import all_to_all
        # (E, cap, C) -> (E/ep, ep*cap, C): every peer's slots for this
        # rank's experts, stacked on the slot axis; then the way home
        y = _expert_ffn(all_to_all(buf, 0, 1, ep_group), fcw, fcb, fcprojw,
                        fcprojb, erf, tp_group)
        y = all_to_all(y, 1, 0, ep_group)
    else:
        y = _expert_ffn(buf, fcw, fcb, fcprojw, fcprojb, erf, tp_group)
    out = combine(y.reshape(E * cap, C), weight, inv, dst)
    return out.to(x.dtype).reshape(orig_shape), aux


def dense_equivalent(x: torch.Tensor, routerw: torch.Tensor,
                     fcw: torch.Tensor, fcb: torch.Tensor,
                     fcprojw: torch.Tensor, fcprojb: torch.Tensor, *,
                     top_k: int, erf: bool = False) -> torch.Tensor:
    """Capacity-free oracle (tests only): every token runs every expert
    densely, combined by the same renormalised top-k weights.  The dispatch
    path must match it whenever nothing is dropped."""
    C = x.shape[-1]
    xs = x.reshape(-1, C)
    E = routerw.shape[0]
    probs = torch.softmax(xs.float() @ routerw.float().t(), dim=-1)
    topv, topi = ordered_top_k(probs, top_k)
    w_full = torch.zeros_like(probs)
    for k in range(top_k):
        w_full = w_full + F.one_hot(topi[:, k], E).float() * (
            topv[:, k] / topv.sum(dim=-1))[:, None]
    act = basic.gelu_erf if erf else basic.gelu
    outs = [basic.linear(act(basic.linear(xs, fcw[e], fcb[e])), fcprojw[e],
                         fcprojb[e]) for e in range(E)]
    stack = torch.stack(outs, dim=1).float()                  # (S, E, C)
    out = (w_full[..., None] * stack).sum(dim=1)
    return out.to(x.dtype).reshape(x.shape)
