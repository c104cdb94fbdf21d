"""Ring attention: context parallelism (cp) over a ring of ranks, and the
dp x cp GPT training step - the port of
`vitrs_tpu/parallel/ring_attention.py` on `torch.distributed`, one process
a rank.

The sequence is sharded over the ring ("ctx"): rank idx holds queries,
keys and values at positions [idx*T/n, (idx+1)*T/n).  Its k and v blocks
travel around the ring (one `collectives.exchange` with both neighbours a
hop) while each rank accumulates its queries' attention over every block
it receives; after `_ring_hops` hops every query has seen every key it may
see.  `ring_attention_local` is an autograd.Function that saves only (q,
k, v, out, lse), as the JAX custom_vjp does; its backward is a second ring
in which dk and dv travel WITH their block and arrive home carrying every
rank's contribution; a banded ring that stops early (h < n) sends them home
with one direct exchange.

Layout: the flash kernels' (B, T/n, C) for q and (B, T/n, kv_heads*D) for
k and v (the JAX module takes (B, H, T/n, D); the tests transpose).  Under
GQA only the small kv blocks rotate.

Each hop's block work runs on the flash kernels (ops/flash_attention.py
`launch_fwd` / `launch_bwd`, through the `vitrs::` ops), chosen by the
block's shape only:

  * the diagonal block (src == idx): K1-fwd / K3-fwd causal, with the
    window, and K2 / K3-bwd causal;
  * a past block wholly inside the band (every past block without a
    window): K1-fwd / K3-fwd and K2 / K3-bwd non-causal;
  * a future block (src > idx, causal): nothing to compute (the JAX scan
    computes it fully masked); the block is still forwarded;
  * a past block that the band cuts ("band" hops): the same kernels, causal
    with the window, on the rectangle the band reaches (`_band_window`: the
    queries [0, rows) that see some key of the block against the keys
    [first, T/n) some query sees), the queries at offset q_off - k_off -
    first past the keys' end.  On the 8K training window (W=1024, T/n=4096)
    it is rank 1's one past hop: 1023 rows at offset 1023 against 1023
    keys, a head.  Its hops are counted (`band_hops`); they merge into and
    add to the first `rows` queries and the last keys only.

The forward hops give (out_blk, lse_blk); they merge in fp32 with the lse
weights into the global out and lse.  The backward hops take the global
out and lse, so the kernels' pre-pass forms di = rowsum(out * do) and p =
exp(s - lse) as the JAX backward does; dq and the travelling dk / dv
accumulate in fp32.  No hop materialises a score tensor on the card.  On
the CPU the same hops run on the kernels' plain versions, through the same
ops; on CUDA tensors every hop reaches a kernel, and a block the kernels
refuse raises.

`make_cp_train_step` is the dp x cp step: the encoder at the shard's
global positions (the wpe slice; rope through `rope_qk` at idx*T/n + t,
before the ring, so the kernels run without rope), the pre-LN blocks, the
tied head on the port's own CE route (K5/K6 on the card: the mean CE that
JAX's plain `cross_entropy_from_logits` computes), ZeRO-1 over all dp*cp
ranks with the nested reduce-scatter (over ctx, then data) and K7 on the
rank's shard.  Rank (d, c) updates the flat range at c*(n_pad/cp) +
d*shard, as the JAX step does; its m and v are the (d*cp + c)-th block of
the JAX step's sharded vectors, so `opt_save` carves the same names from
them.  `make_cp_train_step_adafactor` keeps Adafactor's state whole on
every rank and all-reduces the gradients to the mean over both axes.

Departures of the JAX CP loss from the one-device model, kept or refused
(ROADMAP.md Queue 3): it always uses the tanh GELU (`gelu_cv`), whatever
cfg.act says, and ignores remat, use_flash, quirks and dropout - all kept
for parity; it takes a MoE config without its router (the expert slabs
then meet a dense matmul) - refused here (ValueError).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import params as PRM
from ..config import ViTConfig
from ..models import model as M
from ..ops import basic
from ..ops import flash_attention as FA
from ..ops import flash_attention_gqa as FG
from ..ops import optimizer as opt
from ..ops.rope import rope_qk
from . import collectives as C
from . import gradops
from .fsdp import batch_tensors
from .tensor_parallel import _lin, leaf_grads

# hops whose past block the band cuts (the kernels' rectangle), forward
# and backward
band_hops = {"fwd": 0, "bwd": 0}
_TAGS = (71, 72, 73, 74)     # k, v, dk, dv


def _ring_hops(n: int, window: int, Tk: int) -> int:
    """Ring length: n hops dense; banded, a query's oldest key is window-1
    rows back, at most ceil((window-1)/Tk) shards behind, so the ring stops
    after that many extra hops."""
    if not window:
        return n
    return min(n, (max(0, window - 1) + Tk - 1) // Tk + 1)


@dataclasses.dataclass(frozen=True)
class Ring:
    """A rank's place on a ring: its index, the ring's size and the global
    rank of every member in ring order."""
    idx: int
    n: int
    members: Tuple[int, ...]

    def peer(self, offset: int) -> int:
        return self.members[(self.idx + offset) % self.n]


def ring_of(group=None) -> Ring:
    """The ring of a process group (None: the world), members in group-rank
    order."""
    if not dist.is_initialized():
        return Ring(0, 1, (0,))
    members = (tuple(dist.get_process_group_ranks(group)) if group is not None
               else tuple(range(dist.get_world_size())))
    return Ring(dist.get_rank(group), len(members), members)


def _route(ring: Ring, src: int, T: int, causal: bool, window: int):
    """The hop's route by the block's shape: "diag", "past" (non-causal
    kernels), "band" (the causal banded kernels on the rectangle the band
    reaches) or None (a future block)."""
    if not causal:
        return "past"
    if src == ring.idx:
        return "diag"
    if src > ring.idx:
        return None
    # rows - cols spans ((idx - src)*T - T + 1, (idx - src)*T + T - 1]
    if not window or (ring.idx - src) * T + T - 1 < window:
        return "past"
    return "band"


def _rotate(blocks: List[torch.Tensor], ring: Ring,
            offset: int = 1) -> List[torch.Tensor]:
    """Send each block `offset` ranks along the ring and receive the ones
    `offset` ranks back (one exchange)."""
    got = [torch.empty_like(b) for b in blocks]
    C.exchange([(b, ring.peer(offset), t) for b, t in zip(blocks, _TAGS)],
               [(g, ring.peer(-offset), t) for g, t in zip(got, _TAGS)])
    return got


def _band_window(Tq: int, Tk: int, q_off: int, k_off: int, window: int):
    """(rows, first key) of the rectangle a band reaches in a past block:
    the queries [0, rows) that see some key, the keys [first, Tk) that
    some query sees."""
    rows = min(Tq, max(0, k_off + Tk - 1 + window - q_off))
    first = min(Tk, max(0, q_off - window - k_off + 1))
    return rows, first


def _kernel_fwd(q, k, v, H, KH, causal, sm_scale, window, q_offset=0):
    if KH == H:
        return FA.flash_fwd_op(q, k, v, H, causal, sm_scale, window, False,
                               q_offset)
    return FG.flash_gqa_fwd_op(q, k, v, H, KH, causal, sm_scale, window,
                               False, q_offset)


def _kernel_bwd(q, k, v, out, lse, do, H, KH, causal, sm_scale, window,
                q_offset=0):
    if KH == H:
        return FA.flash_bwd_op(q, k, v, out, lse, do, H, causal, sm_scale,
                               window, False, q_offset)
    return FG.flash_gqa_bwd_op(q, k, v, out, lse, do, H, KH, causal,
                               sm_scale, window, False, q_offset)


def _merge(acc, lse, o, l):
    """Two partial softmax results (out (B, T, C), lse (B, NH, T)) -> one,
    weighted by exp(lse_part - lse_total), in fp32."""
    if acc is None:
        return o.float(), l
    new = torch.logaddexp(lse, l)
    ref = torch.where(torch.isfinite(new), new, 0.0)
    B, T, Cq = acc.shape
    H = lse.shape[1]

    def w(x):             # (B, NH, T) weight -> broadcast over (B, T, NH, D)
        return torch.exp(x - ref).transpose(1, 2)[..., None]

    acc = (acc.view(B, T, H, -1) * w(lse)
           + o.float().view(B, T, H, -1) * w(l)).view(B, T, Cq)
    return acc, new


def _ring_fwd(q, k, v, ring: Ring, H: int, causal: bool, window: int):
    B, T, Cq = q.shape
    KH = k.shape[2] * H // Cq
    sm = 1.0 / math.sqrt(Cq // H)
    h = _ring_hops(ring.n, window, T)
    kb, vb = k.contiguous(), v.contiguous()
    acc = lse = None
    for hop in range(h):
        src = (ring.idx - hop) % ring.n
        route = _route(ring, src, T, causal, window)
        if route == "band":
            # never the first hop: the diagonal's merge is in acc
            band_hops["fwd"] += 1
            rows, first = _band_window(T, T, ring.idx * T, src * T, window)
            o, l = _kernel_fwd(q[:, :rows], kb[:, first:], vb[:, first:], H,
                               KH, True, sm, window,
                               (ring.idx - src) * T - first)
            acc[:, :rows], lse[..., :rows] = _merge(
                acc[:, :rows], lse[..., :rows], o, l)
        elif route is not None:
            diag = route == "diag"
            o, l = _kernel_fwd(q, kb, vb, H, KH, diag, sm,
                               window if diag else 0)
            acc, lse = _merge(acc, lse, o, l)
        if hop < h - 1:
            kb, vb = _rotate([kb, vb], ring)
    return acc.to(q.dtype), lse.contiguous()


def _ring_bwd(q, k, v, out, lse, do, ring: Ring, H: int, causal: bool,
              window: int):
    B, T, Cq = q.shape
    KH = k.shape[2] * H // Cq
    sm = 1.0 / math.sqrt(Cq // H)
    h = _ring_hops(ring.n, window, T)
    do = do.contiguous()
    kb, vb = k.contiguous(), v.contiguous()
    dq = torch.zeros((B, T, Cq), device=q.device)
    dkb = torch.zeros(k.shape, device=q.device)
    dvb = torch.zeros(k.shape, device=q.device)
    for hop in range(h):
        src = (ring.idx - hop) % ring.n
        route = _route(ring, src, T, causal, window)
        if route == "band":
            band_hops["bwd"] += 1
            rows, first = _band_window(T, T, ring.idx * T, src * T, window)
            g = _kernel_bwd(q[:, :rows], kb[:, first:], vb[:, first:],
                            out[:, :rows], lse[..., :rows].contiguous(),
                            do[:, :rows], H, KH, True, sm, window,
                            (ring.idx - src) * T - first)
            dq[:, :rows] += g[0].float()
            dkb[:, first:] += g[1].float()
            dvb[:, first:] += g[2].float()
        elif route is not None:
            diag = route == "diag"
            g = _kernel_bwd(q, kb, vb, out, lse, do, H, KH, diag, sm,
                            window if diag else 0)
            dq += g[0].float()
            dkb += g[1].float()
            dvb += g[2].float()
        if hop < h - 1:
            kb, vb, dkb, dvb = _rotate([kb, vb, dkb, dvb], ring)
    if h > 1:
        # dk/dv of block (idx - h + 1) sit here: one exchange takes them
        # home (the next rank after a full ring)
        dkb, dvb = _rotate([dkb, dvb], ring, 1 - h)
    return dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, ring, num_heads, causal, window):
        out, lse = _ring_fwd(q, k, v, ring, num_heads, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (ring, num_heads, causal, window)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_ring_bwd(q, k, v, out, lse, do, *ctx.args),
                None, None, None, None)


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         group=None, n: int = 0, causal: bool = True,
                         window: int = 0, *, num_heads: int) -> torch.Tensor:
    """The rank's shard of ring attention over `group` (None: the world),
    a ring of n ranks (0: the group's size): q (B, T/n, C) at positions
    idx*T/n.., k, v (B, T/n, kv_heads*D) (kv_heads < num_heads: GQA, the
    small blocks rotate); under rope q and k arrive rotated (the kernels
    run without it).  window > 0 (causal) is the banded ring.  Returns the
    local
    out shard (B, T/n, C); differentiable in q, k and v (every rank of the
    ring must run the backward too)."""
    if window and not causal:
        raise ValueError("sliding-window attention is causal-only")
    ring = ring_of(group)
    if n and n != ring.n:
        raise ValueError(f"a ring of {n} over a group of {ring.n} ranks")
    if k.shape[1] != q.shape[1] or v.shape != k.shape:
        raise ValueError(f"ring blocks of one length: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    return _RingAttention.apply(q, k, v, ring, num_heads, causal, window)


# --- the dp x cp GPT training step -------------------------------------------

def make_mesh_dp_cp(dp: int, cp: int, device="cuda") -> C.MeshGroups:
    """The (data, ctx) mesh: rank d*cp + c at coordinates (d, c)."""
    return C.mesh_groups({"data": dp, "ctx": cp}, device)


def check_cp(cfg: ViTConfig, cp: int) -> None:
    """The JAX assertions (gpt configs, max_seq_len % cp), and the port's
    refusal of MoE configs, as ValueErrors."""
    if cfg.mode != "gpt":
        raise ValueError("cp (ring attention) serves gpt configs")
    if cfg.is_moe:
        raise ValueError("cp (ring attention) runs the dense MLP: a MoE "
                         "config is refused (its experts take ep)")
    if cfg.max_seq_len % cp:
        raise ValueError(f"max_seq_len ({cfg.max_seq_len}) must divide over "
                         f"cp ({cp})")


def cp_loss_local(p: Mapping[str, torch.Tensor], tokens: torch.Tensor,
                  targets: torch.Tensor, cfg: ViTConfig,
                  mesh: C.MeshGroups) -> torch.Tensor:
    """The rank's mean loss over its (B/dp, T/cp) tokens: everything but
    attention is pointwise over T, so the blocks run on the sequence shard
    and attention goes around the ring of the ctx group."""
    dtype = getattr(torch, cfg.dtype)
    idx, n = mesh.index("ctx"), mesh.size("ctx")
    T_loc = tokens.shape[1]
    H, KH = cfg.num_heads, cfg.kv_heads
    rope = cfg.pos_emb == "rope"
    if rope:
        x = p["wte"][tokens].to(dtype)
    else:
        x = (p["wte"][tokens]
             + p["wpe"][idx * T_loc:(idx + 1) * T_loc][None]).to(dtype)
    pos = idx * T_loc + torch.arange(T_loc, device=x.device)
    for bp in M.layers(p):
        ln1 = basic.layernorm_cv(x, bp["ln1w"], bp["ln1b"])
        q, k, v = FG.split_gqa(_lin(ln1, bp["qkvw"], bp["qkvb"]), H, KH)
        if rope:
            q, k = rope_qk(q, k, pos, H, KH)
        o = ring_attention_local(q, k, v, mesh.group("ctx"), n, True,
                                 cfg.window, num_heads=H)
        x = x + _lin(o, bp["attprojw"], bp["attprojb"])
        ln2 = basic.layernorm_cv(x, bp["ln2w"], bp["ln2b"])
        x = x + _lin(basic.gelu_cv(_lin(ln2, bp["fcw"], bp["fcb"])),
                     bp["fcprojw"], bp["fcprojb"])
    lnf = basic.layernorm_cv(x, p["lnfw"], p["lnfb"])
    return M.gpt_head_loss(lnf, p["wte"], targets, cfg)


def cp_shard(cfg: ViTConfig, mesh: C.MeshGroups) -> Tuple[int, int, int]:
    """(n_pad, shard, offset): the ZeRO-1 layout over dp*cp ranks; rank
    (d, c) updates [offset, offset + shard) of the zero-padded flat vector,
    offset = c*(n_pad/cp) + d*shard (the nested reduce-scatter's block)."""
    size = mesh.size("data") * mesh.size("ctx")
    n = PRM.num_parameters(cfg)
    n_pad = -(-n // size) * size
    shard = n_pad // size
    off = (mesh.index("ctx") * (n_pad // mesh.size("ctx"))
           + mesh.index("data") * shard)
    return n_pad, shard, off


def place_cp_params(params: Mapping, cfg: ViTConfig,
                    mesh: C.MeshGroups) -> Dict[str, torch.Tensor]:
    """Canonical tensors -> fp32 views into one flat vector on the rank's
    device (every rank the whole)."""
    from ..ops._build import to_device
    flat = torch.cat([torch.as_tensor(np.asarray(params[k], np.float32)
                                      if not isinstance(params[k],
                                                        torch.Tensor)
                                      else params[k].float()).reshape(-1)
                      for k in PRM.tensor_order(cfg)])
    return PRM.unflatten_params(to_device(flat, mesh.device).clone(), cfg)


def init_cp_opt_state(cfg: ViTConfig, mesh: C.MeshGroups):
    """ZeRO-1 m and v: the rank's flat fp32 shard."""
    _, shard, _ = cp_shard(cfg, mesh)
    return tuple(torch.zeros(shard, device=mesh.device) for _ in range(2))


def _sum_scatter(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """The rank's 1/n block of the group's sum of t (t itself at n = 1)."""
    if n == 1:
        return t
    return C.reduce_scatter(t.new_empty(t.shape[0] // n), t, group)


def _gather(t: torch.Tensor, group, n: int) -> torch.Tensor:
    if n == 1:
        return t
    return C.all_gather(t.new_empty(t.shape[0] * n), t, group)


def _mean_loss(loss: torch.Tensor, mesh: C.MeshGroups) -> torch.Tensor:
    inv = 1.0 / (mesh.size("data") * mesh.size("ctx"))
    return gradops.sum_tree({"l": loss.reshape(1)}, (mesh.group("ctx"),
                                                     mesh.group("data")),
                            inv)["l"][0]


def make_cp_train_step(cfg: ViTConfig, mesh: C.MeshGroups):
    """The dp x cp AdamW step: (params, m, v, inputs, targets, step, lr, wd)
    -> (params, m, v, loss); params the whole canonical dict as views into
    one flat vector (`place_cp_params`, updated in place), m and v the
    rank's ZeRO-1 shards (`init_cp_opt_state`), inputs and targets the
    rank's (B/dp, T/cp) block."""
    from .data_parallel import _grads_into_arena
    dp_n, cp_n = mesh.size("data"), mesh.size("ctx")
    check_cp(cfg, cp_n)
    n = PRM.num_parameters(cfg)
    n_pad, shard, off = cp_shard(cfg, mesh)
    lo, hi = min(off, n), min(off + shard, n)
    grad_buf = {}

    def step_fn(params, m, v, inputs, targets, step, lr, wd):
        flat_p, flat_g = _grads_into_arena(params, cfg, grad_buf,
                                           "make_cp_train_step")
        x, y = batch_tensors(inputs, targets, cfg, mesh.device)
        loss = cp_loss_local(params, x, y, cfg, mesh)
        loss.backward()
        g = torch.nn.functional.pad(flat_g, (0, n_pad - n))
        g = _sum_scatter(_sum_scatter(g, mesh.group("ctx"), cp_n),
                         mesh.group("data"), dp_n)
        g.mul_(1.0 / (dp_n * cp_n))
        k = hi - lo
        opt.adamw_step(flat_p[lo:hi], g[:k], m[:k], v[:k], step, float(lr),
                       weight_decay=float(wd))
        with torch.no_grad():
            mine = torch.zeros(shard, device=mesh.device)
            mine[:k] = flat_p[lo:hi]
            full = _gather(_gather(mine, mesh.group("data"), dp_n),
                           mesh.group("ctx"), cp_n)
            flat_p.copy_(full[:n])
        return params, m, v, _mean_loss(loss.detach(), mesh)

    return step_fn


def cp_opt_to_named(shard: torch.Tensor, cfg: ViTConfig,
                    mesh: C.MeshGroups) -> Dict[str, np.ndarray]:
    """The ranks' m (or v) shards gathered in rank order (the JAX step's
    sharded vector) and carved to canonical names (a collective)."""
    full = _gather(shard.contiguous(), None, mesh.size("data")
                   * mesh.size("ctx"))[:PRM.num_parameters(cfg)]
    return {k: t.cpu().numpy() for k, t in PRM.unflatten_params(
        full.float(), cfg).items()}


def cp_opt_from_named(tree: Mapping, cfg: ViTConfig,
                      mesh: C.MeshGroups) -> torch.Tensor:
    """The rank's shard of a named m (or v), as `cp_opt_to_named` carves
    it: block rank of the flat vector."""
    n_pad, shard, _ = cp_shard(cfg, mesh)
    flat = np.concatenate([np.asarray(tree[k], np.float32).reshape(-1)
                           for k in PRM.tensor_order(cfg)])
    flat = np.pad(flat, (0, n_pad - flat.shape[0]))
    return torch.as_tensor(flat[mesh.rank * shard:(mesh.rank + 1) * shard]
                           ).to(mesh.device)


def make_cp_grads(cfg: ViTConfig, mesh: C.MeshGroups):
    """(params, inputs, targets) -> (the global mean loss, its gradient,
    whole on every rank): each rank's gradient all-reduced to the mean
    over both axes (the Adafactor step's; the AdamW step reduce-scatters
    instead)."""
    inv = 1.0 / (mesh.size("data") * mesh.size("ctx"))

    def fn(params, inputs, targets):
        x, y = batch_tensors(inputs, targets, cfg, mesh.device)
        leaves = {k: t.detach().requires_grad_(True)
                  for k, t in params.items()}
        loss = cp_loss_local(leaves, x, y, cfg, mesh)
        loss.backward()
        grads = leaf_grads(leaves)
        grads["_loss"] = loss.detach().reshape(1)
        grads = gradops.sum_tree(grads, (mesh.group("ctx"),
                                         mesh.group("data")), inv)
        return grads.pop("_loss")[0], grads
    return fn


def make_cp_train_step_adafactor(cfg: ViTConfig, mesh: C.MeshGroups):
    """The dp x cp Adafactor step: (params, state, inputs, targets, step,
    lr, wd) -> (params, state, loss); params and state whole on every rank
    (the state is about 1e-4 of AdamW's), the gradients all-reduced to the
    mean over both axes; lr the relative step, weight decay on the 2-D
    matrices only, as the JAX step."""
    from ..ops import adafactor as AF
    check_cp(cfg, mesh.size("ctx"))
    grads_fn = make_cp_grads(cfg, mesh)

    def step_fn(params, st, inputs, targets, step, lr, wd):
        loss, grads = grads_fn(params, inputs, targets)
        params, st = AF.step(params, grads, st, step, lr,
                             weight_decay=float(wd),
                             decay_mask=opt.decay_mask_2d(params))
        return params, st, loss

    return step_fn
