"""Tensor parallelism (Megatron), with sequence and vocab parallelism, over
a (data, model) mesh: the port of `vitrs_tpu/parallel/tensor_parallel.py`
on `torch.distributed`, one process a rank.

The block's matmuls split as in the JAX module:

  attn:  qkv  = x · Wqkv_colᵀ      heads sharded over "model" (column)
         out  = all_reduce(atty · Wproj_rowᵀ)                   (row)
  mlp:   fch  = gelu(x · Wfc_colᵀ)  4C sharded                  (column)
         out  = all_reduce(fch · Wproj_rowᵀ)                    (row)

with the conjugate collectives written as autograd.Functions over the model
group: `copy_in` (identity forward, all-reduce backward) guards each
parallel branch's input so that replicated tensors get their whole
gradient; `reduce_out` (all-reduce forward, identity backward) combines the
row-parallel partials.  Sequence parallelism (SP) keeps the residual stream
between blocks sharded on T: `gather_seq` (all-gather forward,
reduce-scatter backward) enters a block's column-parallel matmul,
`scatter_seq_sum` (reduce-scatter forward, all-gather backward) leaves its
row-parallel one, `scatter_seq` / `gather_seq_rep` enter and leave the SP
region.  The LN and bias leaves whose compute runs on sequence shards
(SP_PARTIAL_GRADS) get partial gradients, summed over the model group.

Each rank's attention runs its NH/tp heads: `ops/attention.attention` on
the packed local qkv (3·C/tp channels), so K1-fwd and K2 at NH/tp heads on
the card (rope inside the kernel when pos_emb is "rope").  GQA takes
separate qw/kw/vw leaves and expands K/V on the shard (kv_heads % tp == 0),
as the JAX module does, so it runs K1 as well.

Vocab parallelism (VP, gpt mode) shards the tied wte over the padded vocab
(`fused_ce.pad_vocab(V)` = 50304 rows at GPT-2): the embedding sums the
in-shard lookups over the model group, and the head + CE combine the
shards' max (all-reduce max) and sums (`reduce_out`) with the pad columns
masked to -inf.  The JAX package computes these in plain jnp, outside any
Pallas kernel; so does the port, in plain torch.  Without VP the
replicated head takes `models/model.gpt_head_loss` (the fused CE, K5/K6,
where it takes the shape).

Parameters on a rank are the local slices of the TP layout
(`to_tp_params`: MHA qkvw as (L, 3, C, C), head-aligned thirds; GQA as
qw/kw/vw), each leaf sliced by its spec: a tuple naming the mesh axis of
each sharded dim (None: whole), the counterpart of a PartitionSpec
(`tp_param_specs`).  `take`, `gather`, `place_tree` and `gather_tree` move
between whole tensors and slices for any such spec; the pipeline and the
3-D mesh use them too.  AdamW is `optimizer.adamw_tree` over the slices
(not K7), as in JAX; Adafactor completes its row and column statistics
across the model group (`ops/adafactor.step(shard_axes=...)`).

The refusals are ValueErrors with the JAX assertions' words: MoE under TP,
num_heads or kv_heads not divisible by tp, SP with T % tp != 0 (ViT-B/16's
T = 197), VP outside gpt mode.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import params as PRM
from ..config import ViTConfig
from ..models import model as M
from ..ops import basic, fused_ce, optimizer as opt
from ..ops._build import to_device
from ..ops.attention import attention, expand_kv_heads
from . import collectives as C
from . import gradops
from .fsdp import batch_tensors

Spec = Tuple[Optional[str], ...]


def make_mesh_2d(dp: int, tp: int, device="cuda") -> C.MeshGroups:
    """The (data, model) mesh: rank d*tp + m at coordinates (d, m)."""
    return C.mesh_groups({"data": dp, "model": tp}, device)


# --- layouts: whole tensors <-> a rank's slices ------------------------------

def _padded(spec: Spec, ndim: int) -> Spec:
    return tuple(spec) + (None,) * (ndim - len(tuple(spec)))


def local_shape(shape: Sequence[int], spec: Spec,
                mesh: C.MeshGroups) -> Tuple[int, ...]:
    return tuple(d // (mesh.size(a) if a else 1)
                 for d, a in zip(shape, _padded(spec, len(shape))))


def take(t: torch.Tensor, spec: Spec, mesh: C.MeshGroups) -> torch.Tensor:
    """The rank's slice of a whole tensor (a contiguous copy)."""
    for dim, a in enumerate(_padded(spec, t.dim())):
        if a is not None and mesh.size(a) > 1:
            n = t.shape[dim] // mesh.size(a)
            t = t.narrow(dim, mesh.index(a) * n, n)
    return t.contiguous().clone()


def gather(t: torch.Tensor, spec: Spec, mesh: C.MeshGroups) -> torch.Tensor:
    """The whole tensor from the ranks' slices (all-gathers over each
    sharded dim's axis)."""
    for dim, a in enumerate(_padded(spec, t.dim())):
        n = mesh.size(a) if a else 1
        if n == 1:
            continue
        moved = t.movedim(dim, 0).contiguous()
        out = moved.new_empty((moved.shape[0] * n, *moved.shape[1:]))
        C.all_gather(out, moved, mesh.group(a))
        t = out.movedim(0, dim)
    return t.contiguous()


def place_tree(host: Mapping, specs: Mapping[str, Spec],
               mesh: C.MeshGroups) -> Dict[str, torch.Tensor]:
    """Whole tensors (numpy or torch, equal on every rank) -> the rank's
    fp32 slices on its device."""
    out = {}
    for k, v in host.items():
        t = v.float() if isinstance(v, torch.Tensor) else torch.as_tensor(
            np.asarray(v, np.float32))
        out[k] = take(to_device(t, mesh.device), specs[k], mesh)
    return out


def gather_tree(tree: Mapping[str, torch.Tensor], specs: Mapping[str, Spec],
                mesh: C.MeshGroups) -> Dict[str, np.ndarray]:
    """The whole tensors on the host (a collective: every rank calls it)."""
    return {k: gather(t.detach(), specs[k], mesh).cpu().numpy()
            for k, t in tree.items()}


def data_mean(t: torch.Tensor, mesh: C.MeshGroups) -> torch.Tensor:
    n = mesh.size("data")
    return C.all_reduce(t.contiguous(), mesh.group("data")) / n if n > 1 else t


def leaf_grads(leaves: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each leaf's gradient (zeros where the loss does not read it, as
    jax.grad gives)."""
    return {k: (t.grad if t.grad is not None else torch.zeros_like(t))
            for k, t in leaves.items()}


# --- conjugate collectives for Megatron autodiff ----------------------------

def _ag(x: torch.Tensor, mesh: C.MeshGroups, axis: str) -> torch.Tensor:
    """All-gather the sequence shards (dim 1) in rank order."""
    n = mesh.size(axis)
    xc = x.contiguous()
    out = xc.new_empty((n * xc.shape[0], *xc.shape[1:]))
    C.all_gather(out, xc, mesh.group(axis))
    out = out.view(n, *xc.shape).movedim(0, 1)
    return out.reshape(xc.shape[0], n * xc.shape[1], *xc.shape[2:])


def _rs(x: torch.Tensor, mesh: C.MeshGroups, axis: str) -> torch.Tensor:
    """Sum over the group, then keep the rank's sequence block (dim 1)."""
    n = mesh.size(axis)
    B, T = x.shape[0], x.shape[1]
    parts = x.reshape(B, n, T // n, *x.shape[2:]).movedim(1, 0).contiguous()
    out = x.new_empty((B, T // n, *x.shape[2:]))
    C.reduce_scatter(out, parts.view(n * B, T // n, *x.shape[2:]),
                     mesh.group(axis))
    return out


def _slice_own(x: torch.Tensor, mesh: C.MeshGroups, axis: str):
    ts = x.shape[1] // mesh.size(axis)
    return x[:, mesh.index(axis) * ts:(mesh.index(axis) + 1) * ts]


def _all_reduce_copy(x: torch.Tensor, group):
    return C.all_reduce(x.clone(memory_format=torch.contiguous_format), group)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_copy(g, ctx.group), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_copy(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _ag(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _rs(g, ctx.mesh, ctx.axis), None, None


class _GatherSeqRep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _ag(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _slice_own(g, ctx.mesh, ctx.axis).contiguous(), None, None


class _ScatterSeqSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _rs(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _ag(g, ctx.mesh, ctx.axis), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _slice_own(x, mesh, axis).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _ag(g, ctx.mesh, ctx.axis), None, None


def _conjugate(fn):
    def apply(x, mesh: C.MeshGroups, axis: str = "model"):
        return x if mesh.size(axis) == 1 else fn.apply(x, mesh, axis)
    apply.__doc__ = fn.__doc__
    return apply


def _over_group(fn):
    def apply(x, mesh: C.MeshGroups, axis: str = "model"):
        return x if mesh.size(axis) == 1 else fn.apply(x, mesh.group(axis))
    return apply


copy_in = _over_group(_CopyIn)            # identity fwd, all-reduce bwd
reduce_out = _over_group(_ReduceOut)      # all-reduce fwd, identity bwd
# the same two over a bare process group (the expert FFN's model group,
# ops/moe.py)
copy_in_group = _CopyIn.apply
reduce_out_group = _ReduceOut.apply
gather_seq = _conjugate(_GatherSeq)       # all-gather fwd, reduce-scatter bwd
gather_seq_rep = _conjugate(_GatherSeqRep)  # all-gather fwd, slice-own bwd
scatter_seq_sum = _conjugate(_ScatterSeqSum)  # reduce-scatter fwd, gather bwd
scatter_seq = _conjugate(_ScatterSeq)     # slice-own fwd, all-gather bwd


# --- the tensor-parallel blocks ----------------------------------------------

def _lin(x: torch.Tensor, w: torch.Tensor,
         b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX `basic.linear`: the fp32 master cast to x's dtype."""
    return basic.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))


def _gelu(cfg: ViTConfig):
    return basic.gelu_erf_cv if cfg.act == "gelu_erf" else basic.gelu_cv


def _tp_qkv(ln1: torch.Tensor, p: Mapping[str, torch.Tensor],
            cfg: ViTConfig):
    """(q, k, v, heads_local) from the shard's projection leaves, unrotated
    (rope is applied inside attention).  GQA: K/V expanded on the shard,
    which owns whole query groups."""
    D = cfg.head_size
    if "qw" in p:
        q = _lin(ln1, p["qw"], p["qb"])
        k = _lin(ln1, p["kw"], p["kb"])
        v = _lin(ln1, p["vw"], p["vb"])
        hl, kvl = q.shape[-1] // D, k.shape[-1] // D
        return (q, expand_kv_heads(k, kvl, hl), expand_kv_heads(v, kvl, hl),
                hl)
    q = _lin(ln1, p["qkv3w"][0], p["qkv3b"][0])
    k = _lin(ln1, p["qkv3w"][1], p["qkv3b"][1])
    v = _lin(ln1, p["qkv3w"][2], p["qkv3b"][2])
    return q, k, v, q.shape[-1] // D


def _attend(ln1, p, cfg: ViTConfig, causal: bool) -> torch.Tensor:
    q, k, v, hl = _tp_qkv(ln1, p, cfg)
    return attention(torch.cat([q, k, v], dim=-1), hl, causal=causal,
                     window=cfg.window, rope=cfg.pos_emb == "rope",
                     use_flash=cfg.use_flash)


def _tp_block(x: torch.Tensor, p: Mapping[str, torch.Tensor],
              cfg: ViTConfig, causal: bool, mesh: C.MeshGroups,
              axis: str = "model") -> torch.Tensor:
    """The block with column/row-parallel matmuls; p holds layer l's local
    slices (qkv3w (3, C/tp, C), attprojw (C, C/tp), fcw (4C/tp, C),
    fcprojw (C, 4C/tp)), the LN leaves and the row-parallel biases whole."""
    ln1 = copy_in(basic.layernorm_cv(x, p["ln1w"], p["ln1b"]), mesh, axis)
    atty = _attend(ln1, p, cfg, causal)
    attproj = reduce_out(_lin(atty, p["attprojw"]), mesh, axis) + p["attprojb"]
    x = x + attproj.to(x.dtype)
    ln2 = copy_in(basic.layernorm_cv(x, p["ln2w"], p["ln2b"]), mesh, axis)
    fch = _gelu(cfg)(_lin(ln2, p["fcw"], p["fcb"]))
    fcproj = reduce_out(_lin(fch, p["fcprojw"]), mesh, axis) + p["fcprojb"]
    return x + fcproj.to(x.dtype)


def _tp_sp_block(x_s: torch.Tensor, p: Mapping[str, torch.Tensor],
                 cfg: ViTConfig, causal: bool, mesh: C.MeshGroups,
                 axis: str = "model") -> torch.Tensor:
    """The sequence-parallel block: x_s is the (B, T/tp, C) residual
    shard; the projections see the gathered (B, T, C), so the kernels'
    positions 0..T-1 are the true ones."""
    ln1 = gather_seq(basic.layernorm_cv(x_s, p["ln1w"], p["ln1b"]), mesh,
                     axis)
    atty = _attend(ln1, p, cfg, causal)
    attproj = scatter_seq_sum(_lin(atty, p["attprojw"]), mesh,
                              axis) + p["attprojb"]
    x_s = x_s + attproj.to(x_s.dtype)
    ln2 = gather_seq(basic.layernorm_cv(x_s, p["ln2w"], p["ln2b"]), mesh,
                     axis)
    fch = _gelu(cfg)(_lin(ln2, p["fcw"], p["fcb"]))
    fcproj = scatter_seq_sum(_lin(fch, p["fcprojw"]), mesh,
                             axis) + p["fcprojb"]
    return x_s + fcproj.to(x_s.dtype)


def tp_layers(p: Mapping[str, torch.Tensor], cfg: ViTConfig):
    """Each local layer's block leaves (views, one unbind a stacked
    leaf)."""
    keys = tuple(tp_block_specs(cfg))
    per = {k: p[k].unbind(0) for k in keys}
    return [{k: per[k][i] for k in keys} for i in range(len(per[keys[0]]))]


def run_blocks(h: torch.Tensor, layers, cfg: ViTConfig, causal: bool,
               mesh: C.MeshGroups, sequence_parallel: bool) -> torch.Tensor:
    block = _tp_sp_block if sequence_parallel else _tp_block
    for bp in layers:
        h = block(h, bp, cfg, causal, mesh)
    return h


# --- vocab parallelism --------------------------------------------------------

def _vp_gpt_encode(tokens: torch.Tensor, p: Mapping[str, torch.Tensor],
                   cfg: ViTConfig, mesh: C.MeshGroups, dtype,
                   axis: str = "model") -> torch.Tensor:
    """gpt_encode with wte sharded (Vp/tp, C): out-of-shard lookups are
    exact zeros, so the sum over the group is the replicated lookup."""
    wte_l = p["wte"]
    Vl = wte_l.shape[0]
    v0 = mesh.index(axis) * Vl
    loc = (tokens - v0).clamp(0, Vl - 1)
    in_shard = ((tokens >= v0) & (tokens < v0 + Vl))[..., None]
    emb = reduce_out(torch.where(in_shard, wte_l[loc], 0.0), mesh, axis)
    if cfg.pos_emb == "rope":
        return emb.to(dtype)
    T = tokens.shape[-1]
    return (emb + p["wpe"][None, :T]).to(dtype)


def _vp_head_ce(lnf: torch.Tensor, wte_l: torch.Tensor,
                targets: torch.Tensor, mesh: C.MeshGroups, V: int,
                axis: str = "model") -> torch.Tensor:
    """The tied head on the local vocab shard + the parallel CE: mean over
    B*T of log z + m - t, with m the all-reduced max (no gradient: it
    cancels), z and t summed over the group; pad columns masked to -inf."""
    Vl = wte_l.shape[0]
    v0 = mesh.index(axis) * Vl
    lg = _lin(copy_in(lnf, mesh, axis), wte_l).float()
    col = v0 + torch.arange(Vl, device=lg.device)
    lg = torch.where(col < V, lg, float("-inf"))
    m = lg.detach().amax(dim=-1)
    if mesh.size(axis) > 1:
        C.all_reduce(m, mesh.group(axis), op="max")
    z = reduce_out(torch.exp(lg - m[..., None]).sum(dim=-1), mesh, axis)
    t_loc = torch.gather(lg, -1, (targets - v0).clamp(0, Vl - 1)[..., None]
                         )[..., 0]
    in_shard = (targets >= v0) & (targets < v0 + Vl)
    t = reduce_out(torch.where(in_shard, t_loc, 0.0), mesh, axis)
    return (torch.log(z) + m - t).mean()


# --- the TP layout --------------------------------------------------------------

# leaves whose compute runs on sequence shards under SP: their gradients
# cover T/tp rows and are summed over the model group
SP_PARTIAL_GRADS = ("ln1w", "ln1b", "ln2w", "ln2b", "attprojb", "fcprojb")

TP_BLOCK_SPECS: Dict[str, Spec] = {
    "ln1w": (), "ln1b": (),
    "qkv3w": (None, None, "model", None),   # (L, 3, C, C) column-parallel
    "qkv3b": (None, None, "model"),
    "attprojw": (None, None, "model"),      # (L, C, C) row-parallel (C in)
    "attprojb": (),
    "ln2w": (), "ln2b": (),
    "fcw": (None, "model", None),           # (L, 4C, C) column-parallel
    "fcb": (None, "model"),
    "fcprojw": (None, None, "model"),       # (L, C, 4C) row-parallel
    "fcprojb": (),
}


def _as_tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))


def to_tp_params(params: Mapping, cfg: ViTConfig,
                 vocab_parallel: bool = False) -> Dict[str, torch.Tensor]:
    """Canonical tensors -> the TP layout (whole): MHA qkvw/qkvb as
    (L, 3, C, C) / (L, 3, C); GQA as separate qw/kw/vw and biases;
    vocab_parallel pads wte to (pad_vocab(V), C) with zero rows."""
    out = {k: _as_tensor(v) for k, v in params.items()}
    L, Cc = cfg.num_layers, cfg.channels
    if vocab_parallel:
        V = cfg.vocab_size
        out["wte"] = F.pad(out["wte"], (0, 0, 0, fused_ce.pad_vocab(V) - V))
    w, b = out.pop("qkvw"), out.pop("qkvb")
    if cfg.is_gqa:
        kvd = cfg.kv_dim
        out["qw"], out["qb"] = w[:, :Cc], b[:, :Cc]
        out["kw"], out["kb"] = w[:, Cc:Cc + kvd], b[:, Cc:Cc + kvd]
        out["vw"], out["vb"] = w[:, Cc + kvd:], b[:, Cc + kvd:]
    else:
        out["qkv3w"] = w.reshape(L, 3, Cc, Cc)
        out["qkv3b"] = b.reshape(L, 3, Cc)
    return out


def from_tp_params(tp_params: Mapping, cfg: ViTConfig,
                   vocab_parallel: bool = False) -> Dict:
    """The TP layout (whole) -> canonical tensors (numpy in, numpy out)."""
    out = {k: _as_tensor(v) for k, v in tp_params.items()}
    L, Cc = cfg.num_layers, cfg.channels
    if vocab_parallel:
        out["wte"] = out["wte"][:cfg.vocab_size]
    if cfg.is_gqa:
        out["qkvw"] = torch.cat([out.pop(k) for k in ("qw", "kw", "vw")], 1)
        out["qkvb"] = torch.cat([out.pop(k) for k in ("qb", "kb", "vb")], 1)
    else:
        out["qkvw"] = out.pop("qkv3w").reshape(L, 3 * Cc, Cc)
        out["qkvb"] = out.pop("qkv3b").reshape(L, 3 * Cc)
    numpy = any(not isinstance(v, torch.Tensor) for v in tp_params.values())
    return {k: out[k].numpy() if numpy else out[k]
            for k in PRM.tensor_order(cfg)}


def tp_block_specs(cfg: ViTConfig) -> Dict[str, Spec]:
    specs = dict(TP_BLOCK_SPECS)
    if cfg.is_gqa:
        del specs["qkv3w"], specs["qkv3b"]
        for k in ("qw", "kw", "vw"):
            specs[k] = (None, "model", None)
        for k in ("qb", "kb", "vb"):
            specs[k] = (None, "model")
    return specs


def tp_param_specs(cfg: ViTConfig,
                   vocab_parallel: bool = False) -> Dict[str, Spec]:
    """The spec of each TP-layout leaf (replicated for non-block ones)."""
    specs = {k: () for k in PRM.tensor_order(cfg) if k not in M.BLOCK_KEYS}
    specs.update(tp_block_specs(cfg))
    if vocab_parallel:
        specs["wte"] = ("model", None)       # padded vocab rows sharded
    return specs


def tp_global_shapes(cfg: ViTConfig,
                     vocab_parallel: bool = False) -> Dict[str, tuple]:
    """Whole TP-layout shapes: the Adafactor factored / full layout and
    shard_axes are judged on these, never on a rank's slices."""
    shapes = {k: tuple(s) for k, s in PRM.param_shapes(cfg).items()}
    L, Cc = cfg.num_layers, cfg.channels
    if vocab_parallel:
        shapes["wte"] = (fused_ce.pad_vocab(cfg.vocab_size), Cc)
    del shapes["qkvw"], shapes["qkvb"]
    if cfg.is_gqa:
        kvd = cfg.kv_dim
        for k, oc in (("q", Cc), ("k", kvd), ("v", kvd)):
            shapes[k + "w"], shapes[k + "b"] = (L, oc, Cc), (L, oc)
    else:
        shapes["qkv3w"], shapes["qkv3b"] = (L, 3, Cc, Cc), (L, 3, Cc)
    return shapes


def check_tp(cfg: ViTConfig, tp: int, vocab_parallel: bool = False,
             sequence_parallel: bool = False, seq_len: int = 0) -> None:
    """The JAX factories' assertions, as ValueErrors.  seq_len 0: vit
    mode's token count, else T is checked when a batch arrives."""
    if sequence_parallel and not seq_len and cfg.mode == "vit":
        seq_len = cfg.seq_len
    if cfg.is_moe:
        raise ValueError("MoE under TP is not wired (the TP block is "
                         "dense-MLP-sharded) - use dp/ep "
                         "(parallel/expert_parallel.py)")
    if cfg.num_heads % tp:
        raise ValueError(f"num_heads ({cfg.num_heads}) must divide over tp "
                         f"({tp})")
    if cfg.is_gqa and cfg.kv_heads % tp:
        raise ValueError(f"GQA under TP needs kv_heads ({cfg.kv_heads}) "
                         f"divisible by the model-axis size ({tp}) so each "
                         f"shard owns whole groups")
    if vocab_parallel:
        if cfg.mode != "gpt":
            raise ValueError("vocab parallelism is the gpt head/CE path")
        if fused_ce.pad_vocab(cfg.vocab_size) % tp:
            raise ValueError(f"padded vocab "
                             f"{fused_ce.pad_vocab(cfg.vocab_size)} must "
                             f"divide over tp ({tp})")
    if sequence_parallel and seq_len % tp:
        raise ValueError(f"sequence parallelism needs seq_len ({seq_len}) "
                         f"divisible by tp ({tp}); use pool='mean' or pad "
                         f"for CLS-token ViTs")


def encode(x: torch.Tensor, p: Mapping[str, torch.Tensor], cfg: ViTConfig,
           mesh: C.MeshGroups, vocab_parallel: bool) -> torch.Tensor:
    """The replicated encoder (vit: patches + CLS; gpt: wte + wpe, or the
    vocab-parallel lookup), in cfg.dtype."""
    dtype = getattr(torch, cfg.dtype)
    if cfg.mode == "vit":
        return M.vit_encode(x, p, cfg)
    if vocab_parallel:
        return _vp_gpt_encode(x, p, cfg, mesh, dtype)
    return M.gpt_encode(x, p, dtype, rope=cfg.pos_emb == "rope")


def head_loss(h: torch.Tensor, p: Mapping[str, torch.Tensor],
              targets: torch.Tensor, cfg: ViTConfig, mesh: C.MeshGroups,
              vocab_parallel: bool) -> torch.Tensor:
    """Final LN, then the head and mean CE: vit's pooled classifier (plain
    CE, as the JAX TP loss), the vocab-parallel CE, or the replicated tied
    head (`models/model.gpt_head_loss`)."""
    lnf = basic.layernorm_cv(h, p["lnfw"], p["lnfb"])
    if cfg.mode == "vit":
        pooled = lnf[:, 0] if cfg.pool == "cls" else lnf.mean(dim=1)
        logits = _lin(pooled, p["headw"], p["headb"]).float()
        return basic.cross_entropy_from_logits(logits, targets).mean()
    if vocab_parallel:
        return _vp_head_ce(lnf, p["wte"], targets, mesh, cfg.vocab_size)
    return M.gpt_head_loss(lnf, p["wte"], targets, cfg)


def tp_loss(p: Mapping[str, torch.Tensor], inputs: torch.Tensor,
            targets: torch.Tensor, cfg: ViTConfig, mesh: C.MeshGroups,
            sequence_parallel: bool = False,
            vocab_parallel: bool = False) -> torch.Tensor:
    """The mean loss on this rank's rows, every rank of a model group
    computing the same value."""
    h = encode(inputs, p, cfg, mesh, vocab_parallel)
    causal = cfg.mode == "gpt"
    if sequence_parallel:
        check_tp(cfg, mesh.size("model"), sequence_parallel=True,
                 seq_len=h.shape[1])
        h = scatter_seq(h, mesh)
    h = run_blocks(h, tp_layers(p, cfg), cfg, causal, mesh, sequence_parallel)
    if sequence_parallel:
        h = gather_seq_rep(h, mesh)
    return head_loss(h, p, targets, cfg, mesh, vocab_parallel)


def sum_partial(grads: Dict[str, torch.Tensor], keys, mesh: C.MeshGroups,
                axis: str) -> None:
    """Sum the partial gradients of `keys` over `axis`, in place."""
    if mesh.size(axis) > 1:
        for k in keys:
            C.all_reduce(grads[k], mesh.group(axis))


def make_tp_grads(cfg: ViTConfig, mesh: C.MeshGroups,
                  sequence_parallel: bool = False,
                  vocab_parallel: bool = False, accum_steps: int = 1):
    """(tp_params, inputs, targets) -> (loss, grads): the mean loss and
    the rank's slices of the mean gradient over the global batch (SP's
    partial gradients summed over "model", then the mean over "data"),
    over accum_steps slices of the rank's rows."""
    def lag(p, x, y):
        leaves = {k: t.detach().requires_grad_(True) for k, t in p.items()}
        loss = tp_loss(leaves, x, y, cfg, mesh, sequence_parallel,
                       vocab_parallel)
        loss.backward()
        grads = leaf_grads(leaves)
        if sequence_parallel:
            sum_partial(grads, SP_PARTIAL_GRADS, mesh, "model")
        return loss.detach(), grads
    return mean_grads(lag, cfg, mesh, accum_steps)


def mean_grads(lag, cfg: ViTConfig, mesh: C.MeshGroups, accum_steps: int):
    """Wrap a (params, x, y) -> (loss, grads) of the rank's rows: batch
    tensors in, accumulation over accum_steps slices, the mean over
    "data" out."""
    def fn(p, inputs, targets):
        x, y = batch_tensors(inputs, targets, cfg, mesh.device)
        loss, grads = gradops.accumulate_microbatches(lag, p, x, y,
                                                      accum_steps)
        return (data_mean(loss, mesh),
                {k: data_mean(g, mesh) for k, g in grads.items()})
    return fn


def make_tp_train_step(cfg: ViTConfig, mesh: C.MeshGroups,
                       sequence_parallel: bool = False,
                       vocab_parallel: bool = False,
                       accum_steps: int = 1, clip_norm: float = 0.0,
                       return_grad_norm: bool = False):
    """The TP AdamW step: (tp_params, m, v, inputs, targets, step, lr, wd)
    -> (tp_params, m, v, loss[, grad_norm]); params, m and v the rank's
    slices, inputs and targets its data shard's rows (every rank of a model
    group the same).  accum_steps, clip_norm and return_grad_norm as on the
    dp path (parallel/gradops.py): accumulation before the data mean, the
    clip after it, the norm before the clip."""
    check_tp(cfg, mesh.size("model"), vocab_parallel, sequence_parallel)
    return adamw_step(make_tp_grads(cfg, mesh, sequence_parallel,
                                    vocab_parallel, accum_steps),
                      tp_param_specs(cfg, vocab_parallel), mesh, clip_norm,
                      return_grad_norm)


def adamw_step(grads_fn, specs, mesh: C.MeshGroups, clip_norm: float = 0.0,
               return_grad_norm: bool = False, decay_2d_only: bool = False):
    """The AdamW step of every TP / PP / 3-D / EP family around its grads
    function: the global norm (each leaf's squares summed over its spec's
    axes), the clip, `optimizer.adamw_tree` over the slices (decay_2d_only:
    `optimizer.decay_mask_2d`, the EP steps' rule)."""
    def step_fn(p, m, v, inputs, targets, step, lr, wd):
        loss, grads = grads_fn(p, inputs, targets)
        gnorm = None
        if clip_norm > 0.0 or return_grad_norm:
            gnorm = gradops.mesh_grad_norm(grads, specs, mesh)
        if clip_norm > 0.0:
            scale = torch.clamp(clip_norm / (gnorm + 1e-6), max=1.0)
            grads = {k: g * scale for k, g in grads.items()}
        p, m, v = opt.adamw_tree(p, grads, m, v, step, float(lr),
                                 weight_decay=float(wd),
                                 decay_mask=(opt.decay_mask_2d(p)
                                             if decay_2d_only else None))
        return (p, m, v, loss, gnorm) if return_grad_norm else (p, m, v, loss)
    return step_fn


def adafactor_step(grads_fn, fac, shard_axes, mesh: C.MeshGroups,
                   weight_decay_2d_only: bool = True,
                   relative_step: bool = True):
    """The Adafactor step of every TP / PP / 3-D family around its grads
    function: (params, state, inputs, targets, step, lr, wd) -> (params,
    state, loss); `fac` the factored decision of each leaf's whole shape,
    `shard_axes` its model-sliced trailing dim (None without TP)."""
    from ..ops import adafactor as AF

    def step_fn(p, st, inputs, targets, step, lr, wd):
        loss, grads = grads_fn(p, inputs, targets)
        mask = opt.decay_mask_2d(p) if weight_decay_2d_only else None
        p, st = AF.step(p, grads, st, step, lr, weight_decay=float(wd),
                        decay_mask=mask, relative_step=relative_step,
                        shard_axes=shard_axes, group=mesh.group("model"),
                        factored=fac)
        return p, st, loss
    return step_fn


def place_tp_params(params: Mapping, cfg: ViTConfig, mesh: C.MeshGroups,
                    vocab_parallel: bool = False) -> Dict[str, torch.Tensor]:
    """Canonical tensors -> this rank's TP slices on its device."""
    return place_tree(to_tp_params(params, cfg, vocab_parallel),
                      tp_param_specs(cfg, vocab_parallel), mesh)


def init_tp_opt_state(tp_params: Mapping[str, torch.Tensor]):
    """AdamW (m, v): zeros shaped like each slice."""
    return tuple({k: torch.zeros_like(t) for k, t in tp_params.items()}
                 for _ in range(2))


# --- Adafactor under TP ---------------------------------------------------------
#
# Gathered statistics, as in JAX: ops/adafactor.step(shard_axes=..., group=)
# completes every mean across a sharded trailing dim with a mean over the
# model group, so the update equals the one-device step up to the order of
# the sums.  vr/vc slices live on the rank that owns their rows/cols.

def init_af_state_sharded(gshapes, specs, fac, mesh: C.MeshGroups):
    """Zero Adafactor state, each leaf the rank's slice of the whole state
    of the layout `specs` with the factored decision `fac`."""
    from ..ops import adafactor as AF
    shapes = AF.state_shapes(gshapes, fac)
    sspecs = AF.state_specs(gshapes, specs, fac)
    return AF.AdafactorState(*(
        {k: torch.zeros(local_shape(s, getattr(sspecs, f)[k], mesh),
                        dtype=torch.float32, device=mesh.device)
         for k, s in getattr(shapes, f).items()} for f in ("vr", "vc", "vf")),
        {})


def tp_af_factored(cfg: ViTConfig, vocab_parallel: bool = False,
                   min_factor: int = 0):
    """(factored decision on the whole TP-layout shapes, the shapes);
    min_factor 0: adafactor.MIN_FACTOR."""
    from ..ops import adafactor as AF
    gshapes = tp_global_shapes(cfg, vocab_parallel)
    mf = min_factor or AF.MIN_FACTOR
    return {k: AF.factored_shape(s, mf) for k, s in gshapes.items()}, gshapes


def init_tp_af_state(mesh: C.MeshGroups, cfg: ViTConfig,
                     vocab_parallel: bool = False, min_factor: int = 0):
    fac, gshapes = tp_af_factored(cfg, vocab_parallel, min_factor)
    return init_af_state_sharded(gshapes, tp_param_specs(cfg, vocab_parallel),
                                 fac, mesh)


def make_tp_train_step_adafactor(cfg: ViTConfig, mesh: C.MeshGroups,
                                 sequence_parallel: bool = False,
                                 vocab_parallel: bool = False,
                                 weight_decay_2d_only: bool = True,
                                 relative_step: bool = True,
                                 min_factor: int = 0):
    """(tp_params, af_state, inputs, targets, step, lr, wd)
    -> (tp_params, af_state, loss), the state sharded like the weights."""
    from ..ops import adafactor as AF
    check_tp(cfg, mesh.size("model"), vocab_parallel, sequence_parallel)
    fac, gshapes = tp_af_factored(cfg, vocab_parallel, min_factor)
    shard_axes = AF.shard_axes_from_specs(
        gshapes, tp_param_specs(cfg, vocab_parallel), "model")
    return adafactor_step(
        make_tp_grads(cfg, mesh, sequence_parallel, vocab_parallel), fac,
        shard_axes, mesh, weight_decay_2d_only, relative_step)
