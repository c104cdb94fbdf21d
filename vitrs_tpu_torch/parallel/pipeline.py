"""Pipeline parallelism, GPipe, 1F1B and interleaved 1F1B, over a (data,
pipe) mesh: the port of `vitrs_tpu/parallel/pipeline.py` on
`torch.distributed`, one process a rank.

Each rank holds its stage's slice of the stacked (L, ...) block leaves
(L/S layers; under the interleaved schedule V chunks of L/(S·V) layers,
virtual stage sv = vi·S + s in local slot vi, after `interleave_layer_order`
permutes L) and the whole of the other leaves.  Only virtual stage 0 runs
the encoder, only the last runs the head and loss.  The ranks run one
schedule in lockstep ticks, as the JAX tick scan does:

  * forward of microbatch f on virtual stage sv at tick f + sv (both
    schedules);
  * backward of microbatch b at tick 2·Sv − 1 − sv + b under 1F1B (every
    stage one forward and one backward a tick in the steady state), and at
    tick 2·Mb + 2·Sv − 3 − sv − b under GPipe (every backward after every
    forward, in reverse order);
  * at the end of each tick every rank posts its sends (the activation to
    the next virtual stage, the input gradient to the previous one) and the
    receives it will read next tick, all at once (`collectives.exchange`,
    isend / irecv, each waited on): neighbours that send to each other in
    one tick cannot deadlock.  The wrap from device S−1 to device 0 moves a
    microbatch to the next local slot.

Where the JAX 1F1B recomputes a stage's forward from its stashed input
under jax.vjp, the port keeps each in-flight microbatch's autograd graph
from its forward tick to its backward tick (at most 2·Sv − 1 − 2·sv of them
on virtual stage sv): the same gradients, each stage's forward run once a
microbatch (K1-fwd L/S times a microbatch, not twice that).

The loss and the gradients are the microbatches' mean: the last stage
seeds each microbatch's loss with 1/Mb, the received activation gradients
carry it upstream, and the scalar is summed over the pipe group (the JAX
`reduce_out`, all-reduce forward, identity backward).  MoE (GPipe and
1F1B) adds each stage's router loss over its local layers / S on every
stage, seeded there too.  The gradients of the leaves every stage holds
whole (wte, tied between the stage-0 embedding and the last stage's head;
wpe or the patch embedding; the final LN; vit's head) are summed over the
pipe group; the block slices' are the rank's own.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .. import params as PRM
from ..config import ViTConfig
from ..models import model as M
from . import collectives as C
from . import tensor_parallel as TPm

SCHEDULES = ("gpipe", "1f1b", "1f1b-interleaved")


def make_mesh_dp_pp(dp: int, pp: int, device="cuda") -> C.MeshGroups:
    """The (data, pipe) mesh: rank d*pp + p at coordinates (d, p)."""
    return C.mesh_groups({"data": dp, "pipe": pp}, device)


def pp_param_specs(cfg: ViTConfig) -> Dict[str, tuple]:
    """Block leaves sliced over the pipe axis on L (MoE's router too);
    everything else whole."""
    specs = {k: () for k in PRM.tensor_order(cfg)}
    for k in M.BLOCK_KEYS + (("routerw",) if cfg.is_moe else ()):
        specs[k] = ("pipe",)
    return specs


# --- the schedule --------------------------------------------------------------

def _ticks(schedule: str, Sv: int, Mb: int):
    """(forward tick of (sv, f), backward tick of (sv, b), tick count)."""
    def fwd(sv, f):
        return f + sv
    if schedule == "gpipe":
        def bwd(sv, b):
            return 2 * Mb + 2 * Sv - 3 - sv - b
        return fwd, bwd, 2 * Mb + 2 * Sv - 2

    def bwd(sv, b):
        return 2 * Sv - 1 - sv + b
    return fwd, bwd, Mb + 2 * Sv - 1


def _at(tick_of, sv: int, t: int, Mb: int):
    """The microbatch virtual stage sv works on at tick t, or None."""
    for i in range(Mb):
        if tick_of(sv, i) == t:
            return i
    return None


def run_schedule(stage_fns, micro_x, micro_y, mesh: C.MeshGroups, V: int,
                 Mb: int, schedule: str, act_shape, act_dtype,
                 aux_scale: float = 0.0) -> torch.Tensor:
    """Run this rank's part of the pipeline over Mb microbatches, the
    backward included (the gradients accumulate into the leaves the stage
    functions read).  stage_fns: (encode(x) -> h on virtual stage 0,
    apply(vi, h) -> (y, router loss or None), head_loss(y, labels) on the
    last).  Returns the mean loss over the microbatches, summed over the
    pipe group (every stage holds it); aux_scale weighs each stage's router
    loss (1/S, MoE)."""
    encode, apply, head_loss = stage_fns
    S, s = mesh.size("pipe"), mesh.index("pipe")
    Sv = S * V
    fwd_t, bwd_t, n_ticks = _ticks(schedule, Sv, Mb)
    dev = mesh.device
    seed = torch.full((), 1.0 / Mb, dtype=torch.float32, device=dev)
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    inflight, recv_act, recv_g = {}, {}, {}

    def home(sv):
        """(rank, local slot) of virtual stage sv."""
        return mesh.peer("pipe", sv % S), sv // S

    for t in range(n_ticks):
        sends = []
        for vi in range(V):
            sv = vi * S + s
            f = _at(fwd_t, sv, t, Mb)
            if f is not None:
                if sv == 0:
                    x_in, h = None, encode(micro_x[f])
                else:
                    x_in = recv_act.pop(vi).requires_grad_(True)
                    h = x_in
                y, aux = apply(vi, h)
                obj = None
                if aux is not None and aux_scale:
                    obj = aux * aux_scale
                    loss_sum += obj.detach()
                if sv == Sv - 1:
                    ml = head_loss(y, micro_y[f])
                    loss_sum += ml.detach()
                    obj = ml if obj is None else ml + obj
                    y = None
                else:
                    dst, slot = home(sv + 1)
                    sends.append((y.detach(), dst, 2 * slot))
                inflight[(vi, f)] = (x_in, y, obj)
            b = _at(bwd_t, sv, t, Mb)
            if b is not None:
                x_in, y, obj = inflight.pop((vi, b))
                outs, grads = [], []
                if y is not None:
                    outs.append(y)
                    grads.append(recv_g.pop(vi))
                if obj is not None and obj.requires_grad:
                    outs.append(obj)
                    grads.append(seed)
                if outs:
                    torch.autograd.backward(outs, grads)
                if x_in is not None:
                    g = (x_in.grad if x_in.grad is not None
                         else torch.zeros_like(x_in))
                    dst, slot = home(sv - 1)
                    sends.append((g, dst, 2 * slot + 1))
        recvs = []
        for vi in range(V):
            sv = vi * S + s
            if sv > 0 and _at(fwd_t, sv - 1, t, Mb) is not None:
                buf = torch.empty(act_shape, dtype=act_dtype, device=dev)
                recv_act[vi] = buf
                recvs.append((buf, home(sv - 1)[0], 2 * vi))
            if sv < Sv - 1 and _at(bwd_t, sv + 1, t, Mb) is not None:
                buf = torch.empty(act_shape, dtype=act_dtype, device=dev)
                recv_g[vi] = buf
                recvs.append((buf, home(sv + 1)[0], 2 * vi + 1))
        if sends or recvs:
            C.exchange(sends, recvs)
    if S > 1:
        C.all_reduce(loss_sum, mesh.group("pipe"))
    return loss_sum / Mb


def _micro(t: torch.Tensor, Mb: int) -> torch.Tensor:
    if t.shape[0] % Mb:
        raise ValueError(f"local batch {t.shape[0]} must divide into "
                         f"{Mb} microbatches")
    return t.reshape(Mb, t.shape[0] // Mb, *t.shape[1:])


def _act_seq_len(cfg: ViTConfig, inputs: torch.Tensor) -> int:
    return inputs.shape[1] if cfg.mode == "gpt" else cfg.seq_len


def _mode_fns(p: Mapping[str, torch.Tensor], cfg: ViTConfig,
              mesh: C.MeshGroups, V: int):
    """(encode, apply, head_loss) of a pp stage: the model's encoder, the
    blocks of local slot vi through `models/model.transformer` (the
    kernels' route; its router loss over the chunk's layers), and the
    final LN + head + mean CE (`tensor_parallel.head_loss`, the replicated
    head: the fused CE in gpt mode)."""
    dtype = getattr(torch, cfg.dtype)
    L_local = p[M.BLOCK_KEYS[0]].shape[0]
    Lc = L_local // V
    chunk_cfg = cfg.replace(num_layers=Lc)
    block = M.block_keys(p)

    def encode(xb):
        if cfg.mode == "gpt":
            return M.gpt_encode(xb, p, dtype, rope=cfg.pos_emb == "rope")
        return M.vit_encode(xb, p, cfg)

    def apply(vi, h):
        chunk = {k: (t[vi * Lc:(vi + 1) * Lc] if k in block else t)
                 for k, t in p.items()}
        y, aux = M.transformer(h, M.train_params(chunk, cfg), chunk_cfg,
                               causal=cfg.mode == "gpt", return_aux=True)
        return y, (aux if cfg.is_moe else None)

    def head(y, lbl):
        return TPm.head_loss(y, p, lbl, cfg, mesh, False)

    return encode, apply, head


def check_pp(cfg: ViTConfig, S: int, schedule: str, V: int,
             adafactor: bool = False) -> None:
    """The JAX factories' assertions, as ValueErrors."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    if V != 1 and schedule != "1f1b-interleaved":
        raise ValueError("virtual stages need schedule=1f1b-interleaved")
    if cfg.is_moe and (adafactor or schedule == "1f1b-interleaved"):
        raise ValueError(
            "MoE under pipeline parallelism rides GPipe or 1F1B with AdamW "
            "(the stage scalar carries the router aux); the interleaved "
            "schedule is dense-only - or use dp/ep "
            "(parallel/expert_parallel.py)")
    if cfg.num_layers % (S * V):
        raise ValueError(f"num_layers ({cfg.num_layers}) must divide over "
                         f"{S} stages x {V} virtual stages")


def make_pp_grads(cfg: ViTConfig, mesh: C.MeshGroups, microbatches: int,
                  schedule: str = "gpipe", virtual_stages: int = 1,
                  accum_steps: int = 1):
    """(pp_params, inputs, labels) -> (loss, grads): the pipeline over the
    rank's rows (each accumulation slice split into `microbatches`), the
    replicated leaves' gradients summed over "pipe", the mean over
    "data"."""
    S, V = mesh.size("pipe"), virtual_stages
    replicated = [k for k, sp in pp_param_specs(cfg).items()
                  if "pipe" not in sp]

    def lag(p, x, y):
        leaves = {k: t.detach().requires_grad_(True) for k, t in p.items()}
        Bm = x.shape[0] // microbatches
        loss = run_schedule(
            _mode_fns(leaves, cfg, mesh, V), _micro(x, microbatches),
            _micro(y, microbatches), mesh, V, microbatches, schedule,
            (Bm, _act_seq_len(cfg, x), cfg.channels),
            getattr(torch, cfg.dtype), aux_scale=1.0 / S if cfg.is_moe else 0)
        grads = TPm.leaf_grads(leaves)
        TPm.sum_partial(grads, replicated, mesh, "pipe")
        return loss, grads
    return TPm.mean_grads(lag, cfg, mesh, accum_steps)


def make_pp_train_step(cfg: ViTConfig, mesh: C.MeshGroups, microbatches: int,
                       schedule: str = "gpipe", virtual_stages: int = 1,
                       accum_steps: int = 1, clip_norm: float = 0.0,
                       return_grad_norm: bool = False):
    """(pp_params, m, v, inputs, labels, step, lr, wd)
    -> (pp_params, m, v, loss[, grad_norm]): params, m and v the rank's
    stage slices (`place_pp_params`), inputs its data shard's rows (every
    stage of a pipe group the same).  accum_steps runs the pipeline over
    that many slices of the rows (each split into `microbatches`);
    clip_norm and return_grad_norm as on the dp path."""
    check_pp(cfg, mesh.size("pipe"), schedule, virtual_stages)
    return TPm.adamw_step(
        make_pp_grads(cfg, mesh, microbatches, schedule, virtual_stages,
                      accum_steps), pp_param_specs(cfg), mesh, clip_norm,
        return_grad_norm)


def interleave_layer_order(L: int, S: int, V: int):
    """The stacked-L permutation of the interleaved schedule: device d's
    contiguous slice holds the chunks of virtual stages {vi·S + d} in slot
    order (position (d·V + vi)·Lc.. holds chunk vi·S + d)."""
    Lc = L // (S * V)
    order = []
    for d in range(S):
        for vi in range(V):
            c = vi * S + d
            order.extend(range(c * Lc, (c + 1) * Lc))
    return order


def _permute(tree: Mapping, cfg: ViTConfig, S: int, V: int,
             inverse: bool = False) -> Dict:
    """Apply (or undo) the interleaved order to every leaf whose leading
    axis is the stacked L of a block leaf."""
    order = np.asarray(interleave_layer_order(cfg.num_layers, S, V))
    idx = np.argsort(order) if inverse else order
    block = set(M.BLOCK_KEYS) | {"routerw"}
    return {k: (np.asarray(v)[idx] if (k in block and np.ndim(v) >= 1 and
                                       np.shape(v)[0] == cfg.num_layers)
                else v)
            for k, v in tree.items()}


def place_pp_params(params: Mapping, cfg: ViTConfig, mesh: C.MeshGroups,
                    V: int = 1) -> Dict[str, torch.Tensor]:
    """Canonical tensors -> this rank's stage slices (V > 1: in the
    interleaved order, JAX's `place_pp_params_interleaved`)."""
    host = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in params.items()}
    if V > 1:
        host = _permute(host, cfg, mesh.size("pipe"), V)
    return TPm.place_tree(host, pp_param_specs(cfg), mesh)


def uninterleave_tree(tree: Mapping, cfg: ViTConfig, S: int, V: int):
    """Undo the interleaved layer order (whole host trees)."""
    return _permute(tree, cfg, S, V, inverse=True)


def permute_af_tree(tree: Mapping, cfg: ViTConfig, S: int, V: int,
                    inverse: bool = False):
    """The interleaved order on an Adafactor state tree (vr / vc / a full
    vf keep the leading L axis)."""
    return _permute(tree, cfg, S, V, inverse)


def pp_to_canonical(p: Mapping[str, torch.Tensor], cfg: ViTConfig,
                    mesh: C.MeshGroups, V: int = 1) -> Dict[str, np.ndarray]:
    host = TPm.gather_tree(p, pp_param_specs(cfg), mesh)
    return uninterleave_tree(host, cfg, mesh.size("pipe"), V) if V > 1 \
        else host


def init_pp_opt_state(pp_params: Mapping[str, torch.Tensor]):
    return TPm.init_tp_opt_state(pp_params)


# --- Adafactor under PP --------------------------------------------------------
#
# The pipe axis slices the block leaves on their leading L axis, to which
# the Adafactor step is exactly invariant (its RMS scalars are per trailing
# matrix / vector), once the (L, C) stacks are kept full-v: each stage runs
# the plain step on its slices.

def pp_af_factored(cfg: ViTConfig, min_factor: int = 0):
    """(factored decision, whole shapes): ndim-2 block stacks full-v."""
    from ..ops import adafactor as AF
    gshapes = {k: tuple(s) for k, s in PRM.param_shapes(cfg).items()}
    mf = min_factor or AF.MIN_FACTOR
    return {k: AF.factored_shape(s, mf) and not (len(s) == 2
                                             and k in M.BLOCK_KEYS)
            for k, s in gshapes.items()}, gshapes


def init_pp_af_state(mesh: C.MeshGroups, cfg: ViTConfig,
                     min_factor: int = 0):
    fac, gshapes = pp_af_factored(cfg, min_factor)
    return TPm.init_af_state_sharded(gshapes, pp_param_specs(cfg), fac, mesh)


def make_pp_train_step_adafactor(cfg: ViTConfig, mesh: C.MeshGroups,
                                 microbatches: int, schedule: str = "gpipe",
                                 virtual_stages: int = 1,
                                 weight_decay_2d_only: bool = True,
                                 relative_step: bool = True,
                                 min_factor: int = 0):
    """(pp_params, af_state, inputs, labels, step, lr, wd)
    -> (pp_params, af_state, loss): the plain step on each stage's
    slices."""
    check_pp(cfg, mesh.size("pipe"), schedule, virtual_stages,
             adafactor=True)
    fac, _ = pp_af_factored(cfg, min_factor)
    return TPm.adafactor_step(
        make_pp_grads(cfg, mesh, microbatches, schedule, virtual_stages),
        fac, None, mesh, weight_decay_2d_only, relative_step)
