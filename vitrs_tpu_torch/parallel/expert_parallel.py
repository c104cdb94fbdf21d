"""Expert parallelism: MoE expert shards over an "expert" mesh axis, and
EP x TP, on `torch.distributed` - the port of
`vitrs_tpu/parallel/expert_parallel.py`, one process a rank.

* dp x ep, mesh ("data", "expert"): the batch splits over both axes
  jointly (every rank is a data worker, its block d*ep + e), the expert
  leaves (EXPERT_KEYS, (L, E, ...)) are sliced on their E axis (rank
  (d, e) holds experts [e*E/ep, (e+1)*E/ep)), everything else whole.
  Each MoE layer routes locally, then makes one all-to-all hop out over
  its expert group and one home (ops/moe.py `moe_mlp(ep_group=)`).
* Gradients: each rank backpropagates its own mean loss; the all-to-all's
  backward carries the peers' cotangents to the expert shards.  Then the
  JAX rule completes them: expert leaves summed over "data" (each data
  row served its own tokens; the expert axis already met in the hops),
  every other leaf over all ranks, then times 1/(dp*ep) - the gradient of
  the global mean loss (the JAX comment at its l.128-132).
* The load-balance aux loss and the capacity are each rank's own (the JAX
  docstring): parity with one device is exact with no drops and
  moe_aux_weight = 0 (tests/test_torch_expert_parallel.py).
* AdamW is `optimizer.adamw_tree` over the slices with `decay_mask_2d`
  (no K7, as JAX); Adafactor the plain step on each rank's slices (its
  statistics live per trailing matrix or vector, so slicing the leading E
  axis changes nothing; the factored decision of each leaf from its
  slice's shape, as the JAX step takes it).
* EP x TP, mesh ("data", "expert", "model"): tokens split over (data,
  expert) as above, the model axis holds TP replicas of each cell's rows;
  attention is the TP block's half (tensor_parallel), the router whole on
  every model rank (the same routing everywhere), expert slabs sliced on
  both axes (fcw (L, E/ep, 4C/tp, C), fcb (L, E/ep, 4C/tp), fcprojw
  (L, E/ep, C, 4C/tp), fcprojb (L, E/ep)) and each expert's FFN wrapped in
  the conjugate copy-in / reduce-out; vp the vocab-parallel embedding and
  head.  Completion: the same rule, times 1/(dp*ep) (the TP conjugates
  make the model axis exact within a cell).  Adafactor completes its
  statistics over the model group (`shard_axes`), factored on whole
  shapes.
* The JAX asserts are ValueErrors here.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from .. import params as PRM
from ..config import ViTConfig
from ..models import model as M
from ..ops import basic, fused_ce
from ..ops.moe import moe_mlp
from . import collectives as C
from . import gradops
from . import tensor_parallel as TP
from .fsdp import batch_tensors

# parameter leaves carrying a (L, E, ...) expert axis (params.param_shapes)
EXPERT_KEYS = ("fcw", "fcb", "fcprojw", "fcprojb")


def make_mesh_dp_ep(dp: int, ep: int, device="cuda") -> C.MeshGroups:
    """The (data, expert) mesh: rank d*ep + e at coordinates (d, e)."""
    return C.mesh_groups({"data": dp, "expert": ep}, device)


def make_mesh_dp_ep_tp(dp: int, ep: int, tp: int,
                       device="cuda") -> C.MeshGroups:
    """The (data, expert, model) mesh: rank (d*ep + e)*tp + m."""
    return C.mesh_groups({"data": dp, "expert": ep, "model": tp}, device)


def check_ep(cfg: ViTConfig, ep: int, tp: int = 1,
             vocab_parallel: bool = False) -> None:
    """The JAX factories' assertions, as ValueErrors."""
    if not (cfg.is_moe and cfg.mode == "gpt"):
        raise ValueError("expert parallelism serves MoE gpt configs "
                         "(--num-experts)")
    if cfg.num_experts % ep:
        raise ValueError(f"num_experts ({cfg.num_experts}) must divide over "
                         f"ep ({ep})")
    if tp > 1:
        if cfg.num_heads % tp or (4 * cfg.channels) % tp:
            raise ValueError(f"num_heads ({cfg.num_heads}) and 4C "
                             f"({4 * cfg.channels}) must divide over tp "
                             f"({tp})")
        if cfg.is_gqa and cfg.kv_heads % tp:
            raise ValueError(f"GQA under TP needs kv_heads ({cfg.kv_heads}) "
                             f"divisible by tp ({tp})")
        if vocab_parallel and fused_ce.pad_vocab(cfg.vocab_size) % tp:
            raise ValueError(f"padded vocab "
                             f"{fused_ce.pad_vocab(cfg.vocab_size)} must "
                             f"divide over tp ({tp})")


def ep_param_specs(cfg: ViTConfig) -> Dict[str, TP.Spec]:
    """Expert slabs sliced on their E axis (dim 1, after the stacked L),
    everything else whole."""
    return {k: ((None, "expert") if k in EXPERT_KEYS else ())
            for k in PRM.tensor_order(cfg)}


def place_ep_params(params: Mapping, cfg: ViTConfig,
                    mesh: C.MeshGroups) -> Dict[str, torch.Tensor]:
    """Canonical tensors -> this rank's fp32 slices on its device."""
    return TP.place_tree(params, ep_param_specs(cfg), mesh)


def init_ep_opt_state(params: Mapping[str, torch.Tensor]):
    """AdamW (m, v): zeros shaped like each slice (fp32)."""
    return TP.init_tp_opt_state(params)


def data_block(mesh: C.MeshGroups) -> int:
    """The rank's block of the global batch: d*ep + e (the model axis, if
    any, reads its cell's rows)."""
    return mesh.index("data") * mesh.size("expert") + mesh.index("expert")


def _complete(loss: torch.Tensor, grads: Dict[str, torch.Tensor],
              mesh: C.MeshGroups):
    """The JAX completion: expert leaves summed over "data", the rest (and
    the loss) over "data" and "expert", everything times 1/(dp*ep)."""
    inv = 1.0 / (mesh.size("data") * mesh.size("expert"))
    expert = {k: g for k, g in grads.items() if k in EXPERT_KEYS}
    rest = {k: g for k, g in grads.items() if k not in EXPERT_KEYS}
    rest["_loss"] = loss.detach().reshape(1)
    data, exp = mesh.group("data"), mesh.group("expert")
    out = gradops.sum_tree(expert, (data,), inv)
    out.update(gradops.sum_tree(rest, (data, exp), inv))
    return out.pop("_loss")[0], out


def _grads_fn(loss_fn, cfg: ViTConfig, mesh: C.MeshGroups,
              accum_steps: int = 1):
    """(params, inputs, targets) -> (global mean loss, the rank's slices of
    the mean gradient): loss_fn(leaves, x, y) is the rank's mean loss,
    accumulated over accum_steps slices of its rows, then completed."""
    def lag(p, x, y):
        leaves = {k: t.detach().requires_grad_(True) for k, t in p.items()}
        loss = loss_fn(leaves, x, y)
        loss.backward()
        return loss.detach(), TP.leaf_grads(leaves)

    def fn(p, inputs, targets):
        x, y = batch_tensors(inputs, targets, cfg, mesh.device)
        loss, grads = gradops.accumulate_microbatches(lag, p, x, y,
                                                      accum_steps)
        return _complete(loss, grads, mesh)
    return fn


def make_ep_grads(cfg: ViTConfig, mesh: C.MeshGroups, accum_steps: int = 1):
    """dp x ep: (params, inputs, targets) -> (loss, grads) of `M.gpt_loss`
    with the expert all-to-all over the rank's expert group."""
    return _grads_fn(
        lambda p, x, y: M.gpt_loss(p, x, y, cfg,
                                   ep_group=mesh.group("expert")),
        cfg, mesh, accum_steps)


def make_ep_train_step(cfg: ViTConfig, mesh: C.MeshGroups,
                       accum_steps: int = 1, clip_norm: float = 0.0,
                       return_grad_norm: bool = False):
    """The dp x ep AdamW step: (params, m, v, inputs, targets, step, lr, wd)
    -> (params, m, v, loss[, grad_norm]); params, m, v the rank's slices,
    inputs and targets its block of the global batch.  accum_steps,
    clip_norm and return_grad_norm as on the dp path (parallel/gradops.py;
    each micro-batch routes at its own capacity); the norm counts each
    expert shard once and each whole leaf once.  Weight decay on the 2-D
    matrices only (`optimizer.decay_mask_2d`), as the JAX step."""
    check_ep(cfg, mesh.size("expert"))
    return TP.adamw_step(make_ep_grads(cfg, mesh, accum_steps),
                         ep_param_specs(cfg), mesh, clip_norm,
                         return_grad_norm, decay_2d_only=True)


def ep_af_factored(cfg: ViTConfig, mesh: C.MeshGroups):
    """(factored decision of each leaf from its slice's shape, the whole
    shapes): the JAX step decides on the shard it holds."""
    from ..ops import adafactor as AF
    specs = ep_param_specs(cfg)
    shapes = {k: tuple(s) for k, s in PRM.param_shapes(cfg).items()}
    return ({k: AF.factored_shape(TP.local_shape(s, specs[k], mesh))
             for k, s in shapes.items()}, shapes)


def init_ep_af_state(mesh: C.MeshGroups, cfg: ViTConfig):
    """Zero Adafactor state sliced like the weights."""
    fac, shapes = ep_af_factored(cfg, mesh)
    return TP.init_af_state_sharded(shapes, ep_param_specs(cfg), fac, mesh)


def make_ep_train_step_adafactor(cfg: ViTConfig, mesh: C.MeshGroups):
    """The dp x ep Adafactor step: (params, state, inputs, targets, step,
    lr, wd) -> (params, state, loss), the state sliced like the weights."""
    check_ep(cfg, mesh.size("expert"))
    fac, _ = ep_af_factored(cfg, mesh)
    return TP.adafactor_step(make_ep_grads(cfg, mesh), fac, {}, mesh)


# --- EP x TP ------------------------------------------------------------------

def ep_tp_param_specs(cfg: ViTConfig,
                      vocab_parallel: bool = False) -> Dict[str, TP.Spec]:
    """The TP specs of the attention half (head-aligned qkv3w, ...), the
    expert slabs sliced on (expert, model), the router whole."""
    specs = TP.tp_param_specs(cfg, vocab_parallel)
    specs.update(routerw=(), fcw=(None, "expert", "model", None),
                 fcb=(None, "expert", "model"),
                 fcprojw=(None, "expert", None, "model"),
                 fcprojb=(None, "expert"))
    return specs


def to_ep_tp_params(params: Mapping, cfg: ViTConfig,
                    vocab_parallel: bool = False):
    """Canonical -> the EP x TP layout (whole): the TP layout; the expert
    slabs keep their canonical (L, E, ...) form."""
    return TP.to_tp_params(params, cfg, vocab_parallel)


def from_ep_tp_params(tp_params: Mapping, cfg: ViTConfig,
                      vocab_parallel: bool = False):
    return TP.from_tp_params(tp_params, cfg, vocab_parallel)


def place_ep_tp_params(params: Mapping, cfg: ViTConfig, mesh: C.MeshGroups,
                       vocab_parallel: bool = False):
    return TP.place_tree(to_ep_tp_params(params, cfg, vocab_parallel),
                         ep_tp_param_specs(cfg, vocab_parallel), mesh)


def _ep_tp_block(x: torch.Tensor, bp: Mapping[str, torch.Tensor],
                 cfg: ViTConfig, mesh: C.MeshGroups):
    """The TP attention half, then the MoE half with the all-to-all over
    the expert group of this model column and each expert's FFN split over
    the model group; returns (x, the layer's weighted router loss)."""
    ln1 = TP.copy_in(basic.layernorm_cv(x, bp["ln1w"], bp["ln1b"]), mesh)
    atty = TP._attend(ln1, bp, cfg, causal=True)
    attproj = TP.reduce_out(TP._lin(atty, bp["attprojw"]), mesh) + bp[
        "attprojb"]
    x = x + attproj.to(x.dtype)
    out, aux = moe_mlp(basic.layernorm_cv(x, bp["ln2w"], bp["ln2b"]),
                       bp["routerw"], bp["fcw"], bp["fcb"], bp["fcprojw"],
                       bp["fcprojb"], top_k=cfg.moe_top_k,
                       cap_factor=cfg.moe_cap_factor,
                       erf=cfg.act == "gelu_erf",
                       ep_group=mesh.group("expert"),
                       tp_group=mesh.group("model"))
    return x + out.to(x.dtype), (cfg.moe_aux_weight * aux.load_balance
                                 + cfg.moe_zloss_weight * aux.z_loss)


def ep_tp_loss(p: Mapping[str, torch.Tensor], tokens: torch.Tensor,
               targets: torch.Tensor, cfg: ViTConfig, mesh: C.MeshGroups,
               vocab_parallel: bool = False) -> torch.Tensor:
    """The rank's mean loss (every rank of a model group the same): the
    encoder (or the vocab-parallel one), the EP x TP blocks, the head
    (`tensor_parallel.head_loss`: K5/K6, or the vocab-parallel CE) plus
    the mean weighted router loss."""
    h = TP.encode(tokens, p, cfg, mesh, vocab_parallel)
    keys = tuple(TP.tp_block_specs(cfg)) + ("routerw",)
    per = {k: p[k].unbind(0) for k in keys}
    aux = None
    for i in range(cfg.num_layers):
        h, a = _ep_tp_block(h, {k: per[k][i] for k in keys}, cfg, mesh)
        aux = a if aux is None else aux + a
    return (TP.head_loss(h, p, targets, cfg, mesh, vocab_parallel)
            + aux / cfg.num_layers)


def make_ep_tp_grads(cfg: ViTConfig, mesh: C.MeshGroups,
                     vocab_parallel: bool = False):
    return _grads_fn(lambda p, x, y: ep_tp_loss(p, x, y, cfg, mesh,
                                                vocab_parallel), cfg, mesh)


def make_ep_tp_train_step(cfg: ViTConfig, mesh: C.MeshGroups,
                          vocab_parallel: bool = False):
    """The dp x ep x tp AdamW step: (params, m, v, inputs, targets, step,
    lr, wd) -> (params, m, v, loss), the slices of `ep_tp_param_specs`."""
    check_ep(cfg, mesh.size("expert"), mesh.size("model"), vocab_parallel)
    return TP.adamw_step(make_ep_tp_grads(cfg, mesh, vocab_parallel),
                         ep_tp_param_specs(cfg, vocab_parallel), mesh,
                         decay_2d_only=True)


def init_ep_tp_af_state(mesh: C.MeshGroups, cfg: ViTConfig,
                        vocab_parallel: bool = False):
    fac, gshapes = TP.tp_af_factored(cfg, vocab_parallel)
    return TP.init_af_state_sharded(
        gshapes, ep_tp_param_specs(cfg, vocab_parallel), fac, mesh)


def make_ep_tp_train_step_adafactor(cfg: ViTConfig, mesh: C.MeshGroups,
                                    vocab_parallel: bool = False):
    """The dp x ep x tp Adafactor step: (params, state, inputs, targets,
    step, lr, wd) -> (params, state, loss); statistics across a model-
    sliced trailing dim completed over the model group."""
    from ..ops import adafactor as AF
    check_ep(cfg, mesh.size("expert"), mesh.size("model"), vocab_parallel)
    fac, gshapes = TP.tp_af_factored(cfg, vocab_parallel)
    shard_axes = AF.shard_axes_from_specs(
        gshapes, ep_tp_param_specs(cfg, vocab_parallel), "model")
    return TP.adafactor_step(make_ep_tp_grads(cfg, mesh, vocab_parallel),
                             fac, shard_axes, mesh)
