"""3-D parallelism, data x tensor x pipeline on one mesh: the port of
`vitrs_tpu/parallel/threed.py` on `torch.distributed`.

The TP block (tensor_parallel._tp_block, or _tp_sp_block under sequence
parallelism, with the vocab-parallel embedding and head + CE under vp) runs
inside the GPipe schedule of parallel/pipeline.py: the batch is split over
"data", heads and MLP width over "model", layers over "pipe".  Rank
(d·tp + m)·pp + p sits at (d, m, p), as `make_mesh_3d` lays out the JAX
devices.  Every rank of a model group is on the same pipe stage and runs
the same ticks, so the model-group collectives inside a stage line up; the
pipe hops go between ranks of equal (d, m), and under SP carry the
(Bm, T/tp, C) sequence shard.

Gradient rules, per leaf class (the JAX docstring's):
  * block weights: sliced over (pipe, model), the rank's gradient is its
    slice's;
  * LN / bias leaves inside blocks: sliced over pipe, whole over model,
    whole gradients (the plain-TP contract; under SP the partial ones are
    summed over "model");
  * encode / head / final-LN leaves (and the vocab-parallel wte): computed
    on one stage, summed over "pipe";
  * everything: mean over "data".
"""

from __future__ import annotations

from typing import Dict

import torch

from .. import params as PRM
from ..config import ViTConfig
from ..models import model as M
from . import collectives as C
from . import pipeline as PP
from . import tensor_parallel as TPm


def make_mesh_3d(dp: int, tp: int, pp: int, device="cuda") -> C.MeshGroups:
    return C.mesh_groups({"data": dp, "model": tp, "pipe": pp}, device)


def param_specs_3d(cfg: ViTConfig,
                   vocab_parallel: bool = False) -> Dict[str, tuple]:
    """TP-layout leaves: block leaves sliced on L over "pipe" and on their
    channel dim over "model"; the rest whole (wte over "model" under vp)."""
    specs = {k: () for k in PRM.tensor_order(cfg) if k not in M.BLOCK_KEYS}
    for k, tp_spec in TPm.tp_block_specs(cfg).items():
        specs[k] = ("pipe",) + tuple(tp_spec)[1:]
    if vocab_parallel:
        specs["wte"] = ("model", None)
    return specs


def _stage_fns(p, cfg: ViTConfig, mesh: C.MeshGroups,
               sequence_parallel: bool, vocab_parallel: bool):
    """(encode, apply, head_loss) of a 3-D stage: the TP encoder (entering
    the SP region), the TP blocks, the head (leaving it)."""
    layers = TPm.tp_layers(p, cfg)
    causal = cfg.mode == "gpt"

    def encode(xb):
        h = TPm.encode(xb, p, cfg, mesh, vocab_parallel)
        return TPm.scatter_seq(h, mesh) if sequence_parallel else h

    def apply(vi, h):
        return TPm.run_blocks(h, layers, cfg, causal, mesh,
                              sequence_parallel), None

    def head(y, lbl):
        if sequence_parallel:
            y = TPm.gather_seq_rep(y, mesh)
        return TPm.head_loss(y, p, lbl, cfg, mesh, vocab_parallel)

    return encode, apply, head


def check_3d(cfg: ViTConfig, mesh: C.MeshGroups, vocab_parallel: bool,
             sequence_parallel: bool) -> None:
    S = mesh.size("pipe")
    if cfg.num_layers % S:
        raise ValueError(f"num_layers ({cfg.num_layers}) must divide over "
                         f"{S} stages")
    TPm.check_tp(cfg, mesh.size("model"), vocab_parallel, sequence_parallel)


def make_3d_grads(cfg: ViTConfig, mesh: C.MeshGroups, microbatches: int,
                  sequence_parallel: bool = False,
                  vocab_parallel: bool = False, accum_steps: int = 1):
    """(p3, inputs, labels) -> (loss, grads): the TP stages in the GPipe
    schedule (the JAX `_loss_3d`), then the gradient rules above."""
    tp = mesh.size("model")
    pipe_partial = [k for k, s in param_specs_3d(cfg, vocab_parallel).items()
                    if "pipe" not in s]

    def lag(p, x, y):
        leaves = {k: t.detach().requires_grad_(True) for k, t in p.items()}
        T = PP._act_seq_len(cfg, x)
        if sequence_parallel:
            TPm.check_tp(cfg, tp, sequence_parallel=True, seq_len=T)
        Bm = x.shape[0] // microbatches
        loss = PP.run_schedule(
            _stage_fns(leaves, cfg, mesh, sequence_parallel, vocab_parallel),
            PP._micro(x, microbatches), PP._micro(y, microbatches), mesh, 1,
            microbatches, "gpipe",
            (Bm, T // tp if sequence_parallel else T, cfg.channels),
            getattr(torch, cfg.dtype))
        grads = TPm.leaf_grads(leaves)
        TPm.sum_partial(grads, pipe_partial, mesh, "pipe")
        if sequence_parallel:
            TPm.sum_partial(grads, TPm.SP_PARTIAL_GRADS, mesh, "model")
        return loss, grads
    return TPm.mean_grads(lag, cfg, mesh, accum_steps)


def make_3d_train_step(cfg: ViTConfig, mesh: C.MeshGroups, microbatches: int,
                       sequence_parallel: bool = False,
                       vocab_parallel: bool = False,
                       accum_steps: int = 1, clip_norm: float = 0.0,
                       return_grad_norm: bool = False):
    """(p3, m, v, inputs, labels, step, lr, wd) -> (p3, m, v, loss[,
    grad_norm]) on the dp x tp x pp mesh (GPipe, as in JAX)."""
    check_3d(cfg, mesh, vocab_parallel, sequence_parallel)
    return TPm.adamw_step(
        make_3d_grads(cfg, mesh, microbatches, sequence_parallel,
                      vocab_parallel, accum_steps),
        param_specs_3d(cfg, vocab_parallel), mesh, clip_norm,
        return_grad_norm)


def place_params_3d(params, cfg: ViTConfig, mesh: C.MeshGroups,
                    vocab_parallel: bool = False) -> Dict[str, torch.Tensor]:
    return TPm.place_tree(TPm.to_tp_params(params, cfg, vocab_parallel),
                          param_specs_3d(cfg, vocab_parallel), mesh)


def init_opt_state_3d(p3):
    return TPm.init_tp_opt_state(p3)


# --- Adafactor under the 3-D mesh ----------------------------------------------
#
# The pipe slice is a leading-axis slice the step is invariant to (with the
# (L, C) stacks full-v); the model slice of a trailing dim is completed by
# the gathered statistics over "model", as under TP.

def threed_af_factored(cfg: ViTConfig, vocab_parallel: bool = False,
                       min_factor: int = 0):
    """(factored decision on the whole TP-layout shapes, with ndim-2 block
    stacks full-v; the shapes)."""
    from ..ops import adafactor as AF
    gshapes = TPm.tp_global_shapes(cfg, vocab_parallel)
    block = set(TPm.tp_block_specs(cfg))
    mf = min_factor or AF.MIN_FACTOR
    return {k: AF.factored_shape(s, mf) and not (len(s) == 2 and k in block)
            for k, s in gshapes.items()}, gshapes


def init_af_state_3d(mesh: C.MeshGroups, cfg: ViTConfig,
                     vocab_parallel: bool = False, min_factor: int = 0):
    fac, gshapes = threed_af_factored(cfg, vocab_parallel, min_factor)
    return TPm.init_af_state_sharded(
        gshapes, param_specs_3d(cfg, vocab_parallel), fac, mesh)


def make_3d_train_step_adafactor(cfg: ViTConfig, mesh: C.MeshGroups,
                                 microbatches: int,
                                 sequence_parallel: bool = False,
                                 vocab_parallel: bool = False,
                                 weight_decay_2d_only: bool = True,
                                 relative_step: bool = True,
                                 min_factor: int = 0):
    """(p3, af_state, inputs, labels, step, lr, wd) -> (p3, af_state,
    loss), the state sharded like the weights."""
    from ..ops import adafactor as AF
    check_3d(cfg, mesh, vocab_parallel, sequence_parallel)
    fac, gshapes = threed_af_factored(cfg, vocab_parallel, min_factor)
    shard_axes = AF.shard_axes_from_specs(
        gshapes, param_specs_3d(cfg, vocab_parallel), "model")
    return TPm.adafactor_step(
        make_3d_grads(cfg, mesh, microbatches, sequence_parallel,
                      vocab_parallel), fac, shard_axes, mesh,
        weight_decay_2d_only, relative_step)
