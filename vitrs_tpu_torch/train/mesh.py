"""The mesh-spec launcher, `--mesh dp=2,tp=2,pp=2` and the rest: the port
of `vitrs_tpu/train/mesh.py` on `torch.distributed`.

A spec string routes to a step factory, and every family sits behind one
interface, as in the JAX package:

    plan = make_plan(cfg, parse_mesh("tp=2,pp=2"), optimizer="adamw")
    params = plan.place(canonical_params)          # host -> rank's layout
    opt    = plan.init_opt(params)
    params, opt, loss = plan.step(params, opt, x, y, step, lr, wd)
    host   = plan.to_canonical(params)             # -> canonical checkpoint
    tree   = plan.opt_save(opt)                    # -> side tree
    opt    = plan.opt_load(tree)                   # <- from a save

x, y are the rank's rows: rows `plan.data_rank` of `plan.data_ways` equal
blocks of the global batch (ranks of one model or pipe group take the same
rows).  Checkpoints are written in the canonical one-device layout
(params.py's tensor order); AdamW's m and v and Muon's state are canonical
too, so a run saved under one mesh resumes under another (tp=2 -> pp=2 ->
dp=2); an Adafactor state is keyed by its family's leaves, as in JAX, and a
family that cannot read another's re-initialises it.  `parse_mesh` parses
every spec the JAX function parses.  The port runs:

  dp=N                 ZeRO-1 data parallelism: make_plan returns None and
                       the loop's own path (parallel/data_parallel.py)
  dp,tp[,sp][,vp]      Megatron TP (+ sequence parallelism, + the
                       vocab-parallel head and CE) with AdamW, Adafactor or
                       Muon (no vp) - parallel/tensor_parallel.py,
                       muon_parallel.py
  dp,pp[,schedule,v,mb] GPipe / 1F1B / interleaved 1F1B with AdamW or
                       Adafactor - parallel/pipeline.py
  dp,tp,pp[,sp][,vp]   3-D, the TP block inside GPipe, with AdamW or
                       Adafactor - parallel/threed.py
  fsdp=N[,dp=M]        ZeRO-3 sharding; dp > 1 is the hybrid (FSDP inside
                       groups of N ranks x DP across M) - parallel/fsdp.py,
                       with AdamW, Adafactor or Muon
  dp,ep[,tp[,vp]]      expert parallelism for MoE configs, and EP x TP,
                       with AdamW or Adafactor - parallel/expert_parallel.py
  dp,cp                context parallelism (ring attention, banded under a
                       window) for gpt configs, ZeRO-1 AdamW or replicated
                       Adafactor - parallel/ring_attention.py

clip_norm, accum_steps and the grad-norm log reach the dp, tp, pp, 3-D and
dp x ep AdamW steps, as in JAX.  Under cp each rank also reads its ctx
block's columns of the inputs and targets (`Plan.seq_rank` of
`Plan.seq_ways`).  cp's AdamW m and v are carved to canonical names from
the ranks' shards in rank order, as the JAX plan carves its sharded
vector.  A mesh of N ranks runs as N processes (torchrun, or
`multihost.initialize`), one device each; ranks that share one card (gloo)
stage every collective through host memory (parallel/collectives.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..config import ViTConfig


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    dp: int = 1
    tp: int = 1
    pp: int = 1
    ep: int = 1
    cp: int = 1
    fsdp: int = 0          # ZeRO-3 over N ranks (0 = off); exclusive
    sp: bool = False       # sequence parallelism inside TP
    vp: bool = False       # vocab-parallel head + CE (gpt TP)
    microbatches: int = 0  # pipeline microbatches (0 -> pp stage count)
    schedule: str = "gpipe"   # gpipe | 1f1b | 1f1b-interleaved
    virtual: int = 1       # virtual stages per device (interleaved)

    @property
    def n_devices(self) -> int:
        if self.fsdp:
            return self.fsdp * max(self.dp, 1)   # dp>1 = hybrid replica axis
        return self.dp * self.tp * self.pp * self.ep * self.cp

    def describe(self) -> str:
        parts = [f"{k}={getattr(self, k)}"
                 for k in ("dp", "tp", "pp", "ep", "cp")
                 if getattr(self, k) > 1]
        if self.fsdp:
            parts.append(f"fsdp={self.fsdp}")
        parts += [k for k in ("sp", "vp") if getattr(self, k)]
        if self.pp > 1:
            parts.append(self.schedule)
        return ",".join(parts) or "dp=1"


def parse_mesh(s: str) -> MeshSpec:
    """``"dp=2,tp=2,sp"`` -> MeshSpec.  Bare ``fsdp`` means every rank (the
    world size); bare ``sp``/``vp`` are flags; ``schedule=1f1b`` and
    ``v=2`` (virtual stages) configure the pipeline."""
    kw = {}
    for tok in filter(None, (t.strip() for t in s.split(","))):
        if "=" in tok:
            k, v = tok.split("=", 1)
            k = k.strip().lower()
            if k in ("schedule",):
                kw[k] = v.strip()
            elif k in ("sp", "vp"):
                kw[k] = v.strip().lower() in ("1", "true", "yes")
            elif k in ("v", "virtual"):
                kw["virtual"] = int(v)
            elif k in ("mb", "microbatches"):
                kw["microbatches"] = int(v)
            elif k in ("dp", "tp", "pp", "ep", "cp", "fsdp"):
                kw[k] = int(v)
            else:
                raise ValueError(f"unknown mesh-spec key {k!r} in {s!r}")
        elif tok.lower() in ("sp", "vp"):
            kw[tok.lower()] = True
        elif tok.lower() == "fsdp":
            from ..parallel import multihost
            kw["fsdp"] = multihost.world_size()
        else:
            raise ValueError(f"unknown mesh-spec token {tok!r} in {s!r}")
    return MeshSpec(**kw)


@dataclasses.dataclass
class Plan:
    """One parallel family's step behind the uniform interface."""
    kind: str
    mesh: object
    spec: MeshSpec
    optimizer: str
    # host canonical params -> the rank's layout
    place: Callable
    # placed params -> optimizer state
    init_opt: Callable
    # (params, opt, x, y, step, lr, wd or Muon's AdamW lr)
    #   -> (params, opt, loss[, grad_norm])
    step: Callable
    # placed params -> host canonical dict (numpy); a collective
    to_canonical: Callable
    # optimizer state -> host tree for checkpoint_tree.save_tree
    opt_save: Callable
    # host tree -> placed optimizer state
    opt_load: Callable
    # the rank's block of the global batch, of data_ways equal blocks
    data_rank: int = 0
    data_ways: int = 1
    # the step returns the grad norm before the clip as well
    returns_gnorm: bool = False
    # micro-batch accumulation baked into the step
    accum_steps: int = 1
    # cp: the rank's block of seq_ways equal blocks of the sequence (the
    # columns of its rows)
    seq_rank: int = 0
    seq_ways: int = 1
    # (params, x, y) -> (loss, the rank's slices of the mean gradient), the
    # step's own (tp, pp, 3-D, ep, cp)
    grads: Optional[Callable] = None

    def validate_batch(self, batch: int):
        """The global batch must split into data_ways blocks, each into
        accum_steps slices and (pp, 3-D) each slice into microbatches."""
        s, ways = self.spec, self.data_ways
        if batch % ways:
            raise ValueError(f"batch {batch} must divide over the {ways} "
                             f"data-sharding ways of mesh {s.describe()}")
        local = batch // ways
        if local % self.accum_steps:
            raise ValueError(f"per-data-shard batch {local} must divide "
                             f"into accum_steps {self.accum_steps}")
        if self.kind in ("pp", "3d"):
            mb = s.microbatches or s.pp
            if (local // self.accum_steps) % mb:
                raise ValueError(f"per-data-shard micro-slice "
                                 f"{local // self.accum_steps} must divide "
                                 f"into microbatches {mb}")


@dataclasses.dataclass(frozen=True)
class TrainKnobs:
    """Features the AdamW steps take (clip, accumulation, the grad-norm
    log), as in JAX; fsdp and the other optimizers keep the lean step."""
    accum_steps: int = 1
    clip_norm: float = 0.0
    log_grad_norm: bool = False

    @property
    def any(self) -> bool:
        return (self.accum_steps > 1 or self.clip_norm > 0.0
                or self.log_grad_norm)


def make_plan(cfg: ViTConfig, spec: MeshSpec, optimizer: str = "adamw",
              device="cuda", knobs: TrainKnobs = TrainKnobs(),
              weight_decay: float = 0.0) -> Optional[Plan]:
    """The Plan of a mesh spec on this rank's `device`; None for a pure dp
    spec (the loop's ZeRO-1 path).  Raises ValueError for combinations no
    factory covers, with the JAX function's causes.  weight_decay is bound
    into Muon plans only (their seventh step slot carries the AdamW lr)."""
    on = [k for k in ("tp", "pp", "ep", "cp") if getattr(spec, k) > 1]
    if optimizer not in ("adamw", "adafactor", "muon"):
        raise ValueError(f"unknown optimizer {optimizer!r}")
    if knobs.any and optimizer != "adamw":
        raise ValueError("clip_norm, accum_steps and log_grad_norm on the "
                         "mesh path ride the AdamW steps (the dp path's "
                         f"contract); --optimizer {optimizer} keeps the lean "
                         "step")
    if spec.fsdp:
        if on or spec.sp or spec.vp:
            raise ValueError("fsdp composes with dp only (the hybrid replica "
                             "axis); tp/pp/ep/cp have their own plans")
        if knobs.any:
            raise ValueError("fsdp keeps the lean step: clip_norm, "
                             "accum_steps and log_grad_norm ride the dp, tp, "
                             "pp and 3-D paths, as in JAX")
        return _fsdp_plan(cfg, spec, optimizer, device, weight_decay)
    if (spec.sp or spec.vp) and spec.tp == 1:
        raise ValueError(f"sp and vp are options of tensor parallelism: "
                         f"mesh {spec.describe()} has no tp")
    if not on:
        return None                      # pure DP: the loop's own path
    if "cp" in on:
        if on != ["cp"] or spec.sp or spec.vp:
            raise ValueError(f"cp composes with dp only (got {on})")
        if optimizer not in ("adamw", "adafactor"):
            raise ValueError("cp ships AdamW (ZeRO-1) and Adafactor "
                             "(replicated-state) steps")
        if knobs.any:
            raise ValueError("cp keeps the lean ring step (clip/accum: "
                             "tp/pp/3d/ep)")
        return _cp_plan(cfg, spec, device, optimizer)
    if "ep" in on:
        if not cfg.is_moe:
            raise ValueError("--mesh ep=N needs a MoE config "
                             "(--num-experts)")
        if not all(k in ("ep", "tp") for k in on) or spec.sp:
            raise ValueError(f"ep composes with dp and tp (got {on}"
                             f"{', sp' if spec.sp else ''})")
        if knobs.any and spec.tp > 1:
            raise ValueError("clip/accum are wired for dp x ep (the ep x tp "
                             "step is lean)")
        if optimizer not in ("adamw", "adafactor"):
            raise ValueError(f"ep{' x tp' if spec.tp > 1 else ''} ships "
                             f"AdamW and Adafactor steps")
        if spec.tp > 1:
            return _ep_tp_plan(cfg, spec, device, optimizer)
        return _ep_plan(cfg, spec, device, optimizer, knobs)
    if optimizer == "muon" and spec.vp:
        raise ValueError("muon under TP has no vocab-parallel head variant "
                         "(parallel/muon_parallel.py) - drop vp or use adamw")
    if "pp" in on and optimizer == "muon":
        raise ValueError("muon rides tp and fsdp meshes (pp and 3-D: "
                         "adamw/adafactor)")
    if "tp" in on and "pp" in on:
        return _3d_plan(cfg, spec, device, optimizer, knobs)
    if "pp" in on:
        return _pp_plan(cfg, spec, device, optimizer, knobs)
    return _tp_plan(cfg, spec, device, optimizer, knobs, weight_decay)


def _tensors(tree, device):
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in tree.items()}


def _adamw_tuple(raw):
    """(p, m, v, ...) -> (p, m, v, loss[, gnorm]) adapted to the uniform
    (p, (m, v), ...) -> (p, (m, v), loss[, gnorm])."""
    def step(p, opt_, x, y, t, lr, wd):
        out = raw(p, *opt_, x, y, t, lr, wd)
        return (out[0], (out[1], out[2])) + tuple(out[3:])
    return step


def _af_saveload(mesh, gshapes, specs, fac, permute=None):
    """(opt_save, opt_load) of an Adafactor state keyed by a family's
    leaves: saved whole (a collective), placed back as the rank's slices;
    `permute(tree, inverse)` maps the interleaved layer order."""
    from ..ops import adafactor as AF
    from ..parallel import tensor_parallel as TP
    sspecs = AF.state_specs(gshapes, specs, fac)
    fields = ("vr", "vc", "vf")

    def opt_save(o):
        out = {f: TP.gather_tree(getattr(o, f), getattr(sspecs, f), mesh)
               for f in fields}
        return ({f: permute(t, True) for f, t in out.items()} if permute
                else out)

    def opt_load(tree):
        return AF.AdafactorState(*(TP.place_tree(
            permute(tree[f], False) if permute else tree[f],
            getattr(sspecs, f), mesh) for f in fields), {})

    return opt_save, opt_load


def _common(kind, mesh, spec, optimizer, knobs):
    return dict(kind=kind, mesh=mesh, spec=spec, optimizer=optimizer,
                data_rank=mesh.index("data"), data_ways=mesh.size("data"),
                returns_gnorm=knobs.log_grad_norm,
                accum_steps=knobs.accum_steps)


def _tp_plan(cfg, spec, device, optimizer="adamw", knobs=TrainKnobs(),
             weight_decay=0.0):
    from ..parallel import tensor_parallel as TP
    mesh = TP.make_mesh_2d(spec.dp, spec.tp, device)
    vp = spec.vp
    specs = TP.tp_param_specs(cfg, vp)
    common = dict(_common("tp", mesh, spec, optimizer, knobs),
                  grads=TP.make_tp_grads(cfg, mesh, spec.sp, vp),
                  place=lambda p: TP.place_tp_params(p, cfg, mesh, vp),
                  to_canonical=lambda p: TP.from_tp_params(
                      TP.gather_tree(p, specs, mesh), cfg, vp))
    if optimizer == "muon":
        from ..ops import muon as MU
        from ..parallel import muon_parallel as MP
        raw = MP.make_tp_muon_train_step(cfg, mesh, spec.sp,
                                         weight_decay=weight_decay)

        def step(p, opt_, x, y, t, lr, alr):
            # the seventh slot carries the AdamW lr; the decay is bound
            p, mom, m, v, loss = raw(p, *opt_, x, y, t, lr, alr)
            return p, (mom, m, v), loss

        return Plan(
            init_opt=lambda p: MP.init_tp_muon_state(p, cfg), step=step,
            opt_save=lambda o: MP.gather_tp_muon_state(*o, cfg, mesh)._asdict(),
            opt_load=lambda tree: MP.place_tp_muon_state(
                MU.MuonState(**{f: tree[f] for f in MU.MuonState._fields}),
                cfg, mesh), **common)
    if optimizer == "adafactor":
        fac, gshapes = TP.tp_af_factored(cfg, vp)
        opt_save, opt_load = _af_saveload(mesh, gshapes, specs, fac)
        return Plan(
            init_opt=lambda p: TP.init_tp_af_state(mesh, cfg, vp),
            step=TP.make_tp_train_step_adafactor(cfg, mesh, spec.sp, vp),
            opt_save=opt_save, opt_load=opt_load, **common)
    step = _adamw_tuple(TP.make_tp_train_step(
        cfg, mesh, spec.sp, vp, knobs.accum_steps, knobs.clip_norm,
        knobs.log_grad_norm))
    return Plan(
        init_opt=TP.init_tp_opt_state, step=step,
        opt_save=lambda o: {"m": common["to_canonical"](o[0]),
                            "v": common["to_canonical"](o[1])},
        opt_load=lambda tree: tuple(common["place"](tree[k])
                                    for k in ("m", "v")), **common)


def _pp_plan(cfg, spec, device, optimizer="adamw", knobs=TrainKnobs()):
    from ..parallel import pipeline as PP
    mesh = PP.make_mesh_dp_pp(spec.dp, spec.pp, device)
    mb = spec.microbatches or spec.pp
    V = spec.virtual if spec.schedule == "1f1b-interleaved" else 1
    common = dict(_common("pp", mesh, spec, optimizer, knobs),
                  grads=PP.make_pp_grads(cfg, mesh, mb, spec.schedule, V),
                  place=lambda p: PP.place_pp_params(p, cfg, mesh, V),
                  to_canonical=lambda p: PP.pp_to_canonical(p, cfg, mesh, V))
    if optimizer == "adafactor":
        fac, gshapes = PP.pp_af_factored(cfg)

        def permute(tree, inverse):
            return (PP.permute_af_tree(tree, cfg, spec.pp, V, inverse)
                    if V > 1 else tree)

        opt_save, opt_load = _af_saveload(mesh, gshapes,
                                          PP.pp_param_specs(cfg), fac,
                                          permute)
        return Plan(
            init_opt=lambda p: PP.init_pp_af_state(mesh, cfg),
            step=PP.make_pp_train_step_adafactor(cfg, mesh, mb, spec.schedule,
                                                 V),
            opt_save=opt_save, opt_load=opt_load, **common)
    step = _adamw_tuple(PP.make_pp_train_step(
        cfg, mesh, mb, spec.schedule, V, knobs.accum_steps, knobs.clip_norm,
        knobs.log_grad_norm))
    return Plan(
        init_opt=PP.init_pp_opt_state, step=step,
        opt_save=lambda o: {"m": common["to_canonical"](o[0]),
                            "v": common["to_canonical"](o[1])},
        opt_load=lambda tree: tuple(common["place"](tree[k])
                                    for k in ("m", "v")), **common)


def _3d_plan(cfg, spec, device, optimizer="adamw", knobs=TrainKnobs()):
    from ..parallel import tensor_parallel as TP
    from ..parallel import threed as TD
    mesh = TD.make_mesh_3d(spec.dp, spec.tp, spec.pp, device)
    mb = spec.microbatches or spec.pp
    vp = spec.vp
    specs = TD.param_specs_3d(cfg, vp)
    common = dict(_common("3d", mesh, spec, optimizer, knobs),
                  grads=TD.make_3d_grads(cfg, mesh, mb, spec.sp, vp),
                  place=lambda p: TD.place_params_3d(p, cfg, mesh, vp),
                  to_canonical=lambda p: TP.from_tp_params(
                      TP.gather_tree(p, specs, mesh), cfg, vp))
    if optimizer == "adafactor":
        fac, gshapes = TD.threed_af_factored(cfg, vp)
        opt_save, opt_load = _af_saveload(mesh, gshapes, specs, fac)
        return Plan(
            init_opt=lambda p: TD.init_af_state_3d(mesh, cfg, vp),
            step=TD.make_3d_train_step_adafactor(cfg, mesh, mb, spec.sp, vp),
            opt_save=opt_save, opt_load=opt_load, **common)
    step = _adamw_tuple(TD.make_3d_train_step(
        cfg, mesh, mb, spec.sp, vp, knobs.accum_steps, knobs.clip_norm,
        knobs.log_grad_norm))
    return Plan(
        init_opt=TD.init_opt_state_3d, step=step,
        opt_save=lambda o: {"m": common["to_canonical"](o[0]),
                            "v": common["to_canonical"](o[1])},
        opt_load=lambda tree: tuple(common["place"](tree[k])
                                    for k in ("m", "v")), **common)


def _ep_plan(cfg, spec, device, optimizer="adamw", knobs=TrainKnobs()):
    from ..parallel import expert_parallel as EP
    from ..parallel import tensor_parallel as TP
    EP.check_ep(cfg, spec.ep)
    mesh = EP.make_mesh_dp_ep(spec.dp, spec.ep, device)
    specs = EP.ep_param_specs(cfg)
    common = dict(_common("ep", mesh, spec, optimizer, knobs),
                  data_rank=EP.data_block(mesh),
                  data_ways=spec.dp * spec.ep,
                  grads=EP.make_ep_grads(cfg, mesh),
                  place=lambda p: EP.place_ep_params(p, cfg, mesh),
                  to_canonical=lambda p: TP.gather_tree(p, specs, mesh))
    if optimizer == "adafactor":
        fac, shapes = EP.ep_af_factored(cfg, mesh)
        opt_save, opt_load = _af_saveload(mesh, shapes, specs, fac)
        return Plan(
            init_opt=lambda p: EP.init_ep_af_state(mesh, cfg),
            step=EP.make_ep_train_step_adafactor(cfg, mesh),
            opt_save=opt_save, opt_load=opt_load, **common)
    step = _adamw_tuple(EP.make_ep_train_step(
        cfg, mesh, accum_steps=knobs.accum_steps, clip_norm=knobs.clip_norm,
        return_grad_norm=knobs.log_grad_norm))
    return Plan(
        init_opt=EP.init_ep_opt_state, step=step,
        opt_save=lambda o: {"m": common["to_canonical"](o[0]),
                            "v": common["to_canonical"](o[1])},
        opt_load=lambda tree: tuple(common["place"](tree[k])
                                    for k in ("m", "v")), **common)


def _ep_tp_plan(cfg, spec, device, optimizer="adamw"):
    from ..parallel import expert_parallel as EP
    from ..parallel import tensor_parallel as TP
    EP.check_ep(cfg, spec.ep, spec.tp, spec.vp)
    mesh = EP.make_mesh_dp_ep_tp(spec.dp, spec.ep, spec.tp, device)
    vp = spec.vp
    specs = EP.ep_tp_param_specs(cfg, vp)
    common = dict(_common("ep", mesh, spec, optimizer, TrainKnobs()),
                  data_rank=EP.data_block(mesh),
                  data_ways=spec.dp * spec.ep,
                  grads=EP.make_ep_tp_grads(cfg, mesh, vp),
                  place=lambda p: EP.place_ep_tp_params(p, cfg, mesh, vp),
                  to_canonical=lambda p: EP.from_ep_tp_params(
                      TP.gather_tree(p, specs, mesh), cfg, vp))
    if optimizer == "adafactor":
        fac, gshapes = TP.tp_af_factored(cfg, vp)
        opt_save, opt_load = _af_saveload(mesh, gshapes, specs, fac)
        return Plan(
            init_opt=lambda p: EP.init_ep_tp_af_state(mesh, cfg, vp),
            step=EP.make_ep_tp_train_step_adafactor(cfg, mesh,
                                                    vocab_parallel=vp),
            opt_save=opt_save, opt_load=opt_load, **common)
    step = _adamw_tuple(EP.make_ep_tp_train_step(cfg, mesh,
                                                 vocab_parallel=vp))
    return Plan(
        init_opt=TP.init_tp_opt_state, step=step,
        opt_save=lambda o: {"m": common["to_canonical"](o[0]),
                            "v": common["to_canonical"](o[1])},
        opt_load=lambda tree: tuple(common["place"](tree[k])
                                    for k in ("m", "v")), **common)


def _cp_plan(cfg, spec, device, optimizer="adamw"):
    from .. import params as PRM
    from ..parallel import ring_attention as RA
    from ..parallel import tensor_parallel as TP
    RA.check_cp(cfg, spec.cp)
    mesh = RA.make_mesh_dp_cp(spec.dp, spec.cp, device)
    common = dict(_common("cp", mesh, spec, optimizer, TrainKnobs()),
                  seq_rank=mesh.index("ctx"), seq_ways=spec.cp,
                  grads=RA.make_cp_grads(cfg, mesh),
                  to_canonical=lambda p: PRM.to_numpy(p, cfg))
    if optimizer == "adafactor":
        from ..ops import adafactor as AF
        fields = ("vr", "vc", "vf")
        specs = {k: () for k in PRM.tensor_order(cfg)}
        return Plan(
            place=lambda p: TP.place_tree(p, specs, mesh),
            init_opt=AF.init_state,
            step=RA.make_cp_train_step_adafactor(cfg, mesh),
            opt_save=lambda o: {f: {k: t.detach().cpu().numpy()
                                    for k, t in getattr(o, f).items()}
                                for f in fields},
            opt_load=lambda tree: AF.AdafactorState(
                *(_tensors(tree[f], mesh.device) for f in fields), {}),
            **common)
    return Plan(
        place=lambda p: RA.place_cp_params(p, cfg, mesh),
        init_opt=lambda p: RA.init_cp_opt_state(cfg, mesh),
        step=_adamw_tuple(RA.make_cp_train_step(cfg, mesh)),
        opt_save=lambda o: {k: RA.cp_opt_to_named(t, cfg, mesh)
                            for k, t in zip(("m", "v"), o)},
        opt_load=lambda tree: tuple(RA.cp_opt_from_named(tree[k], cfg, mesh)
                                    for k in ("m", "v")), **common)


def _fsdp_plan(cfg, spec, optimizer, device, weight_decay=0.0):
    from .. import params as PRM
    from ..parallel import fsdp as FS
    if spec.dp > 1:
        mesh = FS.make_hybrid_mesh(spec.dp, spec.fsdp, device)
    else:
        mesh = FS.make_mesh(spec.fsdp, device)
    shapes = PRM.param_shapes(cfg)
    specs = FS.param_specs(shapes, mesh)

    def place(host):
        return FS.place_params(host, mesh)

    def canonical(tree):
        return FS.to_canonical(tree, specs, mesh)

    common = dict(kind="fsdp", mesh=mesh, spec=spec, optimizer=optimizer,
                  place=place, to_canonical=canonical, data_rank=mesh.rank,
                  data_ways=mesh.size)
    if optimizer == "muon":
        from ..ops import muon as MU
        step = FS.make_fsdp_muon_train_step(cfg, mesh, shapes,
                                            weight_decay=weight_decay)
        return Plan(
            init_opt=lambda p: FS.init_fsdp_muon_state(p, mesh), step=step,
            opt_save=lambda o: {f: canonical(getattr(o, f))
                                for f in MU.MuonState._fields},
            opt_load=lambda tree: MU.MuonState(
                **{f: place(tree[f]) for f in MU.MuonState._fields}),
            **common)
    if optimizer == "adafactor":
        from ..ops import adafactor as AF
        fields = ("vr", "vc", "vf")
        return Plan(
            init_opt=lambda p: FS.init_af_state(shapes, mesh),
            step=FS.make_fsdp_train_step_adafactor(cfg, mesh, shapes),
            opt_save=lambda o: {f: {k: t.detach().cpu().numpy()
                                    for k, t in getattr(o, f).items()}
                                for f in fields},
            opt_load=lambda tree: AF.AdafactorState(
                *(_tensors(tree[f], mesh.device) for f in fields), {}),
            **common)
    steps = {}

    def step(p, opt_, x, y, t, lr, wd):
        # the FSDP step binds its weight decay, as in JAX: one a value
        if float(wd) not in steps:
            steps[float(wd)] = FS.make_fsdp_train_step(
                cfg, mesh, shapes, weight_decay=float(wd))
        fn = steps[float(wd)]
        m, v = opt_
        p, m, v, loss = fn(p, m, v, x, y, t, lr)
        return p, (m, v), loss

    return Plan(
        init_opt=lambda p: FS.init_opt_state(p, mesh), step=step,
        opt_save=lambda o: {"m": canonical(o[0]), "v": canonical(o[1])},
        opt_load=lambda tree: (place(tree["m"]), place(tree["v"])),
        **common)
