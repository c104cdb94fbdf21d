"""The mesh-spec launcher, `--mesh dp=2` / `fsdp=2` / `dp=2,fsdp=2`: the
port of `vitrs_tpu/train/mesh.py` on `torch.distributed`.

A spec string routes to a step factory, and every family sits behind one
interface, as in the JAX package:

    plan = make_plan(cfg, parse_mesh("fsdp=2"), optimizer="adamw")
    params = plan.place(canonical_params)          # host -> rank's layout
    opt    = plan.init_opt(params)
    params, opt, loss = plan.step(params, opt, x, y, step, lr, wd)
    host   = plan.to_canonical(params)             # -> canonical checkpoint
    tree   = plan.opt_save(opt)                    # -> canonical side tree
    opt    = plan.opt_load(tree)                   # <- from any mesh's save

Checkpoints are written in the canonical one-device layout (params.py's
tensor order; optimizer state keyed by canonical names), so a run saved
under one mesh resumes under another.  `parse_mesh` parses every spec the
JAX function parses.  The port runs:

  dp=N             ZeRO-1 data parallelism: make_plan returns None and the
                   loop's own path (parallel/data_parallel.py) runs it
  fsdp=N[,dp=M]    ZeRO-3 sharding; dp > 1 is the hybrid (FSDP inside
                   groups of N ranks x DP across M) - parallel/fsdp.py,
                   with AdamW, Adafactor or Muon

Tensor, sequence and vocab parallelism, pipelines, the 3-D mesh, expert and
context parallelism raise NotImplementedError naming ROADMAP.md Queue 1
item 18.  A mesh of N ranks runs as N processes (torchrun, or
`multihost.initialize`), one device each.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..config import ViTConfig

_UNPORTED = ("ROADMAP.md Queue 1 item 18: the {} families are not ported "
             "yet (dp and fsdp[,dp] are)")


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
    #   -> (params, opt, loss)
    step: Callable
    # placed params -> host canonical dict (numpy); a collective
    to_canonical: Callable
    # optimizer state -> canonical host tree for checkpoint_tree.save_tree
    opt_save: Callable
    # canonical host tree -> placed optimizer state
    opt_load: Callable

    def validate_batch(self, batch: int):
        ways = self.spec.n_devices
        if batch % ways:
            raise ValueError(f"batch {batch} must divide over the {ways} "
                             f"data-sharding ways of mesh "
                             f"{self.spec.describe()}")


@dataclasses.dataclass(frozen=True)
class TrainKnobs:
    """Features the DP path's AdamW step takes (clip, accumulation, the
    grad-norm log); the FSDP steps keep the lean step, as in JAX."""
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
    spec (the loop's ZeRO-1 path).  Raises NotImplementedError for the
    families not ported yet, ValueError for combinations no factory
    covers.  weight_decay is bound into Muon plans only (their seventh
    step slot carries the AdamW lr)."""
    on = [k for k in ("tp", "pp", "ep", "cp") if getattr(spec, k) > 1]
    if on or spec.sp or spec.vp:
        raise NotImplementedError(_UNPORTED.format(
            "/".join(on + [k for k in ("sp", "vp") if getattr(spec, k)])))
    if not spec.fsdp:
        return None                      # pure DP: the loop's own path
    if knobs.any:
        raise ValueError("fsdp keeps the lean step: clip_norm, accum_steps "
                         "and log_grad_norm ride the dp path, as in JAX")
    if optimizer not in ("adamw", "adafactor", "muon"):
        raise ValueError(f"unknown optimizer {optimizer!r}")
    return _fsdp_plan(cfg, spec, optimizer, device, weight_decay)


def _tensors(tree, device):
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in tree.items()}


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
                  place=place, to_canonical=canonical)
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
