"""Muon under tensor parallelism: the port of the TP half of
`vitrs_tpu/parallel/muon_parallel.py` (the FSDP half is in
parallel/fsdp.py).

The Muon matrices are column / row sliced over the model group
(tensor_parallel's layout).  The momentum stays sliced (it is elementwise);
the Nesterov effective gradient is all-gathered back to the canonical
stacked matrix (MHA: qkv3w reshaped to (L, 3C, C); GQA: qw | kw | vw
concatenated on the output dim, so Newton-Schulz runs on the packed matrix
the one-device step sees); Newton-Schulz runs sliced over the model group
on the layer dim when tp divides L (each rank orthogonalises L/tp layers,
then one all-gather), on every rank whole otherwise; and each rank keeps
its own slice of the update.  Gathering and slicing are exact, so the
update is `ops/muon.step`'s on one device up to the order of the sums.
vit mode's patch embedding is whole on every rank and runs whole.  AdamW
(`optimizer.adamw_tree`, decay masked by `decay_mask_2d`) takes the other
leaves, at the step's AdamW lr, with AdamW's step as given.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..config import ViTConfig
from ..ops import muon as MU
from ..ops import optimizer as opt
from . import collectives as C
from . import tensor_parallel as TPm


def _tp_muon_layout(cfg: ViTConfig) -> Dict[str, int]:
    """{TP leaf: its model-sliced dim} of the Muon-owned leaves."""
    lay = {"attprojw": 2, "fcw": 1, "fcprojw": 2}
    if cfg.is_gqa:
        lay.update(qw=1, kw=1, vw=1)
    else:
        lay["qkv3w"] = 2
    return lay


def tp_muon_keys(cfg: ViTConfig):
    keys = list(_tp_muon_layout(cfg))
    if cfg.mode == "vit":
        keys.append("patchw")
    return tuple(keys)


def _gather_dim(x: torch.Tensor, mesh: C.MeshGroups, dim: int):
    spec = [None] * x.dim()
    spec[dim] = "model"
    return TPm.gather(x, tuple(spec), mesh)


def _slice_own(x: torch.Tensor, mesh: C.MeshGroups, dim: int):
    n = x.shape[dim] // mesh.size("model")
    return x.narrow(dim, mesh.index("model") * n, n)


def _ns_canonical(eff: torch.Tensor, mesh: C.MeshGroups) -> torch.Tensor:
    """Newton-Schulz of a canonical (L, OC, IC) stack in fp32: sliced over
    the model group on L when tp divides it, then gathered."""
    tp, L = mesh.size("model"), eff.shape[0]
    if tp > 1 and L % tp == 0:
        o = MU.newton_schulz5(_slice_own(eff, mesh, 0)).float()
        return _gather_dim(o, mesh, 0)
    return MU.newton_schulz5(eff).float()


def _scale(eff: torch.Tensor) -> float:
    return max(1.0, eff.shape[-2] / eff.shape[-1]) ** 0.5


def _tp_muon_update(p, grads, momentum, cfg: ViTConfig, lr: float,
                    weight_decay: float, mesh: C.MeshGroups):
    """The Muon half of the hybrid step on the TP leaves: (new params, new
    momentum), as `ops/muon.step`'s matrix branch."""
    new_p, new_mom, eff = {}, {}, {}
    for k in p:
        gf = grads[k].float()
        buf = MU.MOMENTUM * momentum[k] + gf
        new_mom[k] = buf
        eff[k] = gf + MU.MOMENTUM * buf             # Nesterov

    def apply(k, o_local, scale):
        pf = p[k].float()
        if weight_decay:
            pf = pf * (1.0 - lr * weight_decay)
        new_p[k] = (pf - lr * scale * o_local).to(p[k].dtype)

    if cfg.is_gqa:
        parts = [_gather_dim(eff[k], mesh, 1) for k in ("qw", "kw", "vw")]
        whole = torch.cat(parts, dim=1)             # (L, C + 2 kvd, C)
        o, off = _ns_canonical(whole, mesh), 0
        for k, part in zip(("qw", "kw", "vw"), parts):
            sz = part.shape[1]
            apply(k, _slice_own(o[:, off:off + sz], mesh, 1), _scale(whole))
            off += sz
    else:
        full = _gather_dim(eff["qkv3w"], mesh, 2)   # (L, 3, C, C)
        L, _, Cc, _ = full.shape
        whole = full.reshape(L, 3 * Cc, Cc)
        o = _ns_canonical(whole, mesh).reshape(L, 3, Cc, Cc)
        apply("qkv3w", _slice_own(o, mesh, 2), _scale(whole))
    for k in ("attprojw", "fcw", "fcprojw"):
        dim = _tp_muon_layout(cfg)[k]
        whole = _gather_dim(eff[k], mesh, dim)
        apply(k, _slice_own(_ns_canonical(whole, mesh), mesh, dim),
              _scale(whole))
    if "patchw" in p:
        apply("patchw", MU.newton_schulz5(eff["patchw"]).float(),
              _scale(eff["patchw"]))
    return new_p, new_mom


def _split_qkv(t, cfg: ViTConfig, bias: bool):
    """A canonical qkvw- or qkvb-shaped array -> its TP leaves."""
    Cc, s = cfg.channels, "b" if bias else "w"
    if cfg.is_gqa:
        kvd = cfg.kv_dim
        return {"q" + s: t[:, :Cc], "k" + s: t[:, Cc:Cc + kvd],
                "v" + s: t[:, Cc + kvd:]}
    shape = (cfg.num_layers, 3, Cc) if bias else (cfg.num_layers, 3, Cc, Cc)
    return {"qkv3" + s: t.reshape(shape)}


def muon_state_to_tp(state: MU.MuonState, cfg: ViTConfig):
    """A canonical MuonState (numpy or torch) -> (momentum, m, v) dicts in
    the TP layout, whole."""
    mom, m, v = dict(state.momentum), dict(state.m), dict(state.v)
    mom.update(_split_qkv(mom.pop("qkvw"), cfg, False))
    for t in (m, v):
        t.update(_split_qkv(t.pop("qkvb"), cfg, True))
    return mom, m, v


def muon_state_from_tp(mom: Mapping, m: Mapping, v: Mapping,
                       cfg: ViTConfig) -> MU.MuonState:
    """Inverse of muon_state_to_tp (whole numpy trees)."""
    L, Cc = cfg.num_layers, cfg.channels
    mom, m, v = dict(mom), dict(m), dict(v)
    if cfg.is_gqa:
        mom["qkvw"] = np.concatenate([mom.pop(k) for k in ("qw", "kw", "vw")],
                                     axis=1)
        for t in (m, v):
            t["qkvb"] = np.concatenate([t.pop(k) for k in ("qb", "kb", "vb")],
                                       axis=1)
    else:
        mom["qkvw"] = np.asarray(mom.pop("qkv3w")).reshape(L, 3 * Cc, Cc)
        for t in (m, v):
            t["qkvb"] = np.asarray(t.pop("qkv3b")).reshape(L, 3 * Cc)
    return MU.MuonState(momentum=mom, m=m, v=v)


def place_tp_muon_state(state: MU.MuonState, cfg: ViTConfig,
                        mesh: C.MeshGroups):
    """A canonical MuonState -> this rank's TP slices."""
    specs = TPm.tp_param_specs(cfg)
    return tuple(TPm.place_tree(t, specs, mesh)
                 for t in muon_state_to_tp(state, cfg))


def gather_tp_muon_state(mom, m, v, cfg: ViTConfig,
                         mesh: C.MeshGroups) -> MU.MuonState:
    """This rank's slices -> the canonical MuonState, numpy (a
    collective)."""
    specs = TPm.tp_param_specs(cfg)
    return muon_state_from_tp(*(TPm.gather_tree(t, specs, mesh)
                                for t in (mom, m, v)), cfg)


def init_tp_muon_state(tp_params: Mapping[str, torch.Tensor],
                       cfg: ViTConfig):
    """(momentum over the Muon leaves, AdamW m, v over the rest): zeros
    shaped like the rank's slices."""
    mu = set(tp_muon_keys(cfg))
    z = {k: torch.zeros_like(t) for k, t in tp_params.items()}
    rest = [k for k in tp_params if k not in mu]
    return ({k: z[k] for k in tp_muon_keys(cfg)},
            {k: z[k] for k in rest}, {k: torch.zeros_like(z[k]) for k in rest})


def make_tp_muon_train_step(cfg: ViTConfig, mesh: C.MeshGroups,
                            sequence_parallel: bool = False,
                            weight_decay: float = 0.0):
    """The TP hybrid Muon/AdamW step: (tp_params, mom, m, v, inputs,
    targets, step, lr, alr) -> (tp_params, mom, m, v, loss); mom the
    sliced Muon momentum, m and v AdamW's over the other leaves."""
    TPm.check_tp(cfg, mesh.size("model"), False, sequence_parallel)
    mu_keys = tp_muon_keys(cfg)
    grads_fn = TPm.make_tp_grads(cfg, mesh, sequence_parallel)

    def step_fn(p, mom, m, v, inputs, targets, step, lr, alr):
        loss, grads = grads_fn(p, inputs, targets)
        with torch.no_grad():
            new_p, mom = _tp_muon_update({k: p[k] for k in mu_keys}, grads,
                                         mom, cfg, float(lr), weight_decay,
                                         mesh)
        rest = {k: t for k, t in p.items() if k not in mu_keys}
        rest_new, m, v = opt.adamw_tree(
            rest, {k: grads[k] for k in rest}, m, v, step, float(alr),
            weight_decay=weight_decay, decay_mask=opt.decay_mask_2d(rest))
        new_p.update(rest_new)
        return {k: new_p[k] for k in p}, mom, m, v, loss

    return step_fn
