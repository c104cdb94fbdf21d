"""The data-parallel training step: the port of
`vitrs_tpu/parallel/data_parallel.py` (ZeRO-1) on `torch.distributed`.

A mesh is one process a rank, each driving one device (`make_mesh`; more
than one rank needs the process group of `multihost.initialize`).  Each
rank runs the loss and gradients of its share of the batch into the flat
gradient arena, then, in the JAX step's order:

  * reduce-scatter the flat gradient (zero-padded to a multiple of N) and
    divide by N: the rank's ceil(n/N) slice of the global mean gradient;
  * the global norm from the shards (a sum of squares all-reduced) and the
    optional clip, scaled on the shard;
  * the fused AdamW (K7 on the card) over the rank's slice of the flat
    parameter arena, with its m and v shards (ZeRO-1: the state never
    exists whole), decay_2d_only through the slice of `_decay_mask_flat`;
  * all-gather the parameter slices back into the arena;
  * the loss reported as the mean over ranks.

At world size 1 the collectives are identities and are skipped: the shard
is the whole vector.  The collectives are parallel/collectives.py's.

The tree optimizers (`make_dp_train_step_adafactor`, `_muon`) take the
gradients in tree form, as the JAX steps do: the flat gradient is
all-reduced and divided by N (the JAX steps' tree pmean, one collective
here), and their state stays replicated, as in JAX.  The parameters stay
views into the flat arena: each step copies its new parameters back into
them, so the loop, checkpoints and `flat_base` are the AdamW path's.

The flat arena: the parameters must be views into one flat fp32 vector in
canonical order (`params.unflatten_params`, as the trainer keeps them).
The step updates that vector in place and writes the gradients into one
flat buffer through the parameters' `.grad` views, so AdamW runs once over
the rank's slice with no flatten copy (at world size 1 all 124,439,808
values of GPT-2 124M; at 2, 62,219,904 a rank).

ViT mode adds what the JAX step does for images:
  * `normalize` = (mean, std): uint8 batches become (x/255 - mean)/std in
    fp32 on the device (`normalize_images`);
  * mixup (mixup_alpha > 0): lambda ~ Beta(alpha, alpha) and a permutation
    for each step, drawn on the host from np.random.default_rng([0x31A5,
    step]) (`mixup_draw`: no device sync, explicit and repeatable where the
    JAX step draws them on the device from jax.random), and the loss
    lambda CE(y) + (1 - lambda) CE(y[perm]) (`mixup_loss`);
  * stochastic depth and head dropout from a CPU torch.Generator seeded for
    each step, and for each micro-batch under accumulation
    (`step_generator`; the rank + 1 joins the key with more than one
    rank), so a step draws the same flags on any device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import params as PRM
from ..config import ViTConfig
from ..models import model as M
from ..ops import basic
from ..ops import optimizer as opt
from ..ops._build import to_device
from ..utils import trace

_ONE_DEVICE = ("a Mesh drives one device in each process: more ranks come "
                "from torch.distributed, one process a rank "
                "(parallel/multihost.initialize, or torchrun)")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A one-axis ("data") mesh as one rank sees it: its device, its rank,
    the world size and the process group (None: the default group)."""
    devices: Tuple[torch.device, ...]
    rank: int = 0
    world: int = 1
    group: object = None

    def __post_init__(self):
        if len(self.devices) != 1:
            raise RuntimeError(f"Mesh of {len(self.devices)} devices: "
                               f"{_ONE_DEVICE}")

    @property
    def size(self) -> int:
        return self.world

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def make_mesh(n_devices: int = 0, devices: Sequence = None,
              group=None) -> Mesh:
    """The data mesh of this process: every rank of `group` (the default
    group when torch.distributed is up; else this process alone), on
    `devices` (one: this rank's), else on this rank's CUDA device
    (`multihost.local_cuda_device`).  Without `devices` and without a
    CUDA device it raises: a CPU mesh is asked for by name
    (devices=["cpu"]).  n_devices > 0 must equal the world size."""
    from . import multihost
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: torch sees no CUDA device; pass "
                               "devices=['cpu'] for a CPU mesh")
        devices = [multihost.local_cuda_device()]
    world = (torch.distributed.get_world_size(group)
             if torch.distributed.is_initialized() else 1)
    if len(devices) != 1 or (n_devices and n_devices != world):
        raise RuntimeError(f"make_mesh: {n_devices or len(devices)} devices "
                           f"with a world of {world}: {_ONE_DEVICE}")
    rank = torch.distributed.get_rank(group) if world > 1 else 0
    return Mesh((torch.device(devices[0]),), rank, world, group)


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def opt_state_shard_size(cfg: ViTConfig, mesh: Mesh) -> int:
    return _ceil_to(PRM.num_parameters(cfg), mesh.size) // mesh.size


def shard_range(cfg: ViTConfig, mesh: Mesh) -> Tuple[int, int]:
    """[lo, hi): the rank's slice of the flat parameter vector (the last
    rank's may be short of the shard size: the padding is not stored)."""
    shard = opt_state_shard_size(cfg, mesh)
    lo = mesh.rank * shard
    return lo, min(lo + shard, PRM.num_parameters(cfg))


def init_sharded_opt_state(cfg: ViTConfig, mesh: Mesh):
    """ZeRO-1 m and v: this rank's flat fp32 shard of ceil(n/N) values (the
    whole vector at world size 1)."""
    zeros = functools.partial(torch.zeros, opt_state_shard_size(cfg, mesh),
                              dtype=torch.float32, device=mesh.device)
    return zeros(), zeros()


def gather_flat(shard: torch.Tensor, cfg: ViTConfig,
                mesh: Mesh) -> torch.Tensor:
    """The whole flat (n,) vector from the ranks' ZeRO-1 shards (every rank
    gets it; the shard itself at world size 1)."""
    if mesh.size == 1:
        return shard
    from . import collectives as C
    out = torch.empty(shard.shape[0] * mesh.size, dtype=shard.dtype,
                      device=shard.device)
    return C.all_gather(out, shard, mesh.group)[:PRM.num_parameters(cfg)]


def shard_flat(full, cfg: ViTConfig, mesh: Mesh) -> torch.Tensor:
    """The rank's ZeRO-1 shard (zero-padded to the shard size) of a whole
    flat (n,) vector (numpy or tensor), on its device."""
    lo, hi = shard_range(cfg, mesh)
    out = torch.zeros(opt_state_shard_size(cfg, mesh), dtype=torch.float32,
                      device=mesh.device)
    out[:hi - lo] = torch.as_tensor(np.asarray(full[lo:hi], np.float32)
                                    if not isinstance(full, torch.Tensor)
                                    else full[lo:hi])
    return out


def shard_batch(batch, mesh: Mesh) -> torch.Tensor:
    """The rank's contiguous 1/N of a global batch's rows, on its device
    (the JAX P("data") layout)."""
    b = batch.shape[0] // mesh.size
    rows = batch[mesh.rank * b:(mesh.rank + 1) * b]
    return to_device(rows, mesh.device)


def replicate(tree, mesh: Mesh):
    """A tensor dict on the rank's device, equal on every rank: rank 0's
    values are broadcast."""
    out = {k: to_device(v, mesh.device) for k, v in tree.items()}
    if mesh.size > 1:
        from . import collectives as C
        for t in out.values():
            C.broadcast(t, torch.distributed.get_global_rank(
                mesh.group, 0) if mesh.group is not None else 0, mesh.group)
    return out


def normalize_images(x: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8 (B, H, W, C) -> (x/255 - mean) * (1/std) in fp32, the JAX
    step's formula (1/std taken in fp32 on the host)."""
    with trace.span("data.normalize"):
        mean_t = torch.as_tensor(np.asarray(mean, np.float32),
                                 device=x.device)
        inv_t = torch.as_tensor(1.0 / np.asarray(std, np.float32),
                                device=x.device)
        return (x.float() * (1.0 / 255.0) - mean_t) * inv_t


def mixup_draw(alpha: float, step: int, batch: int,
               rank: Optional[int] = None) -> Tuple[float, np.ndarray]:
    """(lambda, permutation) of one step's mixup, from the host generator
    np.random.default_rng([0x31A5, step[, rank + 1]]); lambda is rounded to
    fp32."""
    rng = np.random.default_rng([0x31A5, int(step)]
                                + ([int(rank) + 1] if rank is not None
                                   else []))
    lam = float(np.float32(rng.beta(alpha, alpha)))
    return lam, rng.permutation(batch)


def mixup_loss(params, inputs: torch.Tensor, targets: torch.Tensor,
               lam: float, perm: torch.Tensor, cfg: ViTConfig
               ) -> torch.Tensor:
    """lam CE(y) + (1 - lam) CE(y[perm]) on lam x + (1 - lam) x[perm], as
    the JAX step composes it: fp32 arithmetic on fp32 images, a training
    forward without stochastic depth or dropout (the JAX step passes no rng
    here), label smoothing where set."""
    one_minus = float(np.float32(1.0) - np.float32(lam))
    mixed = lam * inputs + one_minus * inputs[perm]
    logits = M.vit_forward(M.train_params(params, cfg), mixed, cfg,
                           train=True)

    def ce(y):
        if cfg.label_smoothing > 0.0:
            return basic.cross_entropy_smoothed(logits, y,
                                                cfg.label_smoothing).mean()
        return basic.cross_entropy_from_logits(logits, y).mean()

    return lam * ce(targets) + one_minus * ce(targets[perm])


def step_generator(step: int, micro: Optional[int] = None,
                   rank: Optional[int] = None) -> torch.Generator:
    """The CPU generator of one step's stochastic depth and head dropout,
    seeded from (0xDA7A, step[, rank + 1][, micro + 1]), the JAX step's
    fold-ins (rank with more than one, micro only under accumulation; + 1
    because SeedSequence reads a trailing 0 as no word at all)."""
    key = ([0xDA7A, int(step)]
           + ([int(rank) + 1] if rank is not None else [])
           + ([int(micro) + 1] if micro is not None else []))
    seed = int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0])
    return torch.Generator().manual_seed(seed)


def _grads_into_arena(params, cfg: ViTConfig, grad_buf: dict, who: str):
    """(flat params, flat grads): the flat vector `params` are views into
    (else ValueError), and a zeroed flat gradient buffer of the same size,
    kept in grad_buf across steps, whose views become each parameter's
    .grad, so that backward accumulates into it."""
    flat_p = PRM.flat_base(params, cfg)
    if flat_p is None:
        raise ValueError(f"{who}: params must be views into one flat vector "
                         f"(params.unflatten_params)")
    if "g" not in grad_buf:
        grad_buf["g"] = torch.empty_like(flat_p)
    flat_g = grad_buf["g"].zero_()
    for name, g in PRM.unflatten_params(flat_g, cfg).items():
        params[name].requires_grad_(True)
        params[name].grad = g
    return flat_p, flat_g


def _batch_on(inputs, targets, device, cfg: ViTConfig, normalize):
    """The batch on the device: int64 tokens and targets (gpt mode); vit
    images in fp32, uint8 ones normalised by `normalize` = (mean, std)."""
    x = to_device(inputs, device)
    y = to_device(targets, device).long()
    if cfg.mode != "vit":
        x = x.long()
    elif normalize is not None and x.dtype == torch.uint8:
        x = normalize_images(x, *normalize)
    elif x.is_floating_point():
        x = x.float()
    return x, y


def make_dp_train_step(cfg: ViTConfig, mesh: Mesh, accum_steps: int = 1,
                       return_grad_norm: bool = False,
                       mixup_alpha: float = 0.0,
                       normalize=None, clip_norm: float = 0.0,
                       decay_2d_only: bool = False):
    """Build the training step.

    Signature: (params, m, v, inputs, targets, step, lr, wd)
            -> (params, m, v, loss[, grad_norm])
    as in the JAX package: params a parameter dict (fp32 views into one
    flat vector, `params.unflatten_params`; anything else raises), m and v
    the rank's flat AdamW shards (`init_sharded_opt_state`), inputs and
    targets the rank's share of the batch (numpy or tensors), step the
    1-based AdamW step, lr and wd scalars.  loss and grad_norm come back as
    0-d tensors on the device (reading them waits for the step).  params, m
    and v are updated in place and returned.

    accum_steps > 1 splits the batch into that many micro-batches whose
    gradients are averaged; clip_norm > 0 clips to that global norm
    (grad_norm is the norm before the clip); decay_2d_only decays only the
    tensors `_decay_mask_flat` marks.  ViT mode: normalize = (mean, std)
    normalises uint8 images on the device; mixup_alpha > 0 mixes each
    step's batch (not with accumulation, as in the JAX step); stochastic
    depth and head dropout draw from `step_generator`."""
    from . import collectives as C
    vit = cfg.mode == "vit"
    use_mixup = vit and mixup_alpha > 0.0
    if use_mixup and accum_steps != 1:
        raise ValueError("mixup with gradient accumulation is not wired, as "
                         "in the JAX step")
    needs_gen = vit and (cfg.drop_path > 0.0 or cfg.drop_rate > 0.0)
    device, N, group = mesh.device, mesh.size, mesh.group
    rank = mesh.rank if N > 1 else None
    n = PRM.num_parameters(cfg)
    shard = opt_state_shard_size(cfg, mesh)
    n_pad = shard * N
    lo, hi = shard_range(cfg, mesh)
    grad_buf = {}

    def step_fn(params, m, v, inputs, targets, step, lr, wd):
        with trace.span("train.step"):
            return _step(params, m, v, inputs, targets, step, lr, wd)

    def _step(params, m, v, inputs, targets, step, lr, wd):
        with trace.span("train.batch"):
            flat_p, flat_g = _grads_into_arena(params, cfg, grad_buf,
                                               "make_dp_train_step")
            x, y = _batch_on(inputs, targets, device, cfg, normalize)
        micro = x.shape[0] // accum_steps
        loss = torch.zeros((), device=device)
        for i in range(accum_steps):
            rows = slice(i * micro, (i + 1) * micro)
            with trace.span("train.forward"):
                if use_mixup:
                    lam, perm = mixup_draw(mixup_alpha, step, x.shape[0],
                                           rank)
                    li = mixup_loss(params, x, y, lam,
                                    to_device(perm, device), cfg)
                else:
                    gen = (step_generator(step,
                                          i if accum_steps > 1 else None,
                                          rank)
                           if needs_gen else None)
                    li = M.loss_fn(params, x[rows], y[rows], cfg,
                                   generator=gen)
            with trace.span("train.backward"):
                li.backward()
            loss += li.detach()
        if accum_steps > 1:
            loss /= accum_steps
            flat_g.mul_(1.0 / accum_steps)
        if N > 1:
            # the rank's slice of the global mean gradient; the loss's mean
            g_in = (flat_g if n_pad == n
                    else torch.nn.functional.pad(flat_g, (0, n_pad - n)))
            g_shard = C.reduce_scatter(
                torch.empty(shard, device=device), g_in, group)
            g_shard.mul_(1.0 / N)
            loss = C.all_reduce(loss, group) / N
        else:
            g_shard = flat_g
        gnorm = None
        if clip_norm > 0.0 or return_grad_norm:
            with trace.span("train.clip"):
                # the JAX form (norm² summed over the shards);
                # torch.linalg.vector_norm's fp32 CPU reduction loses ~1e-4
                # relative over millions of values
                sq = g_shard.square().sum()
                gnorm = (C.all_reduce(sq, group) if N > 1 else sq).sqrt()
                if clip_norm > 0.0:
                    g_shard.mul_(torch.clamp(clip_norm / (gnorm + 1e-6),
                                             max=1.0))
        lr, wd = float(lr), float(wd)
        k = hi - lo
        p_shard, g_own, m_own, v_own = (flat_p[lo:hi], g_shard[:k], m[:k],
                                        v[:k])
        with trace.span("train.optimizer"):
            if decay_2d_only:
                # AdamW without decay, then the masked decoupled term from
                # the pre-update shard: exact, since AdamW's decay term
                # reads the old p too
                p_old = p_shard.clone()
                opt.adamw_step(p_shard, g_own, m_own, v_own, step, lr,
                               weight_decay=0.0)
                with torch.no_grad():
                    p_shard.sub_(_decay_mask_flat(cfg, n_pad, device)[lo:hi]
                                 * p_old * (lr * wd))
            else:
                opt.adamw_step(p_shard, g_own, m_own, v_own, step, lr,
                               weight_decay=wd)
        if N > 1:
            with torch.no_grad():
                mine = torch.zeros(shard, device=device)
                mine[:k] = p_shard
                if n_pad == n:
                    C.all_gather(flat_p, mine, group)
                else:
                    flat_p.copy_(C.all_gather(
                        torch.empty(n_pad, device=device), mine, group)[:n])
        if return_grad_norm:
            return params, m, v, loss, gnorm
        return params, m, v, loss

    return step_fn


def _make_tree_step(cfg: ViTConfig, mesh: Mesh, update, who: str,
                    normalize=None, clip_norm: float = 0.0):
    """The training step of an optimizer over the parameter dict (tree
    form): loss and gradients into the flat arena, their mean over the
    ranks (one all-reduce of the flat gradient), the optional global-norm
    clip, then update(params, grads, state, step, lr, extra) -> (new
    params, new state), whose new parameters are copied into the arena in
    place.  As in the JAX tree steps the loss takes no rng (no stochastic
    depth or head dropout); vit images are normalised (`_batch_on`)."""
    from . import collectives as C
    device, N, group = mesh.device, mesh.size, mesh.group
    grad_buf = {}

    def step_fn(params, state, inputs, targets, step, lr, extra):
        _, flat_g = _grads_into_arena(params, cfg, grad_buf, who)
        x, y = _batch_on(inputs, targets, device, cfg, normalize)
        loss = M.loss_fn(params, x, y, cfg)
        loss.backward()
        loss = loss.detach()
        if N > 1:
            C.all_reduce(flat_g, group).mul_(1.0 / N)
            loss = C.all_reduce(loss, group) / N
        if clip_norm > 0.0:
            gnorm = flat_g.square().sum().sqrt()
            flat_g.mul_(torch.clamp(clip_norm / (gnorm + 1e-6), max=1.0))
        grads = {k: t.grad for k, t in params.items()}
        new_p, state = update(params, grads, state, step, lr, extra)
        with torch.no_grad():
            for k, t in new_p.items():
                params[k].copy_(t)
        return params, state, loss

    return step_fn


def make_dp_train_step_adafactor(cfg: ViTConfig, mesh: Mesh, normalize=None):
    """The training step with Adafactor (ops/adafactor.py), as the JAX
    `make_dp_train_step_adafactor` with relative steps.

    Signature: (params, state: AdafactorState, inputs, targets, step, lr,
    wd) -> (params, state, loss).  params are views into one flat fp32
    vector, updated in place; step is the 1-based step (the β2 schedule),
    lr the relative step size, wd decoupled decay (as lr · wd · p) on the
    tensors `decay_mask_2d` marks."""
    from ..ops import adafactor as AF

    def update(params, grads, state, step, lr, wd):
        return AF.step(params, grads, state, step, lr, weight_decay=wd,
                       decay_mask=opt.decay_mask_2d(params))

    return _make_tree_step(cfg, mesh, update, "make_dp_train_step_adafactor",
                           normalize)


def make_dp_train_step_muon(cfg: ViTConfig, mesh: Mesh,
                            clip_norm: float = 0.0,
                            weight_decay: float = 0.0, normalize=None):
    """The training step with the hybrid Muon/AdamW optimizer
    (ops/muon.py), as the JAX `make_dp_train_step_muon`.

    Signature: (params, state: MuonState, inputs, targets, step, lr, alr)
    -> (params, state, loss): lr the Muon lr, alr the AdamW lr of the other
    tensors; AdamW's step is step + 1, as the JAX step passes it."""
    from ..ops import muon as MU

    def update(params, grads, state, step, lr, alr):
        return MU.step(params, grads, state, step + 1, lr, adamw_lr=alr,
                       weight_decay=weight_decay)

    return _make_tree_step(cfg, mesh, update, "make_dp_train_step_muon",
                           normalize, clip_norm)


@functools.lru_cache(maxsize=2)
def _decay_mask_flat(cfg: ViTConfig, n_pad: int, device: torch.device
                     ) -> torch.Tensor:
    """Flat 0/1 mask over the canonical parameter vector: 1 where the
    tensor has >= 2 axes (decayed), 0 elsewhere, zero-padded to n_pad.  As
    in the JAX package, the stacked (L, C) biases and LN parameters count
    as 2-D and are decayed (ROADMAP.md Queue 3)."""
    shapes = PRM.param_shapes(cfg)
    parts = [torch.full((int(torch.Size(shapes[k]).numel()),),
                        1.0 if len(shapes[k]) >= 2 else 0.0)
             for k in PRM.tensor_order(cfg)]
    flat = torch.cat(parts)
    flat = torch.nn.functional.pad(flat, (0, n_pad - flat.shape[0]))
    return flat.to(device)
