"""Training loop — the port of `vitrs_tpu/train/loop.py` for gpt and vit
mode, AdamW, Adafactor or Muon, on one device or one rank of many.

    init or resume -> loop { batch; cosine lr; train step; log; checkpoint }
    -> final checkpoint -> held-out val loss (gpt) or top-1 + loss (vit)

* The parameters live as views into one flat fp32 vector on the device
  (`params.unflatten_params`), so the step's fused AdamW (K7) updates them
  in place with no flatten copy (parallel/data_parallel.py).
* The log line per `log_every` steps is JSON: step, loss, lr, examples/s
  (`imgs_per_sec`, the JAX loop's name: images in vit mode, sequences in
  gpt mode), tok/s, the loader's host ms a batch (`loader_ms`, timed apart
  from the step) and, on a CUDA device, MFU against its peak
  (utils/flops.py; an unknown card raises; null on the CPU, which has no
  peak to hold a run against).  Reading the loss there is the loop's only
  synchronisation with the device.
* vit mode reads an image dataset (`data/datasets.get_dataset`: cifar10,
  synthetic-shapes, synthetic-imagenet; `dataset_size` sets the n of the
  last two) through `DataLoader(device_normalize=True)`: uint8 batches,
  normalised on the device by the step, as the JAX loop does for
  in-memory datasets.  `label_smoothing`, `mixup_alpha` and `drop_path`
  are the JAX TrainConfig's (drop_path among its model_overrides there).
* Checkpoints (params, flat m/v, step, seed, data cursor) every
  `ckpt_every` steps and at the end, in the format both packages read; a run
  resumes from the latest in `workdir`.  With no `workdir` a run writes to
  a fresh directory under `tempfile.gettempdir()` (which honours TMPDIR)
  and so never resumes another run's checkpoint.
* `optimizer`: "adamw" (the flat fused AdamW, K7), "adafactor" (lr is the
  relative step size, about 1e-2; decay on the >= 2-axis tensors) or
  "muon" (lr is the matrix lr, about 0.02; `muon_adamw_lr` drives the
  other tensors on the same cosine shape), through the tree-form steps of
  parallel/data_parallel.py, which take no accumulation, mixup or grad-norm
  log (ValueError), as in the JAX loop.  Their state rides a side tree
  beside each checkpoint (`adafactor_{step:08d}.tree`,
  `muon_{step:08d}.tree`, checkpoint_tree.py, with the data cursor in its
  meta; the .bin then holds no m/v), as the JAX loop writes it; an
  Adafactor tree whose factoring layout differs from the current one is
  refused on resume.

* Every loader runs behind `data/prefetch.DevicePrefetcher` (depth
  `prefetch`, 2 as in the JAX loop; 0 calls the loader in the step's
  thread): a thread fills pinned buffers and copies them to the card on a
  side stream.  `loader_ms` stays the host time to produce a batch;
  `wait_ms` is the time the step waited for one.
* `dataset="imagenet"` streams `.vshard` JPEG shards from `data_dir`
  (data/imagenet.py: native decode, RandomResizedCrop, flip and
  RandAugment `ra_ops`/`ra_mag`; fp32 batches normalised on the host), the
  decoder that ran in the log (`decoder`); the final evaluation
  (`evaluate_streaming`) reads the val split, else the train split.
* `remat`: None keeps the preset's own setting (gpt2-124m-4k sets True),
  else False, True (selective, models/selective.py) or "full" (the JAX
  loop passes its TrainConfig's False over the preset).
* `ema_decay` > 0: an fp32 EMA of the flat parameters, one `lerp_` after
  each step (ops/ema.py), `ema_{step:08d}.tree` beside each checkpoint,
  resumed from there; the final evaluation reads the EMA weights.
* `async_ckpt` (the default, as in the JAX loop): AdamW checkpoints are
  snapshotted on the device and written by a thread
  (checkpoint_async.AsyncCheckpointer); the run drains it before it
  returns.  The checkpoint's cursor counts the examples the completed
  steps consumed, not the loader's, which runs ahead by the prefetch.
* `profile_at`: that step under torch.profiler, a Chrome trace in
  workdir/profile/ (utils/profiling.trace).  `run_steps` stops a run after
  that many steps, its schedule still spanning `steps`: the
  kill-and-resume knob.

* Ranks: when a torch.distributed process group is up (torchrun, or
  `parallel/multihost.initialize`), every rank runs this function on its
  own device (`TrainConfig.device`: "cuda" is cuda:LOCAL_RANK and must
  exist; "cuda:0" names a card on purpose; "cpu"), each loader takes its
  `(rank, world)` stride of the global batch, the step is ZeRO-1 at that
  world size (parallel/data_parallel.py), and rank 0 alone writes the
  checkpoints, side trees, metrics and log lines (the AdamW m and v are
  gathered from the shards first).  `mesh`: "dp=N" asks for exactly that
  world; "fsdp=N[,dp=M]", "tp=N[,dp=M][,sp][,vp]", "pp=N[,dp=M]
  [,schedule=..,v=..,mb=..]", "tp=N,pp=K[,dp=M][,sp][,vp]",
  "ep=N[,dp=M][,tp=K[,vp]]" (MoE configs) and "cp=N[,dp=M]" (gpt) run
  `_train_mesh` through a train/mesh.py Plan (each rank reads its data
  block's rows, under cp only its ctx block's columns of them; checkpoints
  in the canonical layout, optimizer state in `meshopt_{step:08d}.tree`,
  so a run resumes under another mesh; clip, accumulation and the
  grad-norm log reach the tp, pp, 3-D and dp x ep AdamW steps).
`model_overrides` is the JAX TrainConfig's dict of config fields (e.g.
{"max_seq_len": 8192, "window": 1024, "pos_emb": "rope"}, the
long-context rope + sliding-window model, {"num_experts": 8} for MoE, or
{"quirks": True}, the reference's math as written).  The port's `kv_heads` field is kept: it
sets `num_kv_heads` among the overrides.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import json
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from .. import checkpoint as ckpt_io
from .. import checkpoint_async as ckpt_async_io
from .. import checkpoint_tree as CT
from .. import params as PRM
from ..config import ViTConfig, get_config
from ..data import augment as A
from ..data import datasets as D
from ..data import imagenet as IN
from ..data import tokens as TOK
from ..data.prefetch import DevicePrefetcher
from ..models import model as M
from ..ops import adafactor as AF
from ..ops import basic
from ..ops import ema as EMA
from ..ops import muon as MU
from ..ops import optimizer as opt
from ..ops._build import resolve_device
from ..parallel import data_parallel as dp
from ..parallel import multihost
from ..utils import flops as F
from ..utils import profiling
from . import mesh as MS


@dataclasses.dataclass
class TrainConfig:
    """The JAX TrainConfig's fields that a run on one device reads, with
    its defaults except: preset (gpt2-124m here) and remat (None: the
    preset's own); `kv_heads` (shorthand for num_kv_heads among the
    overrides; setting both raises), `drop_path` (a model override in the
    JAX loop), `dataset_size`, `prefetch` and `device` are the port's own.
    `mesh` is a train/mesh.py spec ("dp=2", "fsdp=2", "tp=2,pp=2", ...)."""
    preset: str = "gpt2-124m"
    dataset: str = "cifar10"       # vit: the image dataset; gpt mode reads
                                   # tokens, and a non-empty dataset asks
                                   # for the final val loss
    data_dir: Optional[str] = None  # cifar10's python batches, or an llm.c
                                    # uint16 token file; else synthetic
    dataset_size: int = 0          # n of synthetic-shapes/-imagenet, both
                                   # splits (0: the dataset's default)
    steps: int = 1000
    run_steps: int = 0             # stop after this many steps this run
                                   # (0: run to `steps`); the schedule
                                   # still spans `steps`
    batch_size: int = 128
    lr: float = 1e-3
    warmup: int = 100
    weight_decay: float = 0.05
    min_lr: float = 1e-5
    seed: int = 0
    dtype: str = "bfloat16"
    log_every: int = 20
    ckpt_every: int = 500
    workdir: str = ""              # "" = a fresh temporary directory
    resume: bool = True
    init_ckpt: Optional[str] = None  # warm-start weights; step/cursor not
                                     # loaded — fresh schedule
    profile_at: int = 0            # a Chrome trace of this step (0: none)
    remat: object = None           # None: the preset's; False | True
                                   # (selective) | "full"
    log_grad_norm: bool = False
    clip_norm: float = 0.0         # 0 = off; 1.0 = the standard GPT recipe
    decay_2d_only: bool = False    # the JAX package's ">= 2 axes" decay rule
    accum_steps: int = 1           # micro-batches per step
    label_smoothing: float = 0.0   # vit: CE label smoothing
    drop_path: float = 0.0         # vit: stochastic depth, 0..drop_path
                                   # over the layers
    mesh: str = ""
    optimizer: str = "adamw"       # "adamw" | "adafactor" (lr: the relative
                                   # step size, ~1e-2) | "muon" (lr: the
                                   # matrix lr, ~0.02)
    muon_adamw_lr: float = 6e-4    # muon: AdamW lr of the other tensors
    ra_ops: int = 0                # RandAugment ops an image (imagenet)
    ra_mag: float = 0.0            # RandAugment magnitude in [0, 1]
    ema_decay: float = 0.0         # 0 = off; e.g. 0.9999 for ViT recipes
    mixup_alpha: float = 0.0       # vit: mixup Beta(alpha, alpha)
    async_ckpt: bool = True        # device snapshot, written by a thread
    prefetch: int = 2              # prefetch depth; 0: no prefetch thread
    kv_heads: int = 0              # GQA/MQA K/V heads; 0 = MHA
    device: str = "cuda"           # "cuda" (cuda:LOCAL_RANK under a
                                   # launcher; never falls back), "cuda:N"
                                   # or "cpu"
    model_overrides: Optional[dict] = None   # config fields over the preset


def _check_supported(tc: TrainConfig) -> None:
    if tc.optimizer not in ("adamw", "adafactor", "muon"):
        raise ValueError(f"unknown optimizer {tc.optimizer!r}")
    if tc.optimizer != "adamw" and (tc.accum_steps != 1 or tc.mixup_alpha
                                    or tc.log_grad_norm):
        raise ValueError(f"{tc.optimizer} keeps the lean step: gradient "
                         f"accumulation, mixup and the grad-norm log are "
                         f"AdamW's, as in the JAX loop")


def _load_tree_state(path: str, params, optimizer: str, device):
    """(state, meta) from a side tree written by `_tree_state_numpy`.  An
    Adafactor state must have the layout `AF.init_state` gives these params
    now (the factored/full split follows MIN_FACTOR): a state written under
    another gate would not fail on its own (a 0-d vf placeholder broadcasts
    in the full branch and silently resets that tensor's EMA), so every
    leaf's shape is checked."""
    host, meta = CT.load_tree(path)

    def tensors(tree):
        return {k: torch.as_tensor(v, device=device) for k, v in tree.items()}

    if optimizer == "muon":
        return MU.MuonState(**{f: tensors(host[f])
                               for f in MU.MuonState._fields}), meta
    # the m dict is empty at beta1=0 and an empty dict does not survive the
    # tree writer: default it back
    state = AF.AdafactorState(**{f: tensors(host.get(f, {}))
                                 for f in AF.AdafactorState._fields})
    expect = AF.init_state(params)
    bad = [f"{f}[{k}]: {tuple(got[k].shape) if k in got else None} != "
           f"{tuple(v.shape)}"
           for f in ("vr", "vc", "vf")
           for got in (getattr(state, f),)
           for k, v in getattr(expect, f).items()
           if k not in got or got[k].shape != v.shape]
    if bad:
        raise ValueError(
            f"adafactor state in {path} does not match the current "
            f"factoring layout (MIN_FACTOR={AF.MIN_FACTOR}); mismatched "
            f"leaves: {bad[:4]}{'...' if len(bad) > 4 else ''}; delete the "
            f".tree to re-init (resets the optimizer EMA) or resume with the "
            f"build that wrote it")
    return state, meta


def _tree_state_numpy(state) -> dict:
    """A tree optimizer's state as nested dicts of numpy arrays."""
    return {f: {k: t.detach().cpu().numpy() for k, t in tree.items()}
            for f, tree in state._asdict().items()}


def device_kind(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)


def _latest_ckpt(workdir: str) -> Optional[str]:
    paths = sorted(glob.glob(os.path.join(workdir, "ckpt_*.bin")))
    return paths[-1] if paths else None


def _loss_on(cfg: ViTConfig, params, xb, yb, device) -> float:
    with torch.no_grad():
        return float(M.loss_fn(params, torch.as_tensor(xb, device=device).long(),
                               torch.as_tensor(yb, device=device).long(), cfg))


def evaluate(cfg: ViTConfig, params, ds: D.Dataset, batch: int = 256) -> dict:
    """Top-1 accuracy and mean CE over an eval dataset: whole batches in
    order, the eval transform (no crop, no flip, normalised on the host),
    the inference forward (no dropout), as the JAX function does.  params:
    a tensor dict (master or prepared); batches go to the device of its
    wte."""
    device = params["wte"].device
    pp = M.prepare_params(params, cfg)
    correct, total, loss_sum = 0, 0, 0.0
    with torch.no_grad():
        for start in range(0, len(ds) - batch + 1, batch):
            idx = np.arange(start, start + batch)
            x = A.augment_batch(ds.images, idx, crop_pad=0, flip=False,
                                mean=ds.mean, std=ds.std)
            y = torch.as_tensor(ds.labels[idx], device=device)
            logits = M.vit_forward(pp, torch.as_tensor(x, device=device), cfg)
            correct += int((logits.argmax(-1) == y).sum())
            loss_sum += float(basic.cross_entropy_from_logits(logits, y).sum())
            total += batch
    return {"acc": correct / max(total, 1), "loss": loss_sum / max(total, 1),
            "n": total}


def image_dataset(tc: "TrainConfig", cfg: ViTConfig, train: bool) -> D.Dataset:
    """The run's image dataset split; `dataset_size` sets the n of
    synthetic-shapes and synthetic-imagenet (both splits), else each
    dataset's default (cifar10's synthetic stand-in is always 4096 / 512)."""
    kw = {"n": tc.dataset_size} if tc.dataset_size else {}
    if tc.dataset == "synthetic-imagenet":
        kw.update(img_size=cfg.img_size, num_classes=cfg.num_classes)
    return D.get_dataset(tc.dataset, tc.data_dir, train=train, **kw)


def evaluate_gpt(cfg: ViTConfig, params, data_dir: Optional[str] = None,
                 seed: int = 0, batch: int = 16, max_batches: int = 8) -> dict:
    """Held-out val loss and perplexity over the TokenLoader holdout
    windows (the split training never wraps into).  params: a tensor dict;
    batches go to the device of its wte."""
    stream = TOK.get_tokens(data_dir, cfg.vocab_size, seed=seed)
    total_w = (len(stream) - 1) // cfg.max_seq_len
    holdout = TOK.default_holdout(total_w)
    batch = min(batch, holdout)
    val = TOK.TokenLoader(stream, batch, cfg.max_seq_len, holdout=holdout,
                          val=True)
    device = params["wte"].device
    n = min(max_batches, max(1, holdout // batch))
    losses = [_loss_on(cfg, params, *val.next_batch(), device)
              for _ in range(n)]
    mean = float(np.mean(losses))
    return {"val_loss": mean, "ppl": float(np.exp(min(mean, 20.0))),
            "windows": n * batch}


def evaluate_streaming(cfg: ViTConfig, params, loader,
                       max_batches: int = 0) -> dict:
    """Top-1 accuracy and mean CE over a StreamingLoader(train=False): the
    imagenet evaluation (resize the shorter side, centre crop, one pass in
    order), as the JAX function computes it.  params: a tensor dict;
    batches go to the device of its wte."""
    device = params["wte"].device
    pp = M.prepare_params(params, cfg)
    steps = loader.steps_per_epoch
    if max_batches:
        steps = min(steps, max_batches)
    correct, total, loss_sum = 0, 0, 0.0
    with torch.no_grad():
        for _ in range(steps):
            x, y = loader.next_batch()
            y = torch.as_tensor(y, device=device)
            logits = M.vit_forward(pp, torch.as_tensor(x, device=device), cfg)
            correct += int((logits.argmax(-1) == y).sum())
            loss_sum += float(basic.cross_entropy_from_logits(logits, y).sum())
            total += len(y)
    return {"acc": correct / max(total, 1), "loss": loss_sum / max(total, 1),
            "n": total}


def _streaming_val(tc: "TrainConfig", cfg: ViTConfig):
    """The imagenet evaluation's loader: the val split, else the train
    split, in order."""
    try:
        ds = IN.ShardedImageNet(tc.data_dir, split="val")
    except FileNotFoundError:
        ds = IN.ShardedImageNet(tc.data_dir, split="train")
    return IN.StreamingLoader(ds, min(tc.batch_size, 256), cfg.img_size,
                              train=False)


def rank_device(name: str) -> torch.device:
    """The device this rank trains on: `resolve_device`, and under a
    process group a CUDA device of the rank's own
    (`multihost.local_cuda_device`), made current."""
    device = resolve_device(name)
    if device.type == "cuda" and multihost.world_size() > 1:
        device = multihost.local_cuda_device(name)
    if device.index is not None:
        torch.cuda.set_device(device)
    return device


def _shared_workdir(tc: TrainConfig) -> str:
    """tc.workdir, else a fresh temporary directory made by rank 0 and
    sent to the others."""
    workdir = tc.workdir
    if not workdir:
        workdir = (tempfile.mkdtemp(prefix="vitrs_torch_run_")
                   if multihost.is_primary() else "")
        if multihost.world_size() > 1:
            box = [workdir]
            torch.distributed.broadcast_object_list(box, 0)
            workdir = box[0]
    os.makedirs(workdir, exist_ok=True)
    if multihost.is_primary():
        print(f"[workdir] {workdir}")
    return workdir


def _loader(tc: TrainConfig, cfg: ViTConfig, cursor: int,
            device_normalize: bool = True, shard=None):
    """(the training loader, the (mean, std) the step normalises uint8
    images with, or None); each rank reads its (rank, world) stride of
    every global batch, or shard = (block, blocks): a mesh plan's data
    rank and ways, so that the ranks of a model or pipe group read the
    same rows."""
    block, blocks = shard or (multihost.rank(), multihost.world_size())
    shard = dict(host_id=block, num_hosts=blocks)
    if cfg.mode == "vit" and tc.dataset == "imagenet":
        # fp32 batches normalised on the host by the decode pipeline
        ds = IN.ShardedImageNet(tc.data_dir, split="train")
        return IN.StreamingLoader(ds, tc.batch_size, cfg.img_size,
                                  train=True, seed=tc.seed, cursor=cursor,
                                  ra_ops=tc.ra_ops, ra_mag=tc.ra_mag,
                                  **shard), None
    if cfg.mode == "vit":
        # uint8 batches normalised on the device by the step (or fp32 ones
        # normalised on the host)
        ds = image_dataset(tc, cfg, train=True)
        loader = D.DataLoader(ds, tc.batch_size, seed=tc.seed, train=True,
                              cursor=cursor,
                              device_normalize=device_normalize, **shard)
        return loader, (ds.mean, ds.std) if device_normalize else None
    stream = TOK.get_tokens(tc.data_dir, cfg.vocab_size, seed=tc.seed)
    total_w = (len(stream) - 1) // cfg.max_seq_len
    return TOK.TokenLoader(stream, tc.batch_size, cfg.max_seq_len,
                           cursor=cursor,
                           holdout=TOK.default_holdout(total_w),
                           **shard), None


class _SeqBlock:
    """A token loader's batches cut to one block of the sequence: the
    columns [block*T/blocks, (block+1)*T/blocks) of inputs and targets (a
    cp plan's ctx block); every other attribute is the loader's."""

    def __init__(self, loader, block: int, blocks: int):
        self.loader, self.block, self.blocks = loader, block, blocks

    def next_batch(self):
        x, y = self.loader.next_batch()
        t = x.shape[1] // self.blocks
        cols = slice(self.block * t, (self.block + 1) * t)
        return x[:, cols], y[:, cols]

    def __getattr__(self, name):
        return getattr(self.loader, name)


def _make_step(tc: TrainConfig, cfg: ViTConfig, mesh, normalize):
    """The run's step, one signature for the three optimizers:
    (params, state, inputs, targets, step, lr) -> (params, state, loss,
    grad norm or None); state is the flat (m, v) for AdamW, the tree state
    otherwise."""
    if tc.optimizer == "adafactor":
        fn = dp.make_dp_train_step_adafactor(cfg, mesh, normalize=normalize)

        def step_fn(params, state, inputs, targets, step, lr):
            return (*fn(params, state, inputs, targets, step, lr,
                        tc.weight_decay), None)
    elif tc.optimizer == "muon":
        fn = dp.make_dp_train_step_muon(cfg, mesh, clip_norm=tc.clip_norm,
                                        weight_decay=tc.weight_decay,
                                        normalize=normalize)

        def step_fn(params, state, inputs, targets, step, lr):
            # the same cosine shape for the AdamW half, its min_lr scaled in
            # proportion
            alr = opt.cosine_lr_host(
                step, tc.muon_adamw_lr, tc.warmup, tc.steps,
                tc.min_lr * tc.muon_adamw_lr / max(tc.lr, 1e-12))
            return (*fn(params, state, inputs, targets, step, lr, alr), None)
    else:
        fn = dp.make_dp_train_step(cfg, mesh, accum_steps=tc.accum_steps,
                                   return_grad_norm=tc.log_grad_norm,
                                   mixup_alpha=tc.mixup_alpha,
                                   normalize=normalize,
                                   clip_norm=tc.clip_norm,
                                   decay_2d_only=tc.decay_2d_only)

        def step_fn(params, state, inputs, targets, step, lr):
            outs = fn(params, *state, inputs, targets, step, lr,
                      tc.weight_decay)
            gnorm = outs[4] if tc.log_grad_norm else None
            return outs[0], outs[1:3], outs[3], gnorm
    return step_fn


def train(tc: TrainConfig) -> dict:
    _check_supported(tc)
    device = rank_device(tc.device)
    overrides = dict(tc.model_overrides or {})
    if tc.kv_heads:
        if "num_kv_heads" in overrides:
            raise ValueError("kv_heads and model_overrides['num_kv_heads'] "
                             "are both set: give one")
        overrides["num_kv_heads"] = tc.kv_heads
    if tc.label_smoothing:
        overrides["label_smoothing"] = tc.label_smoothing
    if tc.drop_path:
        overrides["drop_path"] = tc.drop_path
    if tc.remat is not None:
        overrides["remat"] = tc.remat
    cfg = get_config(tc.preset, dtype=tc.dtype, **overrides)
    vit = cfg.mode == "vit"
    imagenet = vit and tc.dataset == "imagenet"
    if not vit and tc.mixup_alpha > 0.0:
        raise ValueError("mixup is a vit-mode option")
    spec = MS.parse_mesh(tc.mesh) if tc.mesh else None
    if spec is not None:
        plan = MS.make_plan(cfg, spec, tc.optimizer, device, MS.TrainKnobs(
            tc.accum_steps, tc.clip_norm, tc.log_grad_norm),
            weight_decay=tc.weight_decay)
        if plan is not None:
            return _train_mesh(tc, cfg, plan, device)
        if spec.n_devices != multihost.world_size():
            raise ValueError(f"--mesh {tc.mesh} needs {spec.n_devices} "
                             f"ranks, the world has "
                             f"{multihost.world_size()}: launch with "
                             f"torchrun --nproc-per-node {spec.n_devices}")
    workdir = _shared_workdir(tc)
    mesh = dp.make_mesh(devices=[device])
    primary = mesh.rank == 0
    log = print if primary else (lambda *a, **k: None)
    kind = device_kind(device)
    n = PRM.num_parameters(cfg)

    # ---- init or resume ----------------------------------------------------
    start_step, cursor = 0, 0
    m_full = v_full = None
    latest = _latest_ckpt(workdir) if tc.resume else None
    if latest:
        np_params, _, extras = ckpt_io.load_checkpoint(latest, cfg)
        params = PRM.from_numpy(np_params, cfg, device)
        start_step, cursor = extras["step"], extras["cursor"]
        m_full, v_full = extras["m"], extras["v"]
        log(f"[resume] {latest} at step {start_step}, cursor {cursor}")
    elif tc.init_ckpt:
        np_params, _, _ = ckpt_io.load_checkpoint(tc.init_ckpt, cfg)
        params = PRM.from_numpy(np_params, cfg, device)
        log(f"[init] warm start from {tc.init_ckpt}")
    else:
        params = PRM.init_params(cfg, torch.Generator().manual_seed(tc.seed))
    # the flat arena: params are views into one fp32 vector on the device
    flat = PRM.flatten_params(params, cfg).to(device)
    params = PRM.unflatten_params(flat, cfg)

    # ---- the optimizer's state and its checkpoint, chosen once -----------
    writer = (ckpt_async_io.AsyncCheckpointer()
              if tc.async_ckpt and tc.optimizer == "adamw" and primary
              else None)
    if tc.optimizer == "adamw":
        # the rank's ZeRO-1 shards of m and v (the whole vectors at world
        # size 1)
        opt_state = (dp.init_sharded_opt_state(cfg, mesh) if m_full is None
                     else tuple(dp.shard_flat(f, cfg, mesh)
                                for f in (m_full, v_full)))

        def save_state(path, step, consumed, state):
            m, v = (dp.gather_flat(t, cfg, mesh) for t in state)
            if not primary:
                return
            if writer is not None:
                # a device-side snapshot; the write overlaps the next steps
                writer.save(path, params, cfg, m=m, v=v, step=step,
                            seed=tc.seed, cursor=consumed, n_valid=n)
            else:
                ckpt_io.save_checkpoint(path, params, cfg, m=m[:n], v=v[:n],
                                        step=step, seed=tc.seed,
                                        cursor=consumed)
    else:
        # the state rides a side tree; the data cursor rides its meta
        def side_tree(step):
            return os.path.join(workdir, f"{tc.optimizer}_{step:08d}.tree")

        if latest and os.path.exists(side_tree(start_step)):
            opt_state, meta = _load_tree_state(side_tree(start_step), params,
                                               tc.optimizer, device)
            cursor = int(meta.get("cursor", cursor))
            log(f"[resume] {tc.optimizer} state from "
                f"{side_tree(start_step)}, cursor {cursor}")
        elif tc.optimizer == "muon":
            opt_state = MU.init_state(params)
        else:
            opt_state = AF.init_state(params)

        def save_state(path, step, consumed, state):
            # flat m/v is the AdamW layout; this state rides a side tree
            if not primary:
                return
            ckpt_io.save_checkpoint(path, params, cfg, step=step,
                                    seed=tc.seed, cursor=consumed)
            CT.save_tree(side_tree(step), _tree_state_numpy(state),
                         meta={"step": step, "cursor": consumed})

    # ---- EMA: one fp32 vector beside the flat parameters ----------------
    ema = None
    if tc.ema_decay > 0.0:
        ema_path = os.path.join(workdir, f"ema_{start_step:08d}.tree")
        if latest and os.path.exists(ema_path):
            host_ema, _ = CT.load_tree(ema_path)
            ema = PRM.flatten_params(PRM.from_numpy(host_ema, cfg, device),
                                     cfg)
            log(f"[resume] EMA from {ema_path}")
        else:
            ema = EMA.init_ema(flat)

    # ---- data ---------------------------------------------------------------
    loader, norm_stats = _loader(tc, cfg, cursor)
    prefetcher = (DevicePrefetcher(loader, device, depth=tc.prefetch)
                  if tc.prefetch else None)
    step_fn = _make_step(tc, cfg, mesh, norm_stats)

    flops_per_ex = F.train_flops_per_example(cfg)
    peak = F.peak_flops(kind, cfg.dtype) if device.type == "cuda" else None
    summary = {"workdir": workdir}

    def save(step):
        # cursor = examples consumed by completed steps (not loader.cursor,
        # which runs ahead by the prefetch depth)
        consumed = cursor + (step - start_step) * tc.batch_size
        path = os.path.join(workdir, f"ckpt_{step:08d}.bin")
        save_state(path, step, consumed, opt_state)
        if ema is not None and primary:
            tree = os.path.join(workdir, f"ema_{step:08d}.tree")
            meta = {"decay": tc.ema_decay, "step": step}
            if writer is not None:
                writer.save_tree(tree, PRM.unflatten_params(ema, cfg), meta)
            else:
                CT.save_tree(tree, PRM.to_numpy(PRM.unflatten_params(ema, cfg),
                                                cfg), meta=meta)

    def next_batch():
        """(inputs, targets, host seconds the loader took for them)."""
        if prefetcher is None:
            t0 = time.perf_counter()
            inputs, targets = loader.next_batch()
            return inputs, targets, time.perf_counter() - t0
        inputs, targets = next(prefetcher)
        return inputs, targets, prefetcher.last_load_s

    stop_step = (min(tc.steps, start_step + tc.run_steps) if tc.run_steps
                 else tc.steps)
    loss = None
    try:
        with (open(os.path.join(workdir, "metrics.jsonl"), "a") if primary
              else contextlib.nullcontext()) as log_f:
            t_last, seqs_since, load_s, wait_s = time.perf_counter(), 0, 0.0, 0.0
            for step in range(start_step + 1, stop_step + 1):
                t_wait = time.perf_counter()
                inputs, targets, load = next_batch()
                wait_s += time.perf_counter() - t_wait
                load_s += load
                lr = opt.cosine_lr_host(step, tc.lr, tc.warmup, tc.steps,
                                        tc.min_lr)

                args = (params, opt_state, inputs, targets, step, lr)
                if step == tc.profile_at and primary:
                    res, summary["profile"] = profiling.trace(
                        lambda: step_fn(*args),
                        os.path.join(workdir, "profile"),
                        f"trace_step{step:08d}")
                    log("[profile] " + json.dumps(summary["profile"]))
                else:
                    res = step_fn(*args)
                params, opt_state, loss, gnorm = res
                if ema is not None:
                    EMA.update_ema(ema, flat, tc.ema_decay)
                seqs_since += tc.batch_size
                if step % tc.log_every == 0 or step == stop_step:
                    loss_val = float(loss)      # waits for the device
                    now = time.perf_counter()
                    sps = seqs_since / (now - t_last)
                    batches = seqs_since // tc.batch_size
                    rec = {"step": step, "loss": round(loss_val, 5),
                           "lr": round(float(lr), 7),
                           "imgs_per_sec": round(sps, 1),
                           "tok_per_sec": round(sps * cfg.seq_len, 1),
                           "loader_ms": round(load_s / batches * 1e3, 3),
                           "wait_ms": round(wait_s / batches * 1e3, 3),
                           "mfu": (round(sps * flops_per_ex / peak, 4)
                                   if peak else None),
                           "device": kind}
                    if imagenet:
                        rec["decoder"] = loader.decoder
                    if gnorm is not None:
                        rec["grad_norm"] = round(float(gnorm), 5)
                    if primary:
                        print("[train] " + json.dumps(rec))
                        log_f.write(json.dumps(rec) + "\n")
                        log_f.flush()
                    if not np.isfinite(loss_val):
                        raise FloatingPointError(
                            f"loss diverged at step {step}")
                    t_last, seqs_since = time.perf_counter(), 0
                    load_s = wait_s = 0.0
                if tc.ckpt_every and step % tc.ckpt_every == 0:
                    save(step)
        if stop_step > start_step:
            if not (tc.ckpt_every and stop_step % tc.ckpt_every == 0):
                save(stop_step)
            summary["final_loss"] = float(loss)
        if stop_step == tc.steps and (vit or tc.dataset) and primary:
            eval_params = (PRM.unflatten_params(ema, cfg) if ema is not None
                           else params)    # eval with the EMA weights
            if imagenet:
                summary["eval"] = evaluate_streaming(
                    cfg, eval_params, _streaming_val(tc, cfg))
            elif vit:
                eval_ds = image_dataset(tc, cfg, train=False)
                summary["eval"] = evaluate(cfg, eval_params, eval_ds,
                                           batch=min(256, len(eval_ds)))
            else:
                # val loss over the reserved holdout windows
                val = TOK.TokenLoader(loader.tokens, min(tc.batch_size, 16),
                                      cfg.max_seq_len,
                                      holdout=loader.holdout, val=True)
                summary["eval"] = {"val_loss": _loss_on(
                    cfg, eval_params, *val.next_batch(), device)}
            print("[eval] " + json.dumps(summary["eval"]))
    finally:
        if prefetcher is not None:
            prefetcher.close()
        if writer is not None:
            writer.close()      # drains the pending writes; raises theirs
    return summary


def _train_mesh(tc: TrainConfig, cfg: ViTConfig, plan,
                device: torch.device) -> dict:
    """The mesh-spec path (the JAX loop's `_train_mesh`): one train/mesh.py
    Plan behind place / init_opt / step / to_canonical.  Checkpoints are
    the canonical .bin (parameters only) plus `meshopt_{step:08d}.tree`,
    the optimizer state keyed by canonical names, so a run resumes under
    another mesh: a tree another optimizer or family wrote re-initialises
    the state, as in JAX; without a tree, AdamW takes the m and v a dp-path
    checkpoint carries.  Every rank computes the canonical tensors (a
    collective); rank 0 writes them, the metrics and the log lines."""
    if tc.mixup_alpha or (cfg.mode == "vit" and tc.dataset == "imagenet"):
        raise ValueError("mixup and the streaming imagenet loader ride the "
                         "dp path, as in the JAX loop")
    plan.validate_batch(tc.batch_size)
    workdir = _shared_workdir(tc)
    primary = multihost.is_primary()
    log = print if primary else (lambda *a, **k: None)
    mesh_name = plan.spec.describe()

    # ---- init or resume (canonical layout) ------------------------------
    start_step, cursor, opt_state = 0, 0, None
    latest = _latest_ckpt(workdir) if tc.resume else None
    if latest:
        host, _, extras = ckpt_io.load_checkpoint(latest, cfg)
        start_step, cursor = extras["step"], extras["cursor"]
        opt_path = os.path.join(workdir, f"meshopt_{start_step:08d}.tree")
        if os.path.exists(opt_path):
            tree, meta = CT.load_tree(opt_path)
            cursor = int(meta.get("cursor", cursor))
            if meta.get("optimizer", plan.optimizer) == plan.optimizer:
                try:
                    opt_state = plan.opt_load(tree)
                except (KeyError, TypeError, ValueError, RuntimeError) as e:
                    log(f"[resume] optimizer state of mesh "
                        f"{meta.get('mesh', '?')} does not fit {mesh_name} "
                        f"({type(e).__name__}: {e}); re-initialising")
        elif plan.optimizer == "adamw" and extras["m"] is not None:
            # a checkpoint of the dp path carries AdamW's flat m and v
            opt_state = plan.opt_load({
                k: PRM.to_numpy(PRM.unflatten_params(
                    torch.as_tensor(np.asarray(extras[k], np.float32)), cfg),
                    cfg) for k in ("m", "v")})
        log(f"[resume] {latest} at step {start_step}, cursor {cursor} "
            f"(mesh {mesh_name})")
    elif tc.init_ckpt:
        host, _, _ = ckpt_io.load_checkpoint(tc.init_ckpt, cfg)
        log(f"[init] warm start from {tc.init_ckpt}")
    else:
        host = PRM.to_numpy(PRM.init_params(
            cfg, torch.Generator().manual_seed(tc.seed)), cfg)
    params = plan.place(host)
    if opt_state is None:
        opt_state = plan.init_opt(params)
    ema = None
    if tc.ema_decay > 0.0:
        ema_path = os.path.join(workdir, f"ema_{start_step:08d}.tree")
        if latest and os.path.exists(ema_path):
            ema = plan.place(CT.load_tree(ema_path)[0])
        else:
            ema = {k: EMA.init_ema(t) for k, t in params.items()}

    loader, _ = _loader(tc, cfg, cursor, device_normalize=False,
                        shard=(plan.data_rank, plan.data_ways))
    if plan.seq_ways > 1:
        loader = _SeqBlock(loader, plan.seq_rank, plan.seq_ways)
    prefetcher = (DevicePrefetcher(loader, device, depth=tc.prefetch)
                  if tc.prefetch else None)
    kind = device_kind(device)
    peak = F.peak_flops(kind, cfg.dtype) if device.type == "cuda" else None
    flops_per_ex = F.train_flops_per_example(cfg)
    summary = {"workdir": workdir, "mesh": mesh_name}

    def save(step):
        consumed = cursor + (step - start_step) * tc.batch_size
        host_p, host_opt = plan.to_canonical(params), plan.opt_save(opt_state)
        host_ema = plan.to_canonical(ema) if ema is not None else None
        if not primary:
            return
        ckpt_io.save_checkpoint(os.path.join(workdir, f"ckpt_{step:08d}.bin"),
                                host_p, cfg, step=step, seed=tc.seed,
                                cursor=consumed)
        CT.save_tree(os.path.join(workdir, f"meshopt_{step:08d}.tree"),
                     host_opt, meta={"step": step, "cursor": consumed,
                                     "mesh": mesh_name,
                                     "optimizer": plan.optimizer})
        if host_ema is not None:
            CT.save_tree(os.path.join(workdir, f"ema_{step:08d}.tree"),
                         host_ema, meta={"decay": tc.ema_decay, "step": step})

    stop_step = (min(tc.steps, start_step + tc.run_steps) if tc.run_steps
                 else tc.steps)
    loss = None
    try:
        with (open(os.path.join(workdir, "metrics.jsonl"), "a") if primary
              else contextlib.nullcontext()) as log_f:
            t_last, seqs_since = time.perf_counter(), 0
            for step in range(start_step + 1, stop_step + 1):
                inputs, targets = (next(prefetcher) if prefetcher is not None
                                   else loader.next_batch())
                lr = opt.cosine_lr_host(step, tc.lr, tc.warmup, tc.steps,
                                        tc.min_lr)
                # the seventh slot: Muon's AdamW lr (on the same cosine
                # shape, as the dp path), else the weight decay
                seventh = (opt.cosine_lr_host(
                    step, tc.muon_adamw_lr, tc.warmup, tc.steps,
                    tc.min_lr * tc.muon_adamw_lr / max(tc.lr, 1e-12))
                    if plan.optimizer == "muon" else tc.weight_decay)
                out = plan.step(params, opt_state, inputs, targets, step,
                                lr, seventh)
                params, opt_state, loss = out[:3]
                gnorm = out[3] if plan.returns_gnorm else None
                if ema is not None:
                    for k, t in params.items():
                        EMA.update_ema(ema[k], t, tc.ema_decay)
                seqs_since += tc.batch_size
                if step % tc.log_every == 0 or step == stop_step:
                    loss_val = float(loss)      # waits for the device
                    sps = seqs_since / (time.perf_counter() - t_last)
                    rec = {"step": step, "loss": round(loss_val, 5),
                           "lr": round(float(lr), 7),
                           "imgs_per_sec": round(sps, 1),
                           "tok_per_sec": round(sps * cfg.seq_len, 1),
                           "mfu": (round(sps * flops_per_ex / peak, 4)
                                   if peak else None),
                           "device": kind, "mesh": mesh_name}
                    if gnorm is not None:
                        rec["grad_norm"] = round(float(gnorm), 5)
                    if primary:
                        print("[train] " + json.dumps(rec))
                        log_f.write(json.dumps(rec) + "\n")
                        log_f.flush()
                    if not np.isfinite(loss_val):
                        raise FloatingPointError(
                            f"loss diverged at step {step}")
                    t_last, seqs_since = time.perf_counter(), 0
                if tc.ckpt_every and step % tc.ckpt_every == 0:
                    save(step)
        if stop_step > start_step:
            if not (tc.ckpt_every and stop_step % tc.ckpt_every == 0):
                save(stop_step)
            summary["final_loss"] = float(loss)
        if stop_step == tc.steps and (cfg.mode == "vit" or tc.dataset):
            host_p = plan.to_canonical(ema if ema is not None else params)
            if primary:
                eval_params = PRM.from_numpy(host_p, cfg, device)
                if cfg.mode == "vit":
                    eval_ds = image_dataset(tc, cfg, train=False)
                    summary["eval"] = evaluate(cfg, eval_params, eval_ds,
                                               batch=min(256, len(eval_ds)))
                else:
                    val = TOK.TokenLoader(loader.tokens,
                                          min(tc.batch_size, 16),
                                          cfg.max_seq_len,
                                          holdout=loader.holdout, val=True)
                    summary["eval"] = {"val_loss": _loss_on(
                        cfg, eval_params, *val.next_batch(), device)}
                print("[eval] " + json.dumps(summary["eval"]))
    finally:
        if prefetcher is not None:
            prefetcher.close()
    return summary
