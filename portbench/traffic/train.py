"""Training cells: the port's data-parallel step on one device
(`parallel/data_parallel.make_dp_train_step`, as `train/loop._make_step`
builds it for AdamW), fed a fresh batch each step, made on the device from
(seed, step): gpt token rows, or vit uint8 images and labels that the
step normalises.

Set-up builds the one step object with its weights (`weights.py`) and its
AdamW state, and drives it through `checked_steps` steps on their own
batches; those steps are the warm-up too.  The program's readings are
taken then: each step's loss, the first gradient as AdamW got it (its m
after one step over 1 - beta1), and the weights' change after the last
checked step.  The window then runs the same object on: the rate is every
example of every step it launched over the time until the last one ended.
After the window the program is freed and `reference/train.follow` runs
the same steps from the same weights over the same batches.

params: batch, lr, weight_decay, clip_norm, beta1, beta2, eps,
checked_steps, ref_block (the reference's rows a block), and for vit the
normalisation (mean, std) the step applies.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import weights as W
from ..reference import compare, layout
from ..reference import train as RT
from ..reference.model import Ref, fp32_exact, to_device
from . import common as CM


def program_step(cfg, mesh, p: dict, normalize):
    from vitrs_tpu_torch.parallel import data_parallel as dp
    return dp.make_dp_train_step(cfg, mesh, normalize=normalize,
                                 clip_norm=p["clip_norm"],
                                 decay_2d_only=True)


def _batch(ctx, i: int):
    s, p = ctx.shape, ctx.params
    if s.mode == "vit":
        return W.images(s, p["batch"], ctx.seed, i, ctx.device)
    return W.tokens(s, p["batch"], s.max_seq_len, ctx.seed, i, ctx.device)


def _norms_by_name(flat: torch.Tensor, cfg, s, scale: float = 1.0):
    from vitrs_tpu_torch import params as PRM
    n = PRM.num_parameters(cfg)
    views = PRM.unflatten_params(flat[:n], cfg)
    return RT.leaf_norms({k: views[k] * scale for k in layout.order(s)}, s)


def run(ctx) -> CM.Outcome:
    from vitrs_tpu_torch import params as PRM
    from vitrs_tpu_torch.parallel import data_parallel as dp
    s, cfg, p, dev = ctx.shape, ctx.cfg, ctx.params, ctx.device
    normalize = ((np.asarray(p["mean"], np.float32),
                  np.asarray(p["std"], np.float32))
                 if s.mode == "vit" else None)
    ctx.mark("program_imported")
    w = W.make_weights(s, ctx.seed, dev)
    w0_host = {k: t.to("cpu", copy=True) for k, t in w.items()}
    flat = PRM.flatten_params(w, cfg)
    del w
    params = PRM.unflatten_params(flat, cfg)
    mesh = dp.make_mesh(devices=[dev])
    m, v = dp.init_sharded_opt_state(cfg, mesh)
    step = program_step(cfg, mesh, p, normalize)
    ctx.mark("weights_and_state")
    lr, wd = p["lr"], p["weight_decay"]

    prog = {"losses": []}
    K = p["checked_steps"]
    for t in range(1, K + 1):
        x, y = _batch(ctx, t)
        params, m, v, loss = step(params, m, v, x, y, t, lr, wd)
        prog["losses"].append(float(loss))
        if t == 1:
            inv = 1.0 / (1.0 - p["beta1"])
            prog["grad_norms"] = _norms_by_name(m, cfg, s, inv)
            views = PRM.unflatten_params(m[:PRM.num_parameters(cfg)], cfg)
            prog["first_grads"] = {k: (views[k] * inv).cpu()
                                   for k in layout.order(s)}
    change = {}
    for k in layout.order(s):
        change[k] = params[k].detach() - w0_host[k].to(dev)
    prog["change_norms"] = RT.leaf_norms(change, s)
    del change
    CM.sync(dev)
    setup_s = CM.now() - ctx.t_start

    tr, pacer = ctx.tracer, CM.Pacer(dev)
    done, i = 0, K
    with tr.window():
        t0 = CM.now()
        while CM.now() - t0 < ctx.seconds:
            i += 1
            with tr.span("make_batch"):
                x, y = _batch(ctx, i)
            with tr.span("step"):
                params, m, v, loss = step(params, m, v, x, y, i, lr, wd)
            pacer.launched()
            done += 1
        CM.sync(dev)
        window_s = CM.now() - t0
    last_loss = float(loss) if done else float("nan")
    peak = CM.peak_bytes(dev)
    n_params = PRM.num_parameters(cfg)
    del params, m, v, flat, step, loss, x, y
    CM.free(dev)

    fp32_exact()
    ref = Ref(s, "fp32")
    refw = to_device(w0_host, dev)
    batches = [_batch(ctx, t) for t in range(1, K + 1)]
    hp = dict(lr=lr, weight_decay=wd, clip_norm=p["clip_norm"],
              beta1=p["beta1"], beta2=p["beta2"], eps=p["eps"])
    t_ref = CM.now()
    ref_out = RT.follow(ref, refw, batches, hp, p["ref_block"],
                        vit_norm=normalize)
    numbers = compare.train_numbers(prog, ref_out, s)
    per_step = p["batch"] * (1 if s.mode == "vit" else s.max_seq_len)
    rate = done * per_step / window_s
    name = "train_img_s" if s.mode == "vit" else "train_tok_s"
    return CM.Outcome(
        e2e={name: rate}, setup_s=setup_s, attempted=done, failed=0,
        numbers=numbers,
        work={"steps": done, "batch": p["batch"], "params": n_params},
        memory_peak_bytes=peak,
        notes={"window_s": window_s, "steps": done,
               "last_loss": last_loss,
               "program_losses": prog["losses"],
               "reference_losses": ref_out["losses"],
               "reference_s": CM.now() - t_ref})
