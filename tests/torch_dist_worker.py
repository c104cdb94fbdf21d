"""One rank of the port's multi-process CPU tests.

    python tests/torch_dist_worker.py JOB RANK WORLD DIR

Reads DIR/job.json (the config and the job's settings) and DIR/inputs.npz
(numpy parameters `p/<name>` and a global batch `x`, `y`, made by the
test), joins a gloo group through a `file://` rendezvous in DIR, runs JOB
and writes its results to DIR/out_RANK.npz.  It imports the port only (no
JAX): the test holds the results against the JAX package.
"""

import json
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

from vitrs_tpu_torch import params as PRM  # noqa: E402
from vitrs_tpu_torch.config import get_config  # noqa: E402
from vitrs_tpu_torch.parallel import multihost  # noqa: E402


def _arena(arrs, cfg):
    """Parameters as views into one flat fp32 vector (the trainer's)."""
    t = PRM.from_numpy(arrs, cfg, "cpu", torch.float32)
    return PRM.unflatten_params(PRM.flatten_params(t, cfg), cfg)


def _flat(params, cfg):
    return PRM.flatten_params(params, cfg).detach().numpy()


def job_dp(cfg, job, inp):
    """ZeRO-1 and the tree steps at world size N, one step each."""
    from vitrs_tpu_torch.ops import adafactor as AF
    from vitrs_tpu_torch.ops import muon as MU
    from vitrs_tpu_torch.parallel import data_parallel as dp
    mesh = dp.make_mesh(devices=["cpu"])
    arrs = {k[2:]: v for k, v in inp.items() if k.startswith("p/")}
    x, y = (dp.shard_batch(inp[k], mesh) for k in ("x", "y"))
    out = {"shard": np.int64(dp.opt_state_shard_size(cfg, mesh))}
    for name, kw, lr, wd in (
            ("plain", dict(return_grad_norm=True), 1e-3, 0.01),
            ("clip", dict(return_grad_norm=True, clip_norm=0.05,
                          decay_2d_only=True), 1e-3, 0.1),
            ("accum", dict(accum_steps=2), 1e-3, 0.01)):
        params = _arena(arrs, cfg)
        m, v = dp.init_sharded_opt_state(cfg, mesh)
        res = dp.make_dp_train_step(cfg, mesh, **kw)(
            params, m, v, x, y, 1, lr, wd)
        out[f"{name}/p"] = _flat(res[0], cfg)
        out[f"{name}/m"] = res[1].numpy()
        out[f"{name}/v"] = res[2].numpy()
        out[f"{name}/loss"] = res[3].numpy()
        if len(res) > 4:
            out[f"{name}/gnorm"] = res[4].numpy()
    params = _arena(arrs, cfg)
    p, _, loss = dp.make_dp_train_step_adafactor(cfg, mesh)(
        params, AF.init_state(params), x, y, 1, 0.01, 0.1)
    out["adafactor/p"], out["adafactor/loss"] = _flat(p, cfg), loss.numpy()
    params = _arena(arrs, cfg)
    p, _, loss = dp.make_dp_train_step_muon(cfg, mesh, clip_norm=1.0)(
        params, MU.init_state(params), x, y, 0, 0.02, 3e-3)
    out["muon/p"], out["muon/loss"] = _flat(p, cfg), loss.numpy()
    return out


def job_fsdp(cfg, job, inp):
    """fsdp=N or dp=M,fsdp=N: one AdamW, Adafactor and Muon step each from
    the same parameters; the canonical results, the slices' shapes and the
    global grad norm over the sharded gradients."""
    from vitrs_tpu_torch.parallel import fsdp as FS
    from vitrs_tpu_torch.parallel import gradops
    from vitrs_tpu_torch.train import mesh as MS
    spec = MS.parse_mesh(job["mesh"])
    arrs = {k[2:]: v for k, v in inp.items() if k.startswith("p/")}
    shapes = PRM.param_shapes(cfg)
    out = {}
    b = inp["x"].shape[0] // spec.n_devices
    rank = multihost.rank()
    x, y = (inp[k][rank * b:(rank + 1) * b] for k in ("x", "y"))
    for opt in ("adamw", "adafactor", "muon"):
        plan = MS.make_plan(cfg, spec, opt, "cpu", weight_decay=0.0)
        params = plan.place(arrs)
        state = plan.init_opt(params)
        if opt == "adamw":
            mesh = plan.mesh
            specs = FS.param_specs(shapes, mesh)
            out["m_numel"] = np.int64(sum(t.numel()
                                          for t in state[0].values()))
            _, _, grads = FS._loss_and_full_grads(params, specs, mesh, cfg,
                                                  x, y)
            red = {k: FS.reduce_grad(g, specs[k], mesh)
                   for k, g in grads.items()}
            out["gnorm"] = gradops.global_grad_norm(
                red, specs, mesh.fsdp_group).numpy()
            out["gnorm_whole"] = torch.sqrt(sum(
                FS.gather(g, specs[k], mesh).square().sum()
                for k, g in red.items())).numpy()
        seventh = {"adamw": 0.1, "adafactor": 0.1, "muon": 3e-3}[opt]
        step = 0 if opt == "muon" else 1
        lr = {"adamw": 1e-3, "adafactor": 0.01, "muon": 0.02}[opt]
        params, state, loss = plan.step(params, state, x, y, step, lr,
                                        seventh)
        for k, t in plan.to_canonical(params).items():
            out[f"{opt}/p/{k}"] = t
        out[f"{opt}/loss"] = loss.numpy()
    return out


def job_ckpt(cfg, job, inp):
    """save_checkpoint_sharded, each rank its byte range of one file."""
    from vitrs_tpu_torch import checkpoint_async as CA
    arrs = {k[2:]: v for k, v in inp.items() if k.startswith("p/")}
    CA.save_checkpoint_sharded(job["path"], cfg, multihost.rank(),
                               multihost.world_size(), arrs, m=inp["m"],
                               v=inp["v"], step=7, seed=3, cursor=96)
    return {}


def job_train(cfg, job, inp):
    """train/loop.train under a mesh spec."""
    from vitrs_tpu_torch.train import loop
    tc = loop.TrainConfig(**job["tc"])
    summary = loop.train(tc)
    return {"final_loss": np.float64(summary.get("final_loss", np.nan))}


def job_mesh_step(cfg, job, inp):
    """For each variant of job["variants"] (a config, a mesh spec, an
    optimizer and the knobs): the plan's mean gradient on the canonical
    layout, then one step; the loss, the grad norm, the canonical params
    after the step and how often each rank ran the encoder."""
    from vitrs_tpu_torch.models import model as M
    from vitrs_tpu_torch.train import mesh as MS
    encodes = [0]

    def counting(fn):
        def wrapped(*a, **k):
            encodes[0] += 1
            return fn(*a, **k)
        return wrapped

    M.gpt_encode, M.vit_encode = counting(M.gpt_encode), \
        counting(M.vit_encode)
    out = {}
    for var in job["variants"]:
        vcfg = get_config(var["preset"]).replace(**var["overrides"])
        ds = var["data"]
        arrs = {k[len(ds) + 3:]: v for k, v in inp.items()
                if k.startswith(f"p/{ds}/")}
        knobs = MS.TrainKnobs(**var.get("knobs", {}))
        plan = MS.make_plan(vcfg, MS.parse_mesh(var["mesh"]), var["opt"],
                            "cpu", knobs, weight_decay=var.get("muon_wd", 0))
        b = inp[f"x/{ds}"].shape[0] // plan.data_ways
        rows = slice(plan.data_rank * b, (plan.data_rank + 1) * b)
        x, y = inp[f"x/{ds}"][rows], inp[f"y/{ds}"][rows]
        if plan.seq_ways > 1:
            t = x.shape[1] // plan.seq_ways
            cols = slice(plan.seq_rank * t, (plan.seq_rank + 1) * t)
            x, y = x[:, cols], y[:, cols]
        params = plan.place(arrs)
        name = var["name"]
        if plan.grads is not None and not knobs.any:
            _, grads = plan.grads(params, x, y)
            for k, t in plan.to_canonical(grads).items():
                out[f"{name}/g/{k}"] = t
        encodes[0] = 0
        res = plan.step(params, plan.init_opt(params), x, y, var["step"],
                        var["lr"], var["seventh"])
        if var["opt"] == "muon":
            for k, t in plan.opt_save(res[1])["momentum"].items():
                out[f"{name}/mom/{k}"] = t
        if var.get("save_opt"):
            for f, tree in plan.opt_save(res[1]).items():
                for k, t in tree.items():
                    out[f"{name}/state/{f}/{k}"] = t
        out[f"{name}/encodes"] = np.int64(encodes[0])
        out[f"{name}/kind"] = np.array(plan.kind)
        out[f"{name}/loss"] = res[2].numpy()
        if plan.returns_gnorm:
            out[f"{name}/gnorm"] = res[3].numpy()
        for k, t in plan.to_canonical(res[0]).items():
            out[f"{name}/p/{k}"] = t
    return out


def job_p2p(cfg, job, inp):
    """collectives.send / recv around the ring (even ranks send first),
    then one `exchange` with both neighbours; and `mesh_groups`'s
    coordinates of a (data, model, pipe) mesh."""
    from vitrs_tpu_torch.parallel import collectives as C
    r, w = multihost.rank(), multihost.world_size()
    nxt, prv = (r + 1) % w, (r - 1) % w
    got = torch.empty(4)
    if r % 2 == 0:
        C.send(torch.arange(4.0) + r, nxt, tag=1)
        C.recv(got, prv, tag=1)
    else:
        C.recv(got, prv, tag=1)
        C.send(torch.arange(4.0) + r, nxt, tag=1)
    a, b = torch.empty(2), torch.empty(2)
    C.exchange([(torch.full((2,), 10.0 * r), nxt, 2),
                (torch.full((2,), -10.0 * r), prv, 3)],
               [(a, prv, 2), (b, nxt, 3)])
    shape = {"data": 1, "model": 2, "pipe": w // 2}
    m = C.mesh_groups(shape, "cpu")
    return {"ring": got.numpy(), "from_prev": a.numpy(),
            "from_next": b.numpy(),
            "coords": np.array([m.coords[k] for k in shape]),
            "peer": np.array([m.peer("pipe", i) for i in range(w // 2)])}


def _counting_flash_ops(calls):
    """Stand recording wrappers in for the flash ops the ring calls
    (ops/flash_attention.py, ops/flash_attention_gqa.py): each call with a
    query offset (its last argument) > 0, the rectangle of a cut hop, adds
    one to calls["fwd"] or calls["bwd"]; every call goes on to the op."""
    from vitrs_tpu_torch.ops import flash_attention as FA
    from vitrs_tpu_torch.ops import flash_attention_gqa as FG

    def counted(op, d):
        def f(*a):
            calls[d] += a[-1] > 0
            return op(*a)
        return f

    for mod, fwd, bwd in ((FA, "flash_fwd_op", "flash_bwd_op"),
                          (FG, "flash_gqa_fwd_op", "flash_gqa_bwd_op")):
        setattr(mod, fwd, counted(getattr(mod, fwd), "fwd"))
        setattr(mod, bwd, counted(getattr(mod, bwd), "bwd"))


def job_ring(cfg, job, inp):
    """parallel/ring_attention.ring_attention_local over every rank, for
    each case of job["cases"] (num_heads, causal, window; inputs q, k, v,
    do (B, T, width) of the global sequence): the rank's out and its dq,
    dk, dv, the cut hops the ring counted (`band_hops`) and the flash op
    calls it made on a rectangle at a query offset; then job_mesh_step's
    variants, if any."""
    from vitrs_tpu_torch.parallel import ring_attention as RA
    r, w = multihost.rank(), multihost.world_size()
    rect = {"fwd": 0, "bwd": 0}
    _counting_flash_ops(rect)
    out = {}
    for case in job["cases"]:
        name = case["name"]
        T = inp[f"{name}/q"].shape[1] // w
        q, k, v = (torch.tensor(inp[f"{name}/{t}"][:, r * T:(r + 1) * T],
                                requires_grad=True) for t in "qkv")
        before, before_rect = dict(RA.band_hops), dict(rect)
        o = RA.ring_attention_local(q, k, v, None, w, case["causal"],
                                    case["window"],
                                    num_heads=case["num_heads"])
        o.backward(torch.tensor(inp[f"{name}/do"][:, r * T:(r + 1) * T]))
        out[f"{name}/out"] = o.detach().numpy()
        for t, leaf in zip("qkv", (q, k, v)):
            out[f"{name}/d{t}"] = leaf.grad.numpy()
        out[f"{name}/band"] = np.array(
            [RA.band_hops[d] - before[d] for d in ("fwd", "bwd")])
        out[f"{name}/rect"] = np.array(
            [rect[d] - before_rect[d] for d in ("fwd", "bwd")])
    if job.get("variants"):
        out.update(job_mesh_step(cfg, job, inp))
    return out


def job_ep(cfg, job, inp):
    """collectives.all_to_all on the rank's block of inputs["a2a/t"]
    (split 0, concat 1), the backward of sum(out * a2a/w), and the inverse
    hop; then job_mesh_step's variants."""
    from vitrs_tpu_torch.parallel import collectives as CL
    r = multihost.rank()
    t = torch.tensor(inp["a2a/t"][r], requires_grad=True)
    y = CL.all_to_all(t, 0, 1)
    (y * torch.tensor(inp["a2a/w"][r])).sum().backward()
    back = CL.all_to_all(y.detach(), 1, 0)
    out = {"a2a/y": y.detach().numpy(), "a2a/dt": t.grad.numpy(),
           "a2a/back": back.numpy()}
    out.update(job_mesh_step(cfg, job, inp))
    return out


JOBS = {"dp": job_dp, "fsdp": job_fsdp, "ckpt": job_ckpt, "train": job_train,
        "mesh_step": job_mesh_step, "p2p": job_p2p,
        "ring": job_ring, "ep": job_ep}


def main():
    name, rank, world, d = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
        sys.argv[4]
    with open(os.path.join(d, "job.json")) as f:
        job = json.load(f)
    multihost.initialize("file://" + os.path.join(d, f"rdv_{name}"), world,
                         rank, device="cpu", timeout=120)
    cfg = get_config(job["preset"]).replace(**job.get("overrides", {}))
    inp_path = os.path.join(d, "inputs.npz")
    inp = dict(np.load(inp_path)) if os.path.exists(inp_path) else {}
    out = JOBS[name](cfg, job, inp)
    np.savez(os.path.join(d, f"out_{name}_{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
