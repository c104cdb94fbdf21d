"""A multi-rank dry run: the counterpart of `__graft_entry__.dryrun_multichip`.

`dryrun_multichip(n)` starts n CPU ranks over gloo (`spawn`, a `file://`
rendezvous in a temporary directory), and each builds the ZeRO-1 step on
tiny vit shapes and runs one step of it: batch split over the ranks,
reduce-scatter of the flat gradient, AdamW over the rank's shard of m and
v, all-gather of the parameters.  Then, on tiny gpt shapes, one step of
each mesh plan that n ranks hold (train/mesh.py, MESH_SPECS): at n = 2,
tp=2,sp, pp=2 under 1F1B, cp=2 dense and banded (window 6), cp=2 with
Adafactor and ep=2 (4 experts, top-2); at n = 4, dp=2,tp=2,sp,vp,
dp=2,pp=2 interleaved, tp=2,pp=2, dp=2,cp=2 dense and banded, dp=2,ep=2,
ep=2,tp=2 with AdamW and with Adafactor, and dp=2,cp=2 with Adafactor.
Last, the bare ring (parallel/ring_attention.ring_attention_local, causal,
T = 16n over every rank) against dense attention on the gathered
sequence.  It checks that every loss is finite and the same on every rank
and that the ring matches, and returns the ZeRO-1 loss.

    python -m vitrs_tpu_torch.parallel.dryrun 4
"""

from __future__ import annotations

import multiprocessing as mp
import os
import sys
import tempfile

import numpy as np


def _rank(rank: int, n: int, rdv: str, out) -> None:
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from .. import params as PRM
    from ..config import get_config
    from . import data_parallel as dp
    from . import multihost
    multihost.initialize(f"file://{rdv}", n, rank, device="cpu", timeout=120)
    cfg = get_config("vit-b-16").replace(
        num_layers=2, channels=128, num_heads=2, img_size=32, patch_size=16,
        max_seq_len=8, dtype="float32")
    mesh = dp.make_mesh(devices=["cpu"])
    init = PRM.init_params(cfg, torch.Generator().manual_seed(0))
    params = PRM.unflatten_params(PRM.flatten_params(
        dp.replicate(init, mesh), cfg), cfg)
    m, v = dp.init_sharded_opt_state(cfg, mesh)
    rng = np.random.default_rng(0)
    B = 2 * n
    images = rng.standard_normal((B, 32, 32, 3), dtype=np.float32)
    labels = rng.integers(0, cfg.num_classes, (B,))
    params, m, v, loss = dp.make_dp_train_step(cfg, mesh)(
        params, m, v, dp.shard_batch(images, mesh),
        dp.shard_batch(labels, mesh), 1, 1e-3, 0.0)
    mesh_losses = []
    from ..train import mesh as MS
    gcfg = get_config("gpt-nano").replace(num_layers=4, dtype="float32")
    host = PRM.to_numpy(PRM.init_params(gcfg, torch.Generator().manual_seed(0)),
                        gcfg)
    x = rng.integers(0, gcfg.vocab_size, (8, gcfg.max_seq_len))
    y = np.roll(x, -1, 1)
    for spec, optimizer, variant in MESH_SPECS.get(n, ()):
        vcfg = gcfg.replace(**VARIANTS[variant])
        vhost = host if not VARIANTS[variant] else PRM.to_numpy(
            PRM.init_params(vcfg, torch.Generator().manual_seed(0)), vcfg)
        plan = MS.make_plan(vcfg, MS.parse_mesh(spec), optimizer, "cpu")
        b = 8 // plan.data_ways
        rows = slice(plan.data_rank * b, (plan.data_rank + 1) * b)
        t = x.shape[1] // plan.seq_ways
        cols = slice(plan.seq_rank * t, (plan.seq_rank + 1) * t)
        placed = plan.place(vhost)
        _, _, mloss = plan.step(placed, plan.init_opt(placed),
                                x[rows][:, cols], y[rows][:, cols], 1,
                                1e-2 if optimizer == "adafactor" else 1e-3,
                                0.0)
        mesh_losses.append(float(mloss))
    out.put((rank, float(loss), m.shape[0], tuple(mesh_losses),
             _ring_error(rank, n)))
    torch.distributed.destroy_process_group()


def _ring_error(rank: int, n: int) -> float:
    """The bare ring over every rank (B=1, 2 heads of 64, T = 16n, causal)
    against dense attention on the whole sequence: the rank's largest
    error."""
    import torch
    from ..ops import basic
    from .ring_attention import ring_attention_local
    g = torch.Generator().manual_seed(1)
    qkv = torch.randn(1, 16 * n, 3 * 128, generator=g)
    want = basic.attention_dense(qkv, 2, causal=True)[0]
    q, k, v = qkv[:, 16 * rank:16 * (rank + 1)].split(128, dim=-1)
    got = ring_attention_local(q, k, v, None, n, True, num_heads=2)
    return float((got - want[:, 16 * rank:16 * (rank + 1)]).abs().max())


# the model variants of the plans' steps: dense, banded (rope + window 6,
# the ring stops early), MoE (4 experts, top-2)
VARIANTS = {"dense": {}, "banded": dict(pos_emb="rope", window=6),
            "moe": dict(num_experts=4, moe_top_k=2)}
# the mesh plans a dry run of n ranks steps once each, after ZeRO-1:
# (spec, optimizer, variant)
MESH_SPECS = {
    2: (("tp=2,sp", "adamw", "dense"),
        ("pp=2,schedule=1f1b,mb=4", "adamw", "dense"),
        ("cp=2", "adamw", "dense"), ("cp=2", "adamw", "banded"),
        ("cp=2", "adafactor", "dense"), ("ep=2", "adamw", "moe")),
    4: (("dp=2,tp=2,sp,vp", "adamw", "dense"),
        ("dp=2,pp=2,schedule=1f1b-interleaved,v=2", "adamw", "dense"),
        ("tp=2,pp=2", "adamw", "dense"),
        ("dp=2,cp=2", "adamw", "dense"), ("dp=2,cp=2", "adamw", "banded"),
        ("dp=2,ep=2", "adamw", "moe"), ("ep=2,tp=2", "adamw", "moe"),
        ("ep=2,tp=2", "adafactor", "moe"),
        ("dp=2,cp=2", "adafactor", "dense"))}


def dryrun_multichip(n_devices: int) -> float:
    """One ZeRO-1 step over n_devices gloo CPU ranks; returns the loss."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        rdv = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank, args=(r, n_devices, rdv, out))
                 for r in range(n_devices)]
        for p in procs:
            p.start()
        got = [out.get(timeout=300) for _ in procs]   # drain, then join
        for p in procs:
            p.join(timeout=60)
    if any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"dryrun_multichip: exit codes "
                           f"{[p.exitcode for p in procs]}")
    losses = {(loss, mesh) for _, loss, _, mesh, _ in got}
    if len(losses) != 1 or not all(np.isfinite(
            [v for pair in losses for v in (pair[0],) + pair[1]])):
        raise RuntimeError(f"dryrun_multichip: ranks disagree or diverged: "
                           f"{sorted(got)}")
    ring_err = max(r[4] for r in got)
    if not ring_err < 1e-5:
        raise RuntimeError(f"dryrun_multichip: the ring is off dense "
                           f"attention by {ring_err}")
    loss, mesh = losses.pop()
    print(f"dryrun_multichip({n_devices}): dp ok, loss={loss:.4f}, "
          f"m/v shard {got[0][2]} values a rank; "
          + ", ".join(f"{s} {o} {v} loss={x:.4f}" for (s, o, v), x in
                      zip(MESH_SPECS.get(n_devices, ()), mesh))
          + f"; ring attention ok (max err {ring_err:.2e})")
    return loss


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
