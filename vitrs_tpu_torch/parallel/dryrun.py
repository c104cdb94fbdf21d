"""A multi-rank dry run: the counterpart of `__graft_entry__.dryrun_multichip`.

`dryrun_multichip(n)` starts n CPU ranks over gloo (`spawn`, a `file://`
rendezvous in a temporary directory), and each builds the ZeRO-1 step on
tiny vit shapes and runs one step of it: batch split over the ranks,
reduce-scatter of the flat gradient, AdamW over the rank's shard of m and
v, all-gather of the parameters.  Then, on tiny gpt shapes, one step of
each mesh plan that n ranks hold (train/mesh.py): at n = 2, tp=2,sp and
pp=2 under 1F1B; at n = 4, dp=2,tp=2,sp,vp, dp=2,pp=2 interleaved and
tp=2,pp=2.  It checks that every loss is finite and the same on every
rank, and returns the ZeRO-1 one.

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
    for spec in MESH_SPECS.get(n, ()):
        plan = MS.make_plan(gcfg, MS.parse_mesh(spec), "adamw", "cpu")
        b = 8 // plan.data_ways
        rows = slice(plan.data_rank * b, (plan.data_rank + 1) * b)
        placed = plan.place(host)
        _, _, mloss = plan.step(placed, plan.init_opt(placed), x[rows],
                                np.roll(x, -1, 1)[rows], 1, 1e-3, 0.0)
        mesh_losses.append(float(mloss))
    out.put((rank, float(loss), m.shape[0], tuple(mesh_losses)))
    torch.distributed.destroy_process_group()


# the mesh plans a dry run of n ranks steps once each, after ZeRO-1
MESH_SPECS = {2: ("tp=2,sp", "pp=2,schedule=1f1b,mb=4"),
              4: ("dp=2,tp=2,sp,vp", "dp=2,pp=2,schedule=1f1b-interleaved,v=2",
                  "tp=2,pp=2")}


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
    losses = {(loss, mesh) for _, loss, _, mesh in got}
    if len(losses) != 1 or not all(np.isfinite(
            [v for pair in losses for v in (pair[0],) + pair[1]])):
        raise RuntimeError(f"dryrun_multichip: ranks disagree or diverged: "
                           f"{sorted(got)}")
    loss, mesh = losses.pop()
    print(f"dryrun_multichip({n_devices}): dp ok, loss={loss:.4f}, "
          f"m/v shard {got[0][2]} values a rank; "
          + ", ".join(f"{s} loss={v:.4f}"
                      for s, v in zip(MESH_SPECS.get(n_devices, ()), mesh)))
    return loss


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
