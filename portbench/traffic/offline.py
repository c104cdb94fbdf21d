"""Offline classification cells: batches of uint8 images made on the
device from (seed, batch), normalised and classified by
`models/model.vit_forward` under `inference_mode` on weights prepared once
(`models/model.prepare_params`), as `cli/infer.py` runs it.

Set-up makes the weights, prepares them and runs one batch.  The window
then classifies batch after batch; the rate is every image of every batch
it launched over the time until the last one ended.  Every batch's logits
stay on the device; after the window a sample of `check_batches` batches
drawn from the seed is held to `reference/model.Ref.vit_logits` on the
same images (`reference/compare.py`'s logit_over and row_over).

params: batch, mean, std, check_batches, ref_block.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import weights as W
from ..reference import compare
from ..reference.model import Ref, fp32_exact, to_device
from . import common as CM


def program_forward(cfg, weights, mean, std):
    """The timed call: uint8 images -> fp32 logits."""
    from vitrs_tpu_torch.models import model as M
    from vitrs_tpu_torch.parallel import data_parallel as dp
    pp = M.prepare_params(weights, cfg)

    def forward(images):
        with torch.inference_mode():
            return M.vit_forward(pp, dp.normalize_images(images, mean, std),
                                 cfg)
    return forward


def run(ctx) -> CM.Outcome:
    s, cfg, p, dev = ctx.shape, ctx.cfg, ctx.params, ctx.device
    mean = np.asarray(p["mean"], np.float32)
    std = np.asarray(p["std"], np.float32)
    ctx.mark("start")
    w = W.make_weights(s, ctx.seed, dev)
    w_host = {k: t.to("cpu", copy=True) for k, t in w.items()}
    forward = program_forward(cfg, w, mean, std)
    B = p["batch"]
    ctx.mark("weights_prepared")
    forward(W.images(s, B, ctx.seed, 0, dev)[0])
    CM.sync(dev)
    ctx.mark("warmed")
    setup_s = CM.now() - ctx.t_start

    tr, pacer = ctx.tracer, CM.Pacer(dev)
    kept = []
    with tr.window():
        t0 = CM.now()
        while CM.now() - t0 < ctx.seconds:
            with tr.span("make_batch"):
                x = W.images(s, B, ctx.seed, len(kept) + 1, dev)[0]
            with tr.span("step"):
                kept.append(forward(x))
            pacer.launched()
        CM.sync(dev)
        window_s = CM.now() - t0
    done = len(kept)
    peak = CM.peak_bytes(dev)
    rng = np.random.default_rng([int(ctx.seed), 0xC4EC])
    picked = CM.sample(rng, list(range(1, done + 1)), p["check_batches"])
    prog_logits = [kept[i - 1].float().cpu() for i in picked]
    del forward, kept, w, x
    CM.free(dev)

    fp32_exact()
    ref = Ref(s, "fp32")
    refw = to_device(w_host, dev)
    n_off, n_all, row_over = 0, 0, 0.0
    t_ref = CM.now()
    with torch.no_grad():
        for i, got in zip(picked, prog_logits):
            x = W.images(s, B, ctx.seed, i, dev)[0]
            want = torch.cat([ref.vit_logits(refw, x[lo:lo + p["ref_block"]],
                                             mean, std)
                              for lo in range(0, B, p["ref_block"])]).cpu()
            bad = compare.off(got, want)
            n_off, n_all = n_off + int(bad.sum()), n_all + bad.numel()
            row_over = max(row_over,
                           100.0 * float(bad.double().mean(dim=-1).max()))
    return CM.Outcome(
        e2e={"infer_img_s": done * B / window_s}, setup_s=setup_s,
        attempted=done, failed=0,
        numbers={"logit_over": 100.0 * n_off / n_all if n_all
                 else float("nan"),
                 "row_over": row_over if n_all else float("nan")},
        work={"batches": done, "batch": B}, memory_peak_bytes=peak,
        notes={"window_s": window_s, "batches": done,
               "checked_batches": picked,
               "reference_s": CM.now() - t_ref})
