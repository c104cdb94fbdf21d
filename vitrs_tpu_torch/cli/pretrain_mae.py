#!/usr/bin/env python
"""vitrs-pretrain-mae-torch — MAE masked-patch pretraining with the PyTorch
port, then the encoder exported in the reference-compatible checkpoint
format, so that `vitrs-train-torch --init-ckpt` fine-tunes it.

The port of `vitrs_tpu/cli/pretrain_mae.py`, with its flags, plus
--dataset-size (n of the synthetic datasets), --profile-at and --cpu.
Loop: the image loader behind the prefetcher (uint8 batches, normalised
on the device as the trainer's are), a masking draw from a seeded
generator, `mae_loss`, backward,
and AdamW over the {"encoder", "decoder"} tree (`adamw_tree`) on the
cosine schedule (`cosine_lr_host`).  Writes to --workdir (default: a fresh
temporary directory under $TMPDIR): metrics.jsonl, mae_final.tree (the
whole MAE tree, checkpoint_tree format) and encoder_final.bin.

Examples:
  vitrs-pretrain-mae-torch --preset vit-tiny-4-cifar10 --steps 1000
  vitrs-train-torch --preset vit-tiny-4-cifar10 --workdir ft \
      --init-ckpt WORKDIR/encoder_final.bin
  vitrs-pretrain-mae-torch --preset vit-tiny-4-cifar10 --cpu --steps 3 \
      --batch-size 8 --dtype float32 --dataset synthetic-shapes \
      --dataset-size 32 --log-every 1
Without --cpu it needs a CUDA device and never falls back to the CPU.
"""

import argparse
import json
import os
import tempfile
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="vit-tiny-4-cifar10")
    p.add_argument("--dataset", default="cifar10",
                   help="cifar10 | synthetic-shapes | synthetic-imagenet")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--dataset-size", type=int, default=0,
                   help="n of synthetic-shapes / synthetic-imagenet "
                        "(0: its default)")
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--lr", type=float, default=1.5e-4)
    p.add_argument("--warmup", type=int, default=50)
    p.add_argument("--weight-decay", type=float, default=0.05)
    p.add_argument("--mask-ratio", type=float, default=0.75)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--workdir", default="",
                   help="outputs (default: a fresh temporary directory)")
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--profile-at", type=int, default=0,
                   help="a Chrome trace of this step in WORKDIR/profile")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    summary = run(p.parse_args(argv))
    print("[done]", json.dumps({k: summary[k] for k in
                                ("workdir", "encoder", "final_loss")}))
    return summary


def run(args) -> dict:
    import numpy as np
    import torch

    from vitrs_tpu_torch import checkpoint as C
    from vitrs_tpu_torch import checkpoint_tree as CT
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.data import datasets as D
    from vitrs_tpu_torch.data.prefetch import DevicePrefetcher
    from vitrs_tpu_torch.models import mae as MAE
    from vitrs_tpu_torch.ops import optimizer as opt
    from vitrs_tpu_torch.ops._build import resolve_device
    from vitrs_tpu_torch.parallel.data_parallel import normalize_images
    from vitrs_tpu_torch.utils import profiling

    device = resolve_device("cpu" if args.cpu else "cuda")
    workdir = args.workdir or tempfile.mkdtemp(prefix="vitrs_torch_mae_")
    os.makedirs(workdir, exist_ok=True)
    print(f"[workdir] {workdir}")
    cfg = get_config(args.preset, dtype=args.dtype)
    # drawn on the CPU, so that every device starts from the same numbers
    gen = torch.Generator().manual_seed(args.seed)
    params = {part: {k: t.to(device) for k, t in tree.items()}
              for part, tree in MAE.init_mae_params(cfg, gen).items()}

    def zeros():
        return {part: {k: torch.zeros_like(t) for k, t in tree.items()}
                for part, tree in params.items()}

    m, v = zeros(), zeros()
    kw = {"n": args.dataset_size} if args.dataset_size else {}
    if args.dataset == "synthetic-imagenet":
        kw.update(img_size=cfg.img_size, num_classes=cfg.num_classes)
    ds = D.get_dataset(args.dataset, args.data_dir, train=True, **kw)
    loader = D.DataLoader(ds, args.batch_size, seed=args.seed, train=True,
                          device_normalize=True)
    prefetch = DevicePrefetcher(loader, device)

    def step_fn(x, step, lr):
        nonlocal params, m, v
        x = normalize_images(x, ds.mean, ds.std)
        noise = MAE.draw_noise(gen, x.shape[0], cfg.num_patches, device)
        leaves = {part: {k: t.detach().requires_grad_(True)
                         for k, t in tree.items()}
                  for part, tree in params.items()}
        loss = MAE.mae_loss(leaves, x, cfg, noise, args.mask_ratio)
        flat = [t for tree in leaves.values() for t in tree.values()]
        # a tensor the loss does not read (wte, the classifier head) gets
        # exact zeros, as under jax.grad
        grads = iter(torch.autograd.grad(loss, flat, allow_unused=True))
        g = {part: {k: torch.zeros_like(t) if (d := next(grads)) is None
                    else d for k, t in tree.items()}
             for part, tree in leaves.items()}
        params, m, v = opt.adamw_tree(params, g, m, v, step, lr,
                                      weight_decay=args.weight_decay)
        return loss.detach()

    summary = {"workdir": workdir, "losses": []}
    t_last, since = time.perf_counter(), 0
    try:
        with open(os.path.join(workdir, "metrics.jsonl"), "w") as log_f:
            for step in range(1, args.steps + 1):
                x, _ = next(prefetch)
                lr = opt.cosine_lr_host(step, args.lr, args.warmup,
                                        args.steps)
                if step == args.profile_at:
                    loss, summary["profile"] = profiling.trace(
                        lambda: step_fn(x, step, lr),
                        os.path.join(workdir, "profile"),
                        f"trace_step{step:08d}")
                else:
                    loss = step_fn(x, step, lr)
                since += args.batch_size
                if step % args.log_every == 0 or step == args.steps:
                    lv = float(loss)          # waits for the device
                    now = time.perf_counter()
                    rec = {"step": step, "mae_loss": round(lv, 5),
                           "imgs_per_sec": round(since / (now - t_last), 1)}
                    print("[mae] " + json.dumps(rec))
                    log_f.write(json.dumps(rec) + "\n")
                    log_f.flush()
                    summary["losses"].append(lv)
                    if not np.isfinite(lv):
                        raise FloatingPointError(f"loss diverged at {step}")
                    t_last, since = time.perf_counter(), 0
    finally:
        prefetch.close()

    # the whole MAE tree (encoder + decoder)
    CT.save_tree(os.path.join(workdir, "mae_final.tree"),
                 P.to_numpy(params, cfg),
                 meta={"mask_ratio": args.mask_ratio, "steps": args.steps})
    # the encoder alone, in the reference-compatible format
    enc_path = os.path.join(workdir, "encoder_final.bin")
    C.save_checkpoint(enc_path, params["encoder"], cfg, step=args.steps,
                      seed=args.seed)
    print(f"[done] encoder -> {enc_path}")
    summary.update(encoder=enc_path, params=params,
                   final_loss=summary["losses"][-1] if summary["losses"]
                   else None)
    return summary


if __name__ == "__main__":
    main()
