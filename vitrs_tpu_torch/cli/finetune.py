#!/usr/bin/env python
"""vitrs-finetune-torch — LoRA finetuning of a GPT checkpoint with the
PyTorch port: rank-r adapters (models/lora.py) on a token stream, the base
weights frozen, AdamW state for the adapters only; the output is the
adapter tree, and with --merge also a standalone merged checkpoint.

The port of `vitrs_tpu/cli/finetune.py`, with its flags, plus --dtype (the
compute dtype; default the checkpoint's).  The token stream is an llm.c
uint16 token file (--data-dir), else the synthetic stream.  The adapters
go to --out (default: lora_adapters.tree in a fresh temporary directory
under $TMPDIR), in the checkpoint_tree format both packages read; --resume
continues from such a tree.  Then the held-out val loss of the merged
weights (`evaluate_gpt`).

Examples:
  vitrs-finetune-torch --ckpt gpt2-124m.bin --data-dir ids.bin \
      --steps 500 --rank 8 --out adapters.tree --dtype bfloat16
  vitrs-finetune-torch --ckpt base.bin --data-dir ids.bin --merge merged.bin
  vitrs-finetune-torch --ckpt base.bin --cpu --steps 3 --batch-size 2
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
    p.add_argument("--ckpt", required=True, help="base gpt checkpoint (.bin)")
    p.add_argument("--data-dir", default=None,
                   help="uint16 token file (tokens dataset); default: "
                        "synthetic stream")
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup", type=int, default=50)
    p.add_argument("--rank", type=int, default=8)
    p.add_argument("--alpha", type=float, default=16.0)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                   help="compute dtype (default: the checkpoint's)")
    p.add_argument("--out", default="",
                   help="adapter tree output path (default: "
                        "lora_adapters.tree in a fresh temporary directory)")
    p.add_argument("--resume", default=None,
                   help="adapter tree to continue training from")
    p.add_argument("--merge", default=None, metavar="MERGED_BIN",
                   help="also bake adapters into a standalone checkpoint")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    return run(p.parse_args(argv))


def run(args) -> dict:
    import numpy as np
    import torch

    from vitrs_tpu_torch import checkpoint as C
    from vitrs_tpu_torch import checkpoint_tree as CT
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.data import tokens as TOK
    from vitrs_tpu_torch.models import lora as LO
    from vitrs_tpu_torch.ops import optimizer as opt
    from vitrs_tpu_torch.ops._build import resolve_device
    from vitrs_tpu_torch.train.loop import evaluate_gpt

    device = resolve_device("cpu" if args.cpu else "cuda")
    np_params, cfg, _ = C.load_checkpoint(args.ckpt)
    if cfg.mode != "gpt":
        raise SystemExit("vitrs-finetune-torch targets gpt checkpoints")
    if args.dtype:
        cfg = cfg.replace(dtype=args.dtype)
    params = P.from_numpy(np_params, cfg, device)    # frozen: no grad
    print(f"base: {args.ckpt} ({cfg.num_layers}L/{cfg.channels}C, "
          f"vocab {cfg.vocab_size})")
    out = args.out or os.path.join(
        tempfile.mkdtemp(prefix="vitrs_torch_lora_"), "lora_adapters.tree")

    if args.resume and os.path.exists(args.resume):
        host, meta = CT.load_tree(args.resume)
        lora = P.from_numpy(host, cfg, device)
        print(f"[resume] adapters from {args.resume} (rank {meta['rank']})")
    else:
        # drawn on the CPU, so that every device starts from the same numbers
        lora = {k: t.to(device) for k, t in LO.init_lora(
            cfg, torch.Generator().manual_seed(args.seed),
            rank=args.rank).items()}
    m, v = LO.init_lora_opt(lora)
    n_adapter = sum(t.numel() for t in lora.values())
    n_base = sum(t.numel() for t in params.values())
    print(f"adapters: {n_adapter:,} trainable params "
          f"({100.0 * n_adapter / n_base:.2f}% of base)")

    stream = TOK.get_tokens(args.data_dir, cfg.vocab_size, seed=args.seed)
    total_w = (len(stream) - 1) // cfg.max_seq_len
    loader = TOK.TokenLoader(stream, args.batch_size, cfg.max_seq_len,
                             holdout=TOK.default_holdout(total_w))

    summary = {"out": out, "adapter_params": n_adapter, "losses": [],
               "log": []}
    t0 = t_last = time.time()
    for s in range(args.steps):
        lr = opt.cosine_lr_host(s, args.lr, args.warmup, args.steps)
        xb, yb = loader.next_batch()
        loss, lora, m, v = LO.lora_train_step(
            lora, m, v, s, params,
            torch.as_tensor(xb, dtype=torch.long, device=device),
            torch.as_tensor(yb, dtype=torch.long, device=device), cfg,
            lr=float(lr), alpha=args.alpha, weight_decay=args.weight_decay)
        if s % args.log_every == 0 or s == args.steps - 1:
            lv = float(loss)              # waits for the device
            now = time.time()
            rec = {"step": s, "loss": round(lv, 5), "lr": round(float(lr), 7),
                   "wall_s": round(now - t_last, 4)}
            print(json.dumps(rec))
            summary["losses"].append(lv)
            summary["log"].append(rec)
            if not np.isfinite(lv):
                raise FloatingPointError(f"loss diverged at step {s}")
            t_last = now

    CT.save_tree(out, P.to_numpy(lora, cfg),
                 meta={"rank": LO.lora_rank(lora), "alpha": args.alpha,
                       "base": os.path.basename(args.ckpt),
                       "steps": args.steps})
    print(f"[saved] adapters -> {out} "
          f"({os.path.getsize(out) / 1e6:.2f} MB vs base "
          f"{os.path.getsize(args.ckpt) / 1e6:.1f} MB)")

    merged = LO.merge_lora(params, lora, alpha=args.alpha)
    res = evaluate_gpt(cfg, merged, args.data_dir, seed=args.seed)
    summary.update(val_loss=res["val_loss"], ppl=res["ppl"],
                   wall_s=time.time() - t0, lora=lora, base=params)
    print(json.dumps({"val_loss": round(res["val_loss"], 4),
                      "val_ppl": round(res["ppl"], 2),
                      "wall_s": round(summary["wall_s"], 1)}))
    if args.merge:
        C.save_checkpoint(args.merge, merged, cfg)
        print(f"[saved] merged checkpoint -> {args.merge}")
    return summary


if __name__ == "__main__":
    main()
