#!/usr/bin/env python
"""vitrs-train-torch — train a GPT or ViT preset with the PyTorch port.

The port of `vitrs_tpu/cli/train.py`: gpt and vit mode, dense or MoE
(--num-experts, --moe-top-k), with AdamW, Adafactor or Muon (--optimizer)
on one device, with the JAX CLI's flags: selective or full remat
(--remat), a profiler trace (--profile-at), EMA weights (--ema-decay),
streaming ImageNet shards with RandAugment (--dataset imagenet --data-dir,
--ra-ops, --ra-mag), on one device or as ranks under torchrun: --mesh
dp=N (ZeRO-1), fsdp=N, dp=M,fsdp=N (hybrid FSDP), tp=N[,dp=M][,sp][,vp]
(tensor, sequence and vocab parallelism), pp=N[,dp=M][,schedule=gpipe|1f1b|
1f1b-interleaved][,v=V][,mb=M] (pipelines), tp=N,pp=K[,dp=M][,sp][,vp]
(3-D), ep=N[,dp=M][,tp=K[,vp]] (expert parallelism for MoE configs, and
EP x TP) and cp=N[,dp=M] (context parallelism: ring attention, banded under
--window).

Examples:
  vitrs-train-torch --preset vit-b-16 --dataset synthetic-imagenet \
      --batch-size 64 --steps 100
  vitrs-train-torch --preset vit-tiny-4-cifar10 --cpu --steps 3 \
      --batch-size 8 --dtype float32 --label-smoothing 0.1 --mixup-alpha 0.2
  vitrs-train-torch --preset gpt2-124m --steps 1000 --batch-size 8 --workdir run1
  vitrs-train-torch --preset gpt-nano --cpu --steps 3 --batch-size 4
  vitrs-train-torch --preset gpt2-124m --kv-heads 4 --steps 100 --batch-size 8
  vitrs-train-torch --preset gpt2-124m --pos-emb rope --window 256 --steps 100
  vitrs-train-torch --preset gpt2-124m --eval-only --workdir run1
  vitrs-train-torch --preset gpt2-moe-8e --optimizer adafactor --lr 1e-2 \
      --batch-size 24 --steps 100
  vitrs-train-torch --preset gpt-nano --num-experts 4 --optimizer adafactor \
      --lr 1e-2 --cpu --steps 3 --batch-size 4 --dtype float32
  vitrs-train-torch --preset gpt-nano --optimizer muon --lr 0.02 --cpu \
      --steps 3 --batch-size 4
  vitrs-train-torch --preset gpt2-124m-4k --batch-size 4 --steps 100  # remat
  vitrs-train-torch --preset gpt-nano --remat full --cpu --steps 3
  vitrs-train-torch --preset vit-b-16 --dataset imagenet --data-dir SHARDS \
      --ra-ops 2 --ra-mag 0.5 --ema-decay 0.9999 --batch-size 64
  # one rank a card, NCCL (gloo with --cpu); the batch is global
  torchrun --nproc-per-node 2 -m vitrs_tpu_torch.cli.train \
      --preset gpt2-124m --mesh dp=2 --batch-size 16 --steps 100
  torchrun --nproc-per-node 4 -m vitrs_tpu_torch.cli.train \
      --preset gpt2-124m --mesh dp=2,fsdp=2 --batch-size 16 --steps 100
  torchrun --nproc-per-node 2 -m vitrs_tpu_torch.cli.train \
      --preset gpt-nano --mesh fsdp=2 --cpu --steps 3 --batch-size 4
  torchrun --nproc-per-node 2 -m vitrs_tpu_torch.cli.train \
      --preset gpt2-124m --mesh tp=2 --batch-size 8 --steps 100
  torchrun --nproc-per-node 2 -m vitrs_tpu_torch.cli.train \
      --preset gpt2-124m --mesh pp=2,schedule=1f1b,mb=4 --batch-size 8
  torchrun --nproc-per-node 4 -m vitrs_tpu_torch.cli.train \
      --preset gpt2-124m --mesh tp=2,pp=2 --batch-size 8 --clip-norm 1.0
  torchrun --nproc-per-node 2 -m vitrs_tpu_torch.cli.train \
      --preset gpt2-124m-4k --mesh cp=2 --batch-size 4 --steps 100
  torchrun --nproc-per-node 4 -m vitrs_tpu_torch.cli.train \
      --preset gpt2-moe-8e --mesh ep=2,tp=2 --optimizer adafactor --lr 1e-2 \
      --batch-size 8 --steps 100

Checkpoints and metrics go to --workdir, and a run resumes from the latest
checkpoint there; without --workdir a run writes to a fresh temporary
directory (under $TMPDIR) and resumes nothing.  Without --cpu it needs a
CUDA device and never falls back to the CPU.
"""

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="gpt2-124m",
                   help="model preset (see vitrs_tpu_torch.config.PRESETS)")
    p.add_argument("--dataset", default="cifar10",
                   help="vit: cifar10 | synthetic-shapes | synthetic-imagenet"
                        " | imagenet (.vshard shards in --data-dir); gpt "
                        "mode reads tokens, and empty skips its final val "
                        "loss")
    p.add_argument("--data-dir", default=None,
                   help="cifar-10-batches-py, imagenet's .vshard directory, "
                        "or an llm.c uint16 token file (default: synthetic "
                        "data)")
    p.add_argument("--dataset-size", type=int, default=0,
                   help="n of synthetic-shapes / synthetic-imagenet "
                        "(0: its default)")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--warmup", type=int, default=100)
    p.add_argument("--weight-decay", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--workdir", default="",
                   help="checkpoints and metrics; resumes from the latest "
                        "checkpoint here (default: a fresh temporary "
                        "directory)")
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--ckpt-every", type=int, default=500)
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--remat", nargs="?", const="selective", default=None,
                   choices=["selective", "full", "off"],
                   help="activation checkpointing over blocks: bare or "
                        "'selective' keeps the flash out + lse and the LN "
                        "statistics, 'full' recomputes the whole block, "
                        "'off' none (default: the preset's own)")
    p.add_argument("--profile-at", type=int, default=0,
                   help="a Chrome trace of this step in WORKDIR/profile")
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="e.g. 0.9999; 0 disables EMA")
    p.add_argument("--ra-ops", type=int, default=0,
                   help="RandAugment ops per image (imagenet loader)")
    p.add_argument("--ra-mag", type=float, default=0.0,
                   help="RandAugment magnitude in [0, 1]")
    p.add_argument("--mesh", default="",
                   help="dp=N | fsdp=N[,dp=M] | tp=N[,dp=M][,sp][,vp] | "
                        "pp=N[,dp=M][,schedule=..][,v=..][,mb=..] | "
                        "tp=N,pp=K[,dp=M][,sp][,vp] | ep=N[,dp=M][,tp=K"
                        "[,vp]] | cp=N[,dp=M], one rank a device under "
                        "torchrun")
    p.add_argument("--log-grad-norm", action="store_true")
    p.add_argument("--decay-2d-only", action="store_true",
                   help="weight-decay tensors with >= 2 axes only")
    p.add_argument("--clip-norm", type=float, default=0.0,
                   help="global grad-norm clip (1.0 = standard GPT recipe)")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="gradient-accumulation micro-batches per step")
    p.add_argument("--label-smoothing", type=float, default=0.0)
    p.add_argument("--drop-path", type=float, default=0.0,
                   help="stochastic depth rate (ViT-L recipes: 0.1-0.3)")
    p.add_argument("--mixup-alpha", type=float, default=0.0,
                   help="vit: mixup Beta(a, a) on each batch; 0 = off")
    p.add_argument("--kv-heads", type=int, default=0,
                   help="GQA/MQA K/V head count (0 = MHA)")
    p.add_argument("--pos-emb", default="learned", choices=["learned", "rope"])
    p.add_argument("--window", type=int, default=0,
                   help="sliding-window attention width (gpt mode; 0 = full)")
    p.add_argument("--num-experts", type=int, default=0,
                   help="MoE experts per layer (0 = dense MLP; ops/moe.py)")
    p.add_argument("--moe-top-k", type=int, default=2,
                   help="experts run per token under --num-experts")
    p.add_argument("--optimizer", default="adamw",
                   choices=["adamw", "muon", "adafactor"],
                   help="muon = hybrid Muon/AdamW (ops/muon.py); --lr then "
                        "sets the MATRIX lr (~0.02 scale).  adafactor = "
                        "sublinear optimizer state (ops/adafactor.py); "
                        "--lr is the relative step size (~1e-2 scale)")
    p.add_argument("--muon-adamw-lr", type=float, default=6e-4,
                   help="AdamW lr for non-matrix leaves under --optimizer "
                        "muon")
    p.add_argument("--init-ckpt", default=None,
                   help="warm-start weights from this checkpoint")
    p.add_argument("--eval-only", action="store_true",
                   help="evaluate the latest checkpoint in --workdir and exit")
    p.add_argument("--cpu", action="store_true",
                   help="train on the CPU (the kernels' plain versions)")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    from vitrs_tpu_torch.parallel import multihost
    from vitrs_tpu_torch.train import loop

    if args.eval_only:
        if not args.workdir:
            raise SystemExit("--eval-only needs --workdir")
        import glob
        from vitrs_tpu_torch import checkpoint as C
        from vitrs_tpu_torch import params as P
        from vitrs_tpu_torch.ops._build import resolve_device
        paths = sorted(glob.glob(f"{args.workdir}/ckpt_*.bin"))
        if not paths:
            raise SystemExit(f"no checkpoints in {args.workdir}")
        np_params, cfg, extras = C.load_checkpoint(paths[-1])
        params = P.from_numpy(np_params, cfg, resolve_device(device))
        if cfg.mode == "vit":
            tc = loop.TrainConfig(dataset=args.dataset, data_dir=args.data_dir,
                                  dataset_size=args.dataset_size)
            ds = loop.image_dataset(tc, cfg, train=False)
            res = loop.evaluate(cfg, params, ds, batch=min(256, len(ds)))
        else:
            res = loop.evaluate_gpt(cfg, params, args.data_dir,
                                    seed=args.seed)
        print(json.dumps({"ckpt": paths[-1], "step": extras["step"], **res}))
        return

    tc = loop.TrainConfig(
        preset=args.preset, dataset=args.dataset, data_dir=args.data_dir,
        dataset_size=args.dataset_size, steps=args.steps, batch_size=args.batch_size, lr=args.lr,
        warmup=args.warmup, weight_decay=args.weight_decay, seed=args.seed,
        dtype=args.dtype, workdir=args.workdir, log_every=args.log_every,
        ckpt_every=args.ckpt_every, resume=not args.no_resume,
        init_ckpt=args.init_ckpt, log_grad_norm=args.log_grad_norm,
        clip_norm=args.clip_norm, decay_2d_only=args.decay_2d_only,
        accum_steps=args.accum_steps, label_smoothing=args.label_smoothing,
        drop_path=args.drop_path, mixup_alpha=args.mixup_alpha,
        kv_heads=args.kv_heads, device=device, optimizer=args.optimizer,
        muon_adamw_lr=args.muon_adamw_lr, profile_at=args.profile_at,
        remat={None: None, "selective": True, "full": "full",
               "off": False}[args.remat],
        ema_decay=args.ema_decay, ra_ops=args.ra_ops, ra_mag=args.ra_mag,
        mesh=args.mesh,
        model_overrides={
            k: v for k, v in (("pos_emb", args.pos_emb),
                              ("window", args.window),
                              ("num_experts", args.num_experts),
                              ("moe_top_k",
                               args.moe_top_k if args.num_experts else 0))
            if v not in (0, "learned")} or None)
    # a process group from torchrun's environment (nothing without one)
    multihost.initialize(device=device)
    summary = loop.train(tc)
    print("[done]", summary)


if __name__ == "__main__":
    main()
