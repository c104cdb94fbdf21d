#!/usr/bin/env python
"""vitrs-infer-torch — batch classification throughput with the PyTorch
port (the port of `vitrs_tpu/cli/infer.py`; BASELINE.json configs[1]:
ViT-S/16 ImageNet-1k inference, bf16).

Examples:
  vitrs-infer-torch --preset vit-s-16 --batch-size 256 --steps 20
  vitrs-infer-torch --ckpt run1/ckpt_00001000.bin --batch-size 128
  vitrs-infer-torch --preset vit-tiny-4-cifar10 --cpu --batch-size 8 --steps 2
  vitrs-infer-torch --preset vit-b-16 --quant w8a8 --batch-size 256

Random weights from seed 0 unless --ckpt; the batch is standard-normal
images from np.random.default_rng(0).  The forward runs under
torch.inference_mode with the compute-dtype weights prepared once.
--quant w8 (int8 weights) or w8a8 (int8 weights and activations, int8
tensor cores) quantizes the weights once (ops/quant.quantize_params) and
runs models/quantized.vit_forward_q.  Prints one JSON line: images/s,
latency, MFU (forward FLOPs over the bf16 peak whatever --quant, on a CUDA
device; null on the CPU), peak device memory, the device's kind and the
quant mode.  Without --cpu it needs a CUDA device.
"""

import argparse
import json
import time


def run(preset: str = "vit-s-16", ckpt=None, batch_size: int = 256,
        steps: int = 20, dtype: str = "bfloat16", device: str = "cuda",
        quant: str = "none") -> dict:
    """Build the model, time `steps` forwards of one batch after a warm-up
    forward, and return the JSON record (plus "logits", the last batch's
    fp32 logits, on the device)."""
    import numpy as np
    import torch
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.models import model as M
    from vitrs_tpu_torch.models import quantized as Q
    from vitrs_tpu_torch.ops import quant as QT
    from vitrs_tpu_torch.train.loop import device_kind
    from vitrs_tpu_torch.utils import flops as F
    from vitrs_tpu_torch.vit import ViT

    if quant not in ("none", "w8", "w8a8"):
        raise ValueError(f"quant {quant!r}: none, w8 or w8a8")
    if ckpt:
        model = ViT.build_from_checkpoint(ckpt, device=device, dtype=dtype)
    else:
        model = ViT.from_config(get_config(preset, dtype=dtype), device=device)
    cfg = model.config
    if cfg.mode != "vit":
        raise ValueError(f"{preset or ckpt}: image inference needs a "
                         f"vit-mode model")
    dev = model.device
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (batch_size, cfg.img_size, cfg.img_size, cfg.in_chans),
        dtype=np.float32), device=dev)
    if quant == "none":
        params = model._compute     # cast to cfg.dtype once, at build

        def fwd(p, x):
            return M.vit_forward(p, x, cfg)
    else:
        params = M.prepare_params(QT.quantize_params(model.params,
                                                     mode=cfg.mode), cfg)

        def fwd(p, x):
            return Q.vit_forward_q(p, x, cfg, w8a8=quant == "w8a8")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with torch.inference_mode():
        logits = fwd(params, x)                     # warm-up
        sync()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            logits = fwd(params, x)
        sync()
        dt = (time.perf_counter() - t0) / steps
    ips = batch_size / dt
    kind = device_kind(dev)
    return {
        "metric": f"{preset if not ckpt else cfg.mode} inference "
                  f"images/sec/chip "
                  f"({cfg.dtype if quant == 'none' else quant})",
        "quant": quant,
        "value": round(ips, 1),
        "unit": "images/sec/chip",
        "batch": batch_size,
        "latency_ms": round(dt * 1e3, 3),
        "mfu": (round(F.mfu(ips, cfg, kind, train=False), 4)
                if dev.type == "cuda" else None),
        "peak_mem_gib": (round(torch.cuda.max_memory_allocated(dev) / 2**30,
                               3) if dev.type == "cuda" else None),
        "device": kind,
        "logits": logits,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="vit-s-16")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint path (else random init from seed 0)")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--quant", default="none", choices=["none", "w8", "w8a8"],
                   help="int8 post-training quantization: w8 = weight-only, "
                        "w8a8 = int8 weights and activations")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    args = p.parse_args(argv)
    rec = run(args.preset, args.ckpt, args.batch_size, args.steps, args.dtype,
              "cpu" if args.cpu else "cuda", args.quant)
    rec.pop("logits")
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
