"""Device-time breakdown with torch.profiler — the port of
`vitrs_tpu/utils/profiling.py` (its `capture` + `op_breakdown`) for one
CUDA device.

`op_breakdown(fn)` runs fn once to warm up (kernel builds, cuBLAS
heuristics, the allocator), then `iters` times on the host clock, then
`iters` times under the profiler, and sums the device time of every CUDA
kernel by group: the port's own kernels by name, cuBLAS matmuls, eager
elementwise and copy kernels, reductions, and the rest.  The device busy
share is that device time over the unprofiled wall time of the same
process (the profiler stretches its own window's wall time, which is
reported apart).

    python -m vitrs_tpu_torch.utils.profiling train --kv-heads 4
    python -m vitrs_tpu_torch.utils.profiling train --batch 2 \\
        --max-seq-len 8192 --pos-emb rope --window 1024
    python -m vitrs_tpu_torch.utils.profiling prefill --kv-heads 4 \\
        --max-seq-len 8192 --batch 8 --prompt 7680 --chunk 512
    python -m vitrs_tpu_torch.utils.profiling train --preset vit-b-16 \\
        --batch 64
    python -m vitrs_tpu_torch.utils.profiling infer --preset vit-s-16 \\
        --batch 256                         # --quant w8 | w8a8: int8 weights
    python -m vitrs_tpu_torch.utils.profiling prefill --kv-heads 4 \\
        --max-seq-len 8192 --batch 8 --prompt 7680 --chunk 512 --kv-int8
    python -m vitrs_tpu_torch.utils.profiling train --preset gpt2-124m-4k \\
        --batch 4 --max-seq-len 4096 --remat selective

prints one JSON object per run: the workload, its groups in ms per call,
the busy, wall and profiled wall ms per call, the busy share, and the
card's name.  It needs a CUDA device.

`trace(fn, out_dir, name)` is the training loop's `profile_at`: one call of
fn under the profiler, exported as a Chrome trace (chrome://tracing,
Perfetto) into out_dir, as the JAX loop's `jax.profiler` trace goes to
workdir/profile/; it returns fn's result with the trace's summary.

Both carry the program's own spans (`utils/trace.py`): the engine's
`gen.admit` / `gen.prefill` / `gen.decode` / `gen.sample`, the training
step's `train.step` and its phases, `model.vit_forward`, `data.normalize`,
and `op.layernorm` / `op.gelu` forward and backward, the backward ones on
autograd's device thread.  They are host ranges only while a profiler
records (no device-row annotation, so the groups' device time is the
kernels' alone), and cost nothing but the call otherwise.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import time
from typing import Callable, Dict

import torch

# kernel-name patterns, in the order they are tried; the first match names
# the group
GROUPS = (
    ("flash_fwd (K1/K3-fwd/K4)", r"flash_fwd"),
    ("flash_bwd dK/dV", r"flash_bwd_dkv"),
    ("flash_bwd dQ", r"flash_bwd_dq"),
    ("flash_bwd pre-pass", r"flash_bwd_prep"),
    ("fused head + CE (K8)", r"head_ce"),
    ("fused CE (K5/K6)", r"ce_fwd|ce_bwd"),
    ("fused AdamW (K7)", r"adamw"),
    ("cuBLAS matmul", r"nvjet|gemm|cutlass|xmma|cublas"),
    # indexing kernels of any model: the MoE layer's routing, dispatch and
    # combine (ops/moe.py: row gathers, the slot map's scatter, the k-major
    # cumsum, the top-k sort), the embedding lookup's gather and backward
    ("index/gather/scatter/scan/sort",
     r"index|Index|gather|Gather|scatter|Scatter|scan|Scan|cumsum|sort|Sort"
     r"|topk|TopK"),
    ("eager reductions", r"reduce|Reduce"),
    ("eager elementwise, copies, casts",
     r"elementwise|Elementwise|vectorized|unrolled|Copy|copy|Functor|fill"),
)


# the kernels op_breakdown names one by one, the most device time first
TOP_KERNELS = 12


def _group(name: str) -> str:
    for group, pattern in GROUPS:
        if re.search(pattern, name):
            return group
    return "other"


def _wall(fn: Callable[[], object], iters: int) -> float:
    """Seconds per call of fn, from the host clock around `iters` calls
    with the device drained before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters


def op_breakdown(fn: Callable[[], object], iters: int = 3) -> Dict:
    """{"groups": {group: device ms per call}, "top_kernels", "busy_ms",
    "wall_ms", "profiled_wall_ms", "busy_share", "kernels",
    "kernels_per_call"}: the groups and busy_ms over `iters` profiled calls
    of fn; wall_ms over `iters` unprofiled calls just before them, in the
    same process, so
    busy_share = busy_ms / wall_ms compares the two within one run;
    kernels: the device events the capture caught over its `iters` calls;
    top_kernels: the TOP_KERNELS kernel names (cut to 100 characters) with
    the most device time, ms per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    wall = _wall(fn, iters)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_wall = _wall(fn, iters)
    groups: collections.Counter = collections.Counter()
    names: collections.Counter = collections.Counter()
    n = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            groups[_group(e.name)] += us
            names[e.name[:100]] += us
            n += 1
    busy_ms = sum(groups.values()) / iters / 1e3
    return {"groups": {g: round(us / iters / 1e3, 4)
                       for g, us in groups.most_common()},
            "top_kernels": {k: round(us / iters / 1e3, 4)
                            for k, us in names.most_common(TOP_KERNELS)},
            "busy_ms": round(busy_ms, 4),
            "wall_ms": round(wall * 1e3, 4),
            "profiled_wall_ms": round(profiled_wall * 1e3, 4),
            "busy_share": round(busy_ms / (wall * 1e3), 4),
            "kernels": n,
            "kernels_per_call": n // iters}


def trace(fn: Callable[[], object], out_dir: str, name: str):
    """Run fn once under torch.profiler (the CPU, and CUDA on a card; the
    device drained before and after) and export a Chrome trace to
    out_dir/<name>.json.  Returns (fn's result, {"path",
    "profiled_wall_ms", "busy_ms" (the summed device time of its CUDA
    kernels; None on the CPU), "groups" (that device time by `GROUPS`,
    ms), "kernels"})."""
    import os
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        sync()
        t0 = time.perf_counter()
        result = fn()
        sync()
        wall = time.perf_counter() - t0
    path = os.path.join(out_dir, name + ".json")
    prof.export_chrome_trace(path)
    groups: collections.Counter = collections.Counter()
    n = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            groups[_group(e.name)] += e.time_range.elapsed_us()
            n += 1
    return result, {
        "path": path, "profiled_wall_ms": round(wall * 1e3, 4),
        "busy_ms": round(sum(groups.values()) / 1e3, 4) if cuda else None,
        "groups": {g: round(us / 1e3, 4) for g, us in groups.most_common()},
        "kernels": n}


REMAT = {"preset": None, "off": False, "selective": True, "full": "full"}


def _config(args):
    """The preset in bf16 under --remat; a gpt preset with --kv-heads,
    --max-seq-len, --pos-emb and --window (a vit preset keeps its own
    geometry)."""
    from ..config import PRESETS, get_config
    remat = REMAT[getattr(args, "remat", "preset")]
    kw = {} if remat is None else {"remat": remat}
    if PRESETS[args.preset].mode == "vit":
        return get_config(args.preset, dtype="bfloat16", **kw)
    return get_config(args.preset, dtype="bfloat16",
                      num_kv_heads=args.kv_heads, max_seq_len=args.max_seq_len,
                      pos_emb=args.pos_emb, window=args.window, **kw)


def _images(cfg, batch):
    """A seeded uint8 image batch and its labels, as the vit loader ships
    them."""
    import numpy as np
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (batch, cfg.img_size, cfg.img_size,
                              cfg.in_chans), dtype=np.uint8)
    return x, rng.integers(0, cfg.num_classes, batch)


def _train_step(args):
    """One training step of the trainer (fp32 masters in the flat arena,
    bf16 compute): gpt presets on the synthetic token stream, at
    --max-seq-len, with --pos-emb and --window; vit presets on a seeded
    uint8 image batch normalised on the device."""
    from .. import params as P
    from ..data import datasets as D
    from ..data import tokens as TOK
    from ..parallel import data_parallel as dp
    cfg = _config(args)
    mesh = dp.make_mesh(devices=["cuda"])
    params = P.unflatten_params(P.flatten_params(
        P.init_params(cfg, torch.Generator().manual_seed(0)), cfg).cuda(), cfg)
    m, v = dp.init_sharded_opt_state(cfg, mesh)
    if cfg.mode == "vit":
        step = dp.make_dp_train_step(
            cfg, mesh, normalize=(D.IMAGENET_MEAN, D.IMAGENET_STD))
        x, y = _images(cfg, args.batch)
        return lambda: step(params, m, v, x, y, 1, 1e-3, 0.05)
    step = dp.make_dp_train_step(cfg, mesh)
    stream = TOK.get_tokens(None, cfg.vocab_size, seed=0)
    x, y = TOK.TokenLoader(stream, args.batch, cfg.max_seq_len).next_batch()
    return lambda: step(params, m, v, x, y, 1, 3e-4, 0.1)


def _infer(args):
    """One inference forward of a vit preset (bf16 weights prepared once;
    int8 under --quant, through models/quantized.vit_forward_q) on a seeded
    normalised image batch."""
    from .. import params as P
    from ..data import datasets as D
    from ..models import model as M
    from ..models import quantized as Q
    from ..ops import quant
    from ..parallel import data_parallel as dp
    cfg = _config(args)
    params = {k: t.cuda() for k, t in P.init_params(
        cfg, torch.Generator().manual_seed(0)).items()}
    if args.quant != "none":
        params = quant.quantize_params(params, mode=cfg.mode)
    pp = M.prepare_params(params, cfg)
    x = dp.normalize_images(torch.as_tensor(_images(cfg, args.batch)[0],
                                            device="cuda"),
                            D.IMAGENET_MEAN, D.IMAGENET_STD)

    def run():
        with torch.inference_mode():
            if args.quant == "none":
                return M.vit_forward(pp, x, cfg)
            return Q.vit_forward_q(pp, x, cfg, w8a8=args.quant == "w8a8")
    return run


def _prefill(args):
    """One prefill of a seeded prompt through generate (max_new=1)."""
    import numpy as np
    from .. import params as P
    from ..models import generate as G
    from ..models import model as M
    cfg = _config(args)
    pp = M.prepare_params({k: t.cuda() for k, t in P.init_params(
        cfg, torch.Generator().manual_seed(0)).items()}, cfg)
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.prompt)), device="cuda")
    return lambda: G.generate(pp, prompt, cfg, 1, temperature=0.0,
                              prefill_chunk=args.chunk, kv_int8=args.kv_int8)


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("what", choices=["train", "prefill", "infer"])
    p.add_argument("--preset", default="gpt2-124m")
    p.add_argument("--kv-heads", type=int, default=0)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--max-seq-len", type=int, default=1024)
    p.add_argument("--pos-emb", default="learned", choices=["learned", "rope"])
    p.add_argument("--window", type=int, default=0,
                   help="sliding-window attention width (0 = full)")
    p.add_argument("--prompt", type=int, default=1024)
    p.add_argument("--chunk", type=int, default=0)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--remat", default="preset", choices=list(REMAT),
                   help="the block body (default: the preset's own)")
    p.add_argument("--quant", default="none", choices=["none", "w8", "w8a8"],
                   help="infer: int8 weights (w8) and activations (w8a8)")
    p.add_argument("--kv-int8", action="store_true",
                   help="prefill: the int8 KV cache")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    fn = {"train": _train_step, "prefill": _prefill,
          "infer": _infer}[args.what](args)
    print(json.dumps({**vars(args), **op_breakdown(fn, args.iters),
                      "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
