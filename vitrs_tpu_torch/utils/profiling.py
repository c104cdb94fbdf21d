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

prints one JSON object per run: the workload, its groups in ms per call,
the busy, wall and profiled wall ms per call, the busy share, and the
card's name.  It needs a CUDA device.
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
    ("eager reductions", r"reduce|Reduce"),
    ("eager elementwise, copies, casts",
     r"elementwise|Elementwise|vectorized|unrolled|Copy|copy|Functor|fill"),
)


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
    """{"groups": {group: device ms per call}, "busy_ms", "wall_ms",
    "profiled_wall_ms", "busy_share", "kernels_per_call"}: the groups and
    busy_ms over `iters` profiled calls of fn; wall_ms over `iters`
    unprofiled calls just before them, in the same process, so busy_share
    = busy_ms / wall_ms compares the two within one run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    wall = _wall(fn, iters)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_wall = _wall(fn, iters)
    groups: collections.Counter = collections.Counter()
    n = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            groups[_group(e.name)] += e.time_range.elapsed_us()
            n += 1
    busy_ms = sum(groups.values()) / iters / 1e3
    return {"groups": {g: round(us / iters / 1e3, 4)
                       for g, us in groups.most_common()},
            "busy_ms": round(busy_ms, 4),
            "wall_ms": round(wall * 1e3, 4),
            "profiled_wall_ms": round(profiled_wall * 1e3, 4),
            "busy_share": round(busy_ms / (wall * 1e3), 4),
            "kernels_per_call": n // iters}


def _train_step(args):
    """One training step of the trainer (fp32 masters in the flat arena,
    bf16 compute) on the synthetic token stream, at --max-seq-len, with
    --pos-emb and --window."""
    from .. import params as P
    from ..config import get_config
    from ..data import tokens as TOK
    from ..parallel import data_parallel as dp
    cfg = get_config(args.preset, dtype="bfloat16",
                     num_kv_heads=args.kv_heads, max_seq_len=args.max_seq_len,
                     pos_emb=args.pos_emb, window=args.window)
    mesh = dp.make_mesh(devices=["cuda"])
    params = P.unflatten_params(P.flatten_params(
        P.init_params(cfg, torch.Generator().manual_seed(0)), cfg).cuda(), cfg)
    m, v = dp.init_sharded_opt_state(cfg, mesh)
    step = dp.make_dp_train_step(cfg, mesh)
    stream = TOK.get_tokens(None, cfg.vocab_size, seed=0)
    x, y = TOK.TokenLoader(stream, args.batch, cfg.max_seq_len).next_batch()
    return lambda: step(params, m, v, x, y, 1, 3e-4, 0.1)


def _prefill(args):
    """One prefill of a seeded prompt through generate (max_new=1)."""
    import numpy as np
    from .. import params as P
    from ..config import get_config
    from ..models import generate as G
    from ..models import model as M
    cfg = get_config(args.preset, dtype="bfloat16", num_kv_heads=args.kv_heads,
                     max_seq_len=args.max_seq_len, pos_emb=args.pos_emb,
                     window=args.window)
    pp = M.prepare_params({k: t.cuda() for k, t in P.init_params(
        cfg, torch.Generator().manual_seed(0)).items()}, cfg)
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.prompt)), device="cuda")
    return lambda: G.generate(pp, prompt, cfg, 1, temperature=0.0,
                              prefill_chunk=args.chunk)


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("what", choices=["train", "prefill"])
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
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    fn = (_train_step if args.what == "train" else _prefill)(args)
    print(json.dumps({**vars(args), **op_breakdown(fn, args.iters),
                      "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
