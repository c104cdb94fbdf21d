#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernel from csrc/ and drives the port's serving path
on the card, raising on any failure.  Phases, each printed as it ends:

  1. device   the card's name and power limit (nvidia-smi); the kernel's
              build time and ptxas resources.
  2. kernels  K1-fwd (flash-attention forward) against its plain PyTorch
              version on the same inputs, bf16 and fp32, at the serving
              shapes; then kernel and plain times at the prefill buckets.
  3. serve    GPT-2 124M (full width, seeded random weights, bf16) through
              GenerationEngine: 8 greedy requests, chunked and per-tick
              decode, launches == 12 x prefill dispatches; then TextEngine.
  4. xdevice  a small fp32 model through the engine on CUDA (kernel) and on
              the CPU (plain version): same greedy tokens, prefill logits
              within 1e-4.

The line before the last is a JSON object describing the kernel; the last is
{"ok": true, "device": {...}}.  Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

KERNEL_SOURCE = "vitrs_tpu_torch/csrc/flash_fwd.cu"


def check(ok, msg):
    if not ok:
        raise RuntimeError(msg)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() in ms, from CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)                  # as nvidia-smi gives it: name, power limit
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    from vitrs_tpu_torch.ops import _build
    lib = _build.load("flash_fwd")
    print(f"[device] built {lib.path} in {lib.build_seconds:.3f} s")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[device] ptxas: {line.strip()}")
    return smi


def phase_kernels():
    """K1-fwd vs plain at NH=12, D=64, C=768, B=4, T in {37 .. 1024}:
    one q tile, several, and ragged ends.  Tolerances:
      bf16 out  atol=rtol=2e-2: p rounds to bf16 against the kernel's
                running max but the plain version's final max (2^-8
                relative each), and out itself rounds to bf16;
      bf16 lse  atol 1e-3: both sum the same fp32 p, in another order;
      fp32      1e-5: fp32 throughout, only the summation order differs."""
    from vitrs_tpu_torch.ops.flash_attention import flash_fwd_cuda, flash_fwd_plain
    NH, C = 12, 768
    gen = torch.Generator(device="cuda").manual_seed(0)
    tol = {torch.bfloat16: (2e-2, 1e-3), torch.float32: (1e-5, 1e-5)}
    worst = {}
    for dtype, (out_tol, lse_tol) in tol.items():
        for T in (37, 128, 512, 1000, 1024):
            qkv = torch.randn(4, T, 3 * C, generator=gen, device="cuda").to(dtype)
            q, k, v = qkv.split(C, dim=-1)
            out, lse = flash_fwd_cuda(q, k, v, NH, True, 0.125)
            ref, ref_lse = flash_fwd_plain(q, k, v, NH, True, 0.125)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            lse_err = (lse - ref_lse).abs().max().item()
            bad = (err > out_tol + out_tol * ref.float().abs()).sum().item()
            print(f"[kernels] {str(dtype)[6:]:8s} T={T:4d} out max_abs_err "
                  f"{err.max().item():.3e} lse max_abs_err {lse_err:.3e}")
            check(torch.isfinite(out).all().item(), f"non-finite out at T={T}")
            check(bad == 0, f"{dtype} T={T}: {bad} out elements beyond {out_tol}")
            check(lse_err <= lse_tol, f"{dtype} T={T}: lse err {lse_err}")
            worst[dtype] = max(worst.get(dtype, 0.0), err.max().item())
    times = {}
    for T in (128, 512, 1024):
        qkv = torch.randn(8, T, 3 * C, generator=gen, device="cuda").to(torch.bfloat16)
        q, k, v = qkv.split(C, dim=-1)
        # plain, kernel, kernel, plain: the halves of each pair see the same card
        p1 = cuda_ms(lambda: flash_fwd_plain(q, k, v, NH, True, 0.125))
        k1 = cuda_ms(lambda: flash_fwd_cuda(q, k, v, NH, True, 0.125))
        k2 = cuda_ms(lambda: flash_fwd_cuda(q, k, v, NH, True, 0.125))
        p2 = cuda_ms(lambda: flash_fwd_plain(q, k, v, NH, True, 0.125))
        times[T] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"[kernels] time bf16 B=8 T={T:4d} NH=12 causal: kernel "
              f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms")
    return worst[torch.bfloat16], times


def phase_serve(smi):
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.data.tokenizer import ByteBPETokenizer
    from vitrs_tpu_torch.models import model as M
    from vitrs_tpu_torch.ops.flash_attention import flash_fwd_cuda
    from vitrs_tpu_torch.serving_gen import GenerationEngine, TextEngine

    cfg = get_config("gpt2-124m", dtype="bfloat16")
    check(P.num_parameters(cfg) == 124_439_808, "gpt2-124m parameter count")
    params = P.init_params(cfg, torch.Generator().manual_seed(0))
    params = {k: v.to("cuda") for k, v in params.items()}
    rng = np.random.default_rng(0)
    lengths = (5, 37, 128, 300, 511, 700, 900, 960)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lengths]

    def serve(chunk):
        eng = GenerationEngine(params, cfg, max_slots=8, max_len=1024,
                               prompt_buckets=(128, 512, 1024),
                               decode_chunk=chunk)
        for p in prompts:
            eng.submit(p, max_new=32)
        flash_fwd_cuda.launches = 0
        t0 = time.perf_counter()
        eng._admit()                       # the prefill passes, timed alone
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        outs = dict(eng.run())
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = flash_fwd_cuda.launches
        check(launches > 0 and launches == cfg.num_layers * eng.prefill_dispatches,
              f"kernel launches {launches} != {cfg.num_layers} x "
              f"{eng.prefill_dispatches} prefill dispatches")
        return eng, outs, launches, (t1 - t0) * 1e3, 8 * 32 / (t2 - t1)

    serve(16)                                  # warm-up: cuBLAS, allocator
    eng, outs16, launches, prefill_ms, tok_s = serve(16)
    _, outs1, launches1, prefill_ms1, tok_s1 = serve(1)
    for i, n in enumerate(lengths):
        check(len(outs16[i]) == n + 32, f"request {i}: length {len(outs16[i])}")
        check(np.array_equal(outs16[i], outs1[i]), f"request {i}: chunk 16 != 1")
        gen = outs16[i][n:]
        check(((gen >= 0) & (gen < cfg.vocab_size)).all(), f"request {i}: ids")
    # full-sequence logits through the model forward: finite
    seq = torch.as_tensor(outs16[7][None], device="cuda")
    logits = M.gpt_forward(eng.params, seq, cfg)
    check(torch.isfinite(logits).all().item(), "non-finite logits")
    print(f"[serve] gpt2-124m bf16, 8 requests x 32 new, prompts {lengths}")
    print(f"[serve] chunk 16: {eng.prefill_dispatches} prefill dispatches, "
          f"{launches} kernel launches, prefill {prefill_ms:.3f} ms, decode "
          f"{tok_s:.1f} tok/s  ({smi})")
    print(f"[serve] chunk 1: {launches1} kernel launches, prefill "
          f"{prefill_ms1:.3f} ms, decode {tok_s1:.1f} tok/s, same tokens")

    tok = ByteBPETokenizer()
    # the byte tokenizer has 257 ids: a model of that vocab, same trunk
    tcfg = cfg.replace(vocab_size=tok.vocab_size)
    tparams = dict(params, wte=params["wte"][:tok.vocab_size])
    te = TextEngine(tparams, tcfg, tok, max_slots=2, max_len=256,
                    decode_chunk=8)
    texts = te.generate(["Once upon a time", "The H100 says"], max_new=16)
    check(len(texts) == 2 and all(isinstance(t, str) for t in texts),
          "TextEngine output")
    print(f"[serve] TextEngine: {texts!r}")
    return launches, prefill_ms, tok_s


def phase_xdevice():
    """The engine on CUDA (kernel, fp32 instance) and on the CPU (plain
    version) with the same fp32 weights: same greedy tokens, prefill logits
    within 1e-4 (fp32 sums in other orders; TF32 off)."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.models import generate as G
    from vitrs_tpu_torch.models import model as M
    from vitrs_tpu_torch.ops.flash_attention import flash_fwd_cuda
    from vitrs_tpu_torch.serving_gen import GenerationEngine

    cfg = get_config("gpt-nano").replace(num_layers=2, num_heads=2,
                                         channels=128, max_seq_len=64)
    params = P.init_params(cfg, torch.Generator().manual_seed(1))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (3, 17, 40, 55)]
    outs = {}
    for dev in ("cuda", "cpu"):
        flash_fwd_cuda.launches = 0
        eng = GenerationEngine({k: v.to(dev) for k, v in params.items()},
                               cfg, max_slots=2, max_len=64,
                               prompt_buckets=(16, 32, 64), decode_chunk=4)
        for p in prompts:
            eng.submit(p, max_new=8)
        outs[dev] = dict(eng.run())
        if dev == "cuda":
            check(flash_fwd_cuda.launches == cfg.num_layers * eng.prefill_dispatches,
                  "xdevice: the CUDA engine's prefill did not use the kernel")
        else:
            check(flash_fwd_cuda.launches == 0, "xdevice: kernel ran on CPU")
    for i in range(len(prompts)):
        check(np.array_equal(outs["cuda"][i], outs["cpu"][i]),
              f"xdevice: request {i} tokens differ")
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 50)))
    lg = {}
    for dev in ("cuda", "cpu"):
        caches = G.init_kv_cache(cfg, 2, 64, device=dev)
        pp = M.prepare_params({k: v.to(dev) for k, v in params.items()}, cfg)
        lg[dev] = G.forward_with_cache(pp, toks.to(dev), caches, 0, cfg)[0].cpu()
    err = (lg["cuda"] - lg["cpu"]).abs().max().item()
    print(f"[xdevice] fp32 L=2 C=128: tokens equal on cuda and cpu; "
          f"prefill logits max_abs_err {err:.3e}")
    check(err <= 1e-4, f"xdevice: prefill logits differ by {err}")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch sees no CUDA device")
    import vitrs_tpu_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    err, times = phase_kernels()
    launches, prefill_ms, tok_s = phase_serve(smi)
    phase_xdevice()
    kernel_ms, plain_ms = times[1024]
    print(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": "vitrs_tpu/ops/flash_attention.py:567",
        "also_replaces": "vitrs_tpu/ops/flash_attention.py:374",
        "launches": launches, "max_abs_err": err,
        "ms": kernel_ms, "plain_ms": plain_ms,
        "shape": "bf16 B=8 T=1024 NH=12 D=64 causal",
        "prefill_ms": prefill_ms, "decode_tok_s": tok_s}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
