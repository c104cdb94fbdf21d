#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (one nvcc per source, all at
once) and drives the port's serving and training paths on the card, raising
on any failure.  Phases, each printed as it ends:

  1. device         the card's name and power limit (nvidia-smi); each
                    library's build time and ptxas resources.
  2. kernels        K1-fwd (flash-attention forward) against its plain
                    PyTorch version on the same inputs, bf16 and fp32, at the
                    serving shapes; then kernel and plain times.
  3. serve          GPT-2 124M (full width, seeded random weights, bf16)
                    through GenerationEngine: 8 greedy requests, chunked and
                    per-tick decode, launches == 12 x prefill dispatches;
                    then TextEngine.
  4. xdevice        a small fp32 model through the engine on CUDA (kernel)
                    and on the CPU (plain version): same greedy tokens,
                    prefill logits within 1e-4.
  5. kernels-train  K2 (flash backward), K5/K6 (fused CE forward/backward)
                    and K7 (fused AdamW) against their plain versions at the
                    training shapes, then kernel and plain times.
  6. train          GPT-2 124M at full width and depth (fp32 masters, bf16
                    compute, B=8, T=1024, the synthetic token stream) for
                    12 steps through train/loop.train: finite, falling loss;
                    every kernel launched on every step in the designed
                    counts (a K2 launch is one call that runs its three
                    kernels: di, dK/dV, dQ); step ms, tok/s, MFU and peak
                    memory.
  7. xdevice-train  one training step of a small fp32 model (D=64, fused CE
                    route) on CUDA with the kernels and on the CPU with the
                    plain versions, from the same weights and tokens: loss,
                    all 16 grads and the updated params agree.

The line before the last is a JSON object describing the kernels; the last
is {"ok": true, "device": {...}}.  Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

CSRC = "vitrs_tpu_torch/csrc/"
LIBS = ("flash_fwd", "flash_bwd", "fused_ce", "fused_adamw")


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
    t0 = time.perf_counter()
    libs = _build.load_all(LIBS)        # one nvcc per source, in parallel
    print(f"[device] built {len(libs)} libraries in "
          f"{time.perf_counter() - t0:.3f} s")
    for name, lib in libs.items():
        print(f"[device] {name}: {lib.path} ({lib.build_seconds:.3f} s)")
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
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



def timed_pair(kernel, plain):
    """(kernel ms, plain ms): each the mean of two cuda_ms runs, in the
    order plain, kernel, kernel, plain, so both halves see the same card."""
    p1, k1, k2, p2 = (cuda_ms(f) for f in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2, (k1, k2, p1, p2)


def phase_kernels_train():
    """K2, K5, K6 and K7 against their plain versions, then times at the
    training shapes.  Tolerances (as tests/test_torch_train_cuda.py):
      K2 bf16 2e-2 abs + rel: p and ds round to bf16 before their products
         in both versions, and the fp32 sums run in other orders, which can
         flip a rounding (2^-8 relative);  K2 fp32 1e-4;
      K5 lse 1e-4 abs (fp32 logsumexp over 50257 columns, other order),
         picked exact (a copy);
      K6 2^-8 relative + 1e-6 abs (one bf16 ulp: the same fp32 formula,
         expf against torch.exp);
      K7 rtol 2e-6, atol 1e-9 (the same fp32 operations in the same
         order)."""
    from vitrs_tpu_torch.ops import flash_attention as FA
    from vitrs_tpu_torch.ops import fused_adamw as FW
    from vitrs_tpu_torch.ops import fused_ce as CE
    gen = torch.Generator(device="cuda").manual_seed(2)
    res = {}
    NH, C = 12, 768
    worst = 0.0
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        for T in (37, 128, 512, 1000, 1024):
            for causal in (True, False):
                qkv = torch.randn(4, T, 3 * C, generator=gen, device="cuda").to(dtype)
                out, lse = FA.flash_attention_fwd(qkv, NH, causal)
                do = torch.randn(4, T, C, generator=gen, device="cuda").to(dtype)
                q, k, v = qkv.split(C, dim=-1)
                got = FA.flash_bwd_cuda(q, k, v, out, lse, do, NH, causal, 0.125)
                want = FA.flash_bwd_plain(q, k, v, out, lse, do, NH, causal, 0.125)
                torch.cuda.synchronize()
                errs = []
                for name, a, b in zip(("dq", "dk", "dv"), got, want):
                    check(torch.isfinite(a).all().item(), f"K2 {name} non-finite")
                    d = (a.float() - b.float()).abs()
                    bad = (d > tol + tol * b.float().abs()).sum().item()
                    check(bad == 0, f"K2 {dtype} T={T} causal={causal}: {bad} "
                          f"{name} values beyond {tol}")
                    errs.append(d.max().item())
                print(f"[kernels-train] K2 {str(dtype)[6:]:8s} T={T:4d} "
                      f"causal={int(causal)} max_abs_err dq/dk/dv "
                      f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}")
                if dtype == torch.bfloat16:
                    worst = max(worst, *errs)
    qkv = torch.randn(8, 1024, 3 * C, generator=gen, device="cuda").to(torch.bfloat16)
    out, lse = FA.flash_attention_fwd(qkv, NH, True)
    do = torch.randn(8, 1024, C, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = qkv.split(C, dim=-1)
    km, pm, raw = timed_pair(
        lambda: FA.flash_bwd_cuda(q, k, v, out, lse, do, NH, True, 0.125),
        lambda: FA.flash_bwd_plain(q, k, v, out, lse, do, NH, True, 0.125))
    print(f"[kernels-train] K2 time bf16 B=8 T=1024 NH=12 causal: kernel "
          f"{raw[0]:.4f}/{raw[1]:.4f} ms, plain {raw[2]:.4f}/{raw[3]:.4f} ms")
    res["flash_bwd"] = dict(max_abs_err=worst, ms=km, plain_ms=pm,
                            shape="bf16 B=8 T=1024 NH=12 D=64 causal")

    R, V = 8192, 50257
    Vp = CE.pad_vocab(V)
    logits = (3 * torch.randn(R, Vp, generator=gen, device="cuda")).to(torch.bfloat16)
    targets = torch.randint(0, V, (R,), generator=gen, device="cuda")
    g = torch.full((R,), 1.0 / R, device="cuda")
    lse, picked = CE.ce_fwd_cuda(logits, targets, V)
    want_lse, want_picked = CE.ce_fwd_plain(logits, targets, V)
    d = CE.ce_bwd_cuda(logits, targets, lse, g, V)
    want_d = CE.ce_bwd_plain(logits, targets, lse, g, V)
    torch.cuda.synchronize()
    lse_err = (lse - want_lse).abs().max().item()
    pick_err = (picked - want_picked).abs().max().item()
    derr = (d.float() - want_d.float()).abs()
    bad = (derr > 1e-6 + 2 ** -8 * want_d.float().abs()).sum().item()
    check(lse_err <= 1e-4 and pick_err == 0.0,
          f"K5: lse err {lse_err}, picked err {pick_err}")
    check(bad == 0, f"K6: {bad} dlogits values beyond one bf16 ulp")
    check(bool((d[:, V:] == 0).all()), "K6: pad columns not 0")
    print(f"[kernels-train] K5 R={R} Vp={Vp} bf16: lse max_abs_err "
          f"{lse_err:.3e}, picked {pick_err:.1e}; K6 dlogits max_abs_err "
          f"{derr.max().item():.3e}")
    km, pm, raw = timed_pair(lambda: CE.ce_fwd_cuda(logits, targets, V),
                             lambda: CE.ce_fwd_plain(logits, targets, V))
    print(f"[kernels-train] K5 time: kernel {raw[0]:.4f}/{raw[1]:.4f} ms, "
          f"plain {raw[2]:.4f}/{raw[3]:.4f} ms")
    shape = f"bf16 R={R} Vp={Vp} real_vocab={V}"
    res["ce_fwd"] = dict(max_abs_err=lse_err, ms=km, plain_ms=pm, shape=shape)
    km, pm, raw = timed_pair(lambda: CE.ce_bwd_cuda(logits, targets, lse, g, V),
                             lambda: CE.ce_bwd_plain(logits, targets, lse, g, V))
    print(f"[kernels-train] K6 time: kernel {raw[0]:.4f}/{raw[1]:.4f} ms, "
          f"plain {raw[2]:.4f}/{raw[3]:.4f} ms")
    res["ce_bwd"] = dict(max_abs_err=derr.max().item(), ms=km, plain_ms=pm,
                         shape=shape)
    del logits, d, want_d, derr

    worst = 0.0
    for n in (1_000_003, 124_439_808):
        p, gr, m = (torch.randn(n, generator=gen, device="cuda") for _ in range(3))
        v = torch.rand(n, generator=gen, device="cuda")
        want = FW.adamw_plain(p.clone(), gr, m.clone(), v.clone(), 7, 3e-4,
                              weight_decay=0.1)
        got = FW.adamw_cuda(p, gr, m, v, 7, 3e-4, weight_decay=0.1)
        torch.cuda.synchronize()
        for name, a, b in zip("pmv", got, want):
            err = (a - b).abs()
            bad = (err > 1e-9 + 2e-6 * b.abs()).sum().item()
            check(bad == 0, f"K7 n={n}: {bad} {name} values beyond tolerance")
            worst = max(worst, err.max().item())
        print(f"[kernels-train] K7 n={n}: p/m/v within rtol 2e-6 "
              f"(max_abs_err {worst:.3e})")
        del want
    km, pm, raw = timed_pair(
        lambda: FW.adamw_cuda(p, gr, m, v, 7, 3e-4, weight_decay=0.1),
        lambda: FW.adamw_plain(p, gr, m, v, 7, 3e-4, weight_decay=0.1))
    print(f"[kernels-train] K7 time n=124439808 fp32: kernel "
          f"{raw[0]:.4f}/{raw[1]:.4f} ms, plain {raw[2]:.4f}/{raw[3]:.4f} ms")
    res["adamw"] = dict(max_abs_err=worst, ms=km, plain_ms=pm,
                        shape="fp32 n=124439808, fp32 grads")
    return res


def _counters():
    from vitrs_tpu_torch.ops import flash_attention as FA
    from vitrs_tpu_torch.ops import fused_adamw as FW
    from vitrs_tpu_torch.ops import fused_ce as CE
    return {"flash_fwd": FA.flash_fwd_cuda, "flash_bwd": FA.flash_bwd_cuda,
            "ce_fwd": CE.ce_fwd_cuda, "ce_bwd": CE.ce_bwd_cuda,
            "adamw": FW.adamw_cuda}


def reset_counts():
    for fn in _counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in _counters().items()}


def phase_train(smi, steps=12):
    """GPT-2 124M, full width and depth, through train/loop.train."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.train import loop
    cfg = get_config("gpt2-124m")
    check(P.num_parameters(cfg) == 124_439_808, "gpt2-124m parameter count")
    B = 8
    with tempfile.TemporaryDirectory() as work:
        tc = loop.TrainConfig(preset="gpt2-124m", dataset="", steps=steps,
                              batch_size=B, lr=6e-4, warmup=2, min_lr=6e-5,
                              weight_decay=0.1, dtype="bfloat16", log_every=1,
                              ckpt_every=0, workdir=work, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        summary = loop.train(tc)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(work, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
    L = cfg.num_layers
    want = {"flash_fwd": L * steps, "flash_bwd": L * steps, "ce_fwd": steps,
            "ce_bwd": steps, "adamw": steps}
    check(counts == want, f"train launches {counts} != designed {want}")
    losses = [r["loss"] for r in recs]
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"train losses {losses}")
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    steady = recs[2:]                     # steps 1-2: warm-up (cuBLAS, allocator)
    tok_s = float(np.median([r["tok_per_sec"] for r in steady]))
    mfu = float(np.median([r["mfu"] for r in steady]))
    step_ms = B * cfg.max_seq_len / tok_s * 1e3
    print(f"[train] gpt2-124m bf16/fp32-master B={B} T=1024 {steps} steps: "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    print(f"[train] losses {losses}")
    print(f"[train] launches per step: flash_fwd {counts['flash_fwd'] // steps}, "
          f"flash_bwd {counts['flash_bwd'] // steps} (3 kernels each), "
          f"ce_fwd/ce_bwd/adamw 1")
    print(f"[train] steady (steps 3-{steps}, median): {step_ms:.2f} ms/step, "
          f"{tok_s:.1f} tok/s, MFU {mfu:.4f} of 989 TFLOP/s; "
          f"max_memory_allocated {peak / 2**30:.3f} GiB; wall {wall:.1f} s "
          f"incl. init and final checkpoint  ({smi})")
    print(f"[train] per-step tok/s {[r['tok_per_sec'] for r in recs]}")
    return counts, dict(step_ms=step_ms, tok_s=tok_s, mfu=mfu,
                        peak_gib=peak / 2**30, final_loss=summary["final_loss"])


def phase_xdevice_train():
    """One training step of a small fp32 model (D=64: flash route; vocab
    16500 over 128 rows: fused CE route) on CUDA with the kernels and on the
    CPU with the plain versions, from the same weights and tokens.
    Tolerances (TF32 off, fp32 sums in other orders): loss rtol 1e-5; grads
    rtol 1e-4 + atol 1e-6, qkvb atol 2e-4 (its K third's gradient is exactly
    0, so both hold fp32 noise); params after the AdamW step rtol 2e-5 +
    atol 1e-6, or atol lr where |grad| < 1e-6 (AdamW from zero state moves
    such a value by lr g / (|g| + eps), which magnifies noise)."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.models import model as M
    from vitrs_tpu_torch.parallel import data_parallel as dp
    cfg = get_config("gpt-nano").replace(num_layers=2, num_heads=2,
                                         channels=128, max_seq_len=64,
                                         vocab_size=16500)
    params = P.init_params(cfg, torch.Generator().manual_seed(3))
    rng = np.random.default_rng(3)
    x = rng.integers(0, cfg.vocab_size, (2, 64))
    y = rng.integers(0, cfg.vocab_size, (2, 64))
    lr = 1e-3
    out = {}
    for dev in ("cuda", "cpu"):
        reset_counts()
        leaves = {k: v.to(dev).requires_grad_(True) for k, v in params.items()}
        loss = M.loss_fn(leaves, torch.as_tensor(x, device=dev),
                         torch.as_tensor(y, device=dev), cfg)
        loss.backward()
        flat = P.flatten_params(params, cfg).to(dev)
        mesh = dp.make_mesh(devices=[dev])
        m, v = dp.init_sharded_opt_state(cfg, mesh)
        step = dp.make_dp_train_step(cfg, mesh, clip_norm=1.0)
        new, _, _, step_loss = step(P.unflatten_params(flat, cfg), m, v, x, y,
                                     1, lr, 0.1)
        out[dev] = (loss.item(), {k: t.grad.cpu() for k, t in leaves.items()},
                    {k: t.detach().cpu() for k, t in new.items()},
                    step_loss.item(), read_counts())
    L = cfg.num_layers
    check(out["cuda"][4] == {"flash_fwd": 2 * L, "flash_bwd": 2 * L,
                             "ce_fwd": 2, "ce_bwd": 2, "adamw": 1},
          f"xdevice-train: CUDA launches {out['cuda'][4]}")
    check(not any(out["cpu"][4].values()), "xdevice-train: a kernel ran on CPU")
    (lc, gc, pc, sc, _), (lp, gp, pp, sp, _) = out["cuda"], out["cpu"]
    check(abs(lc - lp) <= 1e-5 * abs(lp) and abs(sc - sp) <= 1e-5 * abs(sp),
          f"xdevice-train: loss {lc} vs {lp}")
    gerr = perr = 0.0
    for k in gp:
        atol = 2e-4 if k == "qkvb" else 1e-6
        d = (gc[k] - gp[k]).abs()
        check(bool((d <= atol + 1e-4 * gp[k].abs()).all()),
              f"xdevice-train: grad {k} max err {d.max().item()}")
        gerr = max(gerr, d.max().item())
        tol = torch.where(gp[k].abs() < 1e-6, torch.full_like(gp[k], lr),
                          1e-6 + 2e-5 * pp[k].abs())
        d = (pc[k] - pp[k]).abs()
        check(bool((d <= tol).all()),
              f"xdevice-train: param {k} max err {d.max().item()}")
        perr = max(perr, d.max().item())
    print(f"[xdevice-train] fp32 L=2 C=128 V=16500: loss {lc:.6f} (cuda) vs "
          f"{lp:.6f} (cpu); 16 grads max_abs_err {gerr:.3e}; params after "
          f"one AdamW step max_abs_err {perr:.3e}")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch sees no CUDA device")
    import vitrs_tpu_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    err, times = phase_kernels()
    serve_launches, prefill_ms, tok_s = phase_serve(smi)
    phase_xdevice()
    ktrain = phase_kernels_train()
    counts, train = phase_train(smi)
    phase_xdevice_train()
    kernel_ms, plain_ms = times[1024]
    fa = "vitrs_tpu/ops/flash_attention.py:"
    kernels = [
        dict(name="flash_fwd", route="cuda", source=CSRC + "flash_fwd.cu",
             replaces=fa + "567", also_replaces=[fa + "374"],
             launches=counts["flash_fwd"], serve_launches=serve_launches,
             max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
             shape="bf16 B=8 T=1024 NH=12 D=64 causal",
             prefill_ms=prefill_ms, decode_tok_s=tok_s),
        dict(name="flash_bwd", route="cuda", source=CSRC + "flash_bwd.cu",
             replaces=fa + "844", also_replaces=[fa + "986", fa + "901",
                                                 fa + "418"],
             launches=counts["flash_bwd"], kernels_per_launch=3,
             **ktrain["flash_bwd"]),
        dict(name="ce_fwd", route="cuda", source=CSRC + "fused_ce.cu",
             replaces="vitrs_tpu/ops/fused_ce.py:69",
             launches=counts["ce_fwd"], **ktrain["ce_fwd"]),
        dict(name="ce_bwd", route="cuda", source=CSRC + "fused_ce.cu",
             replaces="vitrs_tpu/ops/fused_ce.py:109",
             launches=counts["ce_bwd"], **ktrain["ce_bwd"]),
        dict(name="adamw", route="cuda", source=CSRC + "fused_adamw.cu",
             replaces="vitrs_tpu/ops/fused_adamw.py:28",
             launches=counts["adamw"], **ktrain["adamw"]),
    ]
    kernels[0]["train"] = train
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
