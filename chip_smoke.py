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
  8. kernels-gqa    K3-fwd and K3-bwd (GQA at kv width) against their plain
                    versions, NH=12, KH in {4, 1}, then times at the GQA
                    training shape.
  9. kernels-prefill K4 (continuation prefill) against its plain version
                    over an 8K cache whose tail past the chunk's frontier
                    is NaN, then times at the last chunk of an 8K prompt.
 10. train-gqa      GPT-2 124M with 4 kv heads (114,990,336 parameters),
                    full width and depth, through train/loop.train as in 6:
                    K3 instead of K1/K2 in every layer.
 11. serve-gqa      GPT-2 124M kv=4 at max_seq_len 8192, B=8, a 7680-token
                    prompt, greedy: chunked prefill (512: one K3-fwd chunk,
                    14 K4 chunks) and whole-prompt prefill, each for 1 and
                    128 new tokens; then an MHA chunked prefill (K1 + K4).
 12. xdevice-gqa    a small fp32 GQA model (NH=4, KH=2, D=64): one training
                    step and a chunked generate on CUDA (kernels) and on the
                    CPU (plain versions) agree.

Every kernel also gets a bound (the least time the card could take: the
larger of its operations over the card's peak for their type and its bytes
over the memory rate, counted for this run's inputs) and, where one
PyTorch call computes the same function, that call's time as a yardstick.
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
# NVIDIA H100 SXM peaks (data sheet, dense): bf16 tensor cores, fp32
# outside them, device memory
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
HBM_BYTES_S = 3.35e12
NH, D, C = 12, 64, 768           # GPT-2 124M attention geometry


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


def bound(flops, kind, nbytes):
    """(bound_ms, bound_by): the larger of flops over the card's peak for
    their type and nbytes over its memory rate."""
    ops_ms = flops / PEAK_FLOPS[kind] * 1e3
    mem_ms = nbytes / HBM_BYTES_S * 1e3
    return (ops_ms, "operations") if ops_ms >= mem_ms else (mem_ms, "bytes")


def attn_pairs(tq, q_off, keys, causal):
    """(query, key) pairs attention computes: each of tq rows at positions
    q_off.. sees its causal prefix, or all `keys`."""
    if not causal:
        return tq * keys
    return sum(min(q_off + i + 1, keys) for i in range(tq))


def attn_fwd_bound(B, tq, q_off, keys, kh, es, causal=True):
    """Bound of a flash forward: 2 products of 2*D flops per pair on the
    tensor cores; reads q and the k/v rows it needs, writes out and lse."""
    flops = 4 * B * NH * D * attn_pairs(tq, q_off, keys, causal)
    kv_rows = min(q_off + tq, keys) if causal else keys
    nbytes = (2 * B * tq * C * es + 2 * B * kv_rows * kh * D * es
              + B * NH * tq * 4)
    return bound(flops, "bf16" if es == 2 else "fp32", nbytes)


def attn_bwd_bound(B, T, kh, es):
    """Bound of a causal flash backward: 5 products per pair (s, dp, dv, dk,
    dq); reads q, k, v, out, do and lse, writes dq, dk, dv."""
    flops = 10 * B * NH * D * attn_pairs(T, 0, T, True)
    nbytes = 4 * B * T * C * es + 4 * B * T * kh * D * es + B * NH * T * 4
    return bound(flops, "bf16" if es == 2 else "fp32", nbytes)


def out_errors(got, want):
    """(elements beyond tolerance, max_abs_err, rms of want) of a flash
    forward's output (K1-fwd, K3-fwd, K4: one kernel) against its plain
    version.
      bf16: |d| <= 2^-7 max(|got|, |want|) + 2^-6 rms(want).  Each side
            rounds one fp32 result to bf16, and ulp(x) <= 2^-7 |x|.  Before
            that, p rounds to bf16 against the kernel's running max but the
            plain version's final max: relative errors of 2^-9 per term,
            whose weighted sum over a row's keys stays near 2^-9 of the
            output's rms.  The rms term follows the output's own size
            (about 3e-4 at 7K keys), so a dropped kv tile or a frontier
            moved by a few keys, which move the output by percents of its
            rms, fail.
      fp32: 1e-5 abs + rel (only the summation order differs)."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    rms = w.square().mean().sqrt().item()
    if got.dtype == torch.bfloat16:
        lim = 2.0 ** -7 * torch.maximum(g.abs(), w.abs()) + 2.0 ** -6 * rms
    else:
        lim = 1e-5 + 1e-5 * w.abs()
    return (d > lim).sum().item(), d.max().item(), rms


def heads(t, h):
    """(B, T, h*D) -> (B, h, T, D) view, the layout of PyTorch's SDPA."""
    return t.unflatten(-1, (h, D)).transpose(1, 2)


def sdpa_fwd(q, k, v, kh, mask=None):
    """One PyTorch call computing the flash forward (a yardstick only)."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(
        heads(q, NH), heads(k, kh), heads(v, kh), attn_mask=mask,
        is_causal=mask is None, enable_gqa=kh != NH)


def sdpa_bwd(q, k, v, do, kh):
    """A closure running the backward of `sdpa_fwd` (a yardstick only)."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = sdpa_fwd(*leaves, kh)
    dout = heads(do, NH)
    return lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)


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
    one q tile, several, and ragged ends.  Tolerances: out as
    `out_errors`; lse 1e-4 bf16, 1e-5 fp32 (both sum the same fp32 p, in
    another order)."""
    from vitrs_tpu_torch.ops.flash_attention import flash_fwd_cuda, flash_fwd_plain
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {}
    for dtype, lse_tol in ((torch.bfloat16, 1e-4), (torch.float32, 1e-5)):
        for T in (37, 128, 512, 1000, 1024):
            qkv = torch.randn(4, T, 3 * C, generator=gen, device="cuda").to(dtype)
            q, k, v = qkv.split(C, dim=-1)
            out, lse = flash_fwd_cuda(q, k, v, NH, True, 0.125)
            ref, ref_lse = flash_fwd_plain(q, k, v, NH, True, 0.125)
            torch.cuda.synchronize()
            bad, err, rms = out_errors(out, ref)
            lse_err = (lse - ref_lse).abs().max().item()
            print(f"[kernels] {str(dtype)[6:]:8s} T={T:4d} out max_abs_err "
                  f"{err:.3e} (rms {rms:.3e}) lse max_abs_err {lse_err:.3e}")
            check(torch.isfinite(out).all().item(), f"non-finite out at T={T}")
            check(bad == 0, f"{dtype} T={T}: {bad} out elements beyond "
                  f"tolerance")
            check(lse_err <= lse_tol, f"{dtype} T={T}: lse err {lse_err}")
            worst[dtype] = max(worst.get(dtype, 0.0), err)
    times = {}
    for T in (128, 512, 1024):
        qkv = torch.randn(8, T, 3 * C, generator=gen, device="cuda").to(torch.bfloat16)
        q, k, v = qkv.split(C, dim=-1)
        # plain, kernel, kernel, plain: the halves of each pair see the same card
        p1 = cuda_ms(lambda: flash_fwd_plain(q, k, v, NH, True, 0.125))
        k1 = cuda_ms(lambda: flash_fwd_cuda(q, k, v, NH, True, 0.125))
        k2 = cuda_ms(lambda: flash_fwd_cuda(q, k, v, NH, True, 0.125))
        p2 = cuda_ms(lambda: flash_fwd_plain(q, k, v, NH, True, 0.125))
        lib = cuda_ms(lambda: sdpa_fwd(q, k, v, NH))
        times[T] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                        library_ms=lib)
        print(f"[kernels] time bf16 B=8 T={T:4d} NH=12 causal: kernel "
              f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, "
              f"SDPA {lib:.4f} ms")
    bound_ms, by = attn_fwd_bound(8, 1024, 0, 1024, NH, 2)
    res = dict(max_abs_err=worst[torch.bfloat16], **times[1024],
               bound_ms=bound_ms, bound_by=by,
               shape="bf16 B=8 T=1024 NH=12 D=64 causal")
    print(f"[kernels] K1-fwd bound {bound_ms:.4f} ms ({by})")
    return res


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
    import torch.nn.functional as F
    res = {}
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
    lib = cuda_ms(sdpa_bwd(q, k, v, do, NH))
    bms, by = attn_bwd_bound(8, 1024, NH, 2)
    print(f"[kernels-train] K2 time bf16 B=8 T=1024 NH=12 causal: kernel "
          f"{raw[0]:.4f}/{raw[1]:.4f} ms, plain {raw[2]:.4f}/{raw[3]:.4f} ms, "
          f"SDPA backward {lib:.4f} ms, bound {bms:.4f} ms ({by})")
    res["flash_bwd"] = dict(max_abs_err=worst, ms=km, plain_ms=pm,
                            bound_ms=bms, bound_by=by, library_ms=lib,
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
    # the real V columns are read (pad columns are masked), targets int64;
    # about 4 fp32 operations per logit (max, subtract, exp, add)
    lib = cuda_ms(lambda: F.cross_entropy(logits[:, :V], targets,
                                          reduction="none"))
    bms, by = bound(4 * R * V, "fp32", R * V * 2 + R * 8 + 2 * R * 4)
    print(f"[kernels-train] K5 time: kernel {raw[0]:.4f}/{raw[1]:.4f} ms, "
          f"plain {raw[2]:.4f}/{raw[3]:.4f} ms, F.cross_entropy {lib:.4f} ms, "
          f"bound {bms:.4f} ms ({by})")
    shape = f"bf16 R={R} Vp={Vp} real_vocab={V}"
    res["ce_fwd"] = dict(max_abs_err=lse_err, ms=km, plain_ms=pm,
                         bound_ms=bms, bound_by=by, library_ms=lib,
                         shape=shape)
    km, pm, raw = timed_pair(lambda: CE.ce_bwd_cuda(logits, targets, lse, g, V),
                             lambda: CE.ce_bwd_plain(logits, targets, lse, g, V))
    # reads the real columns, lse, g and targets, writes all Vp columns;
    # about 5 fp32 operations per logit; no single PyTorch call computes it
    bms, by = bound(5 * R * V, "fp32", R * V * 2 + R * Vp * 2 + R * 16)
    print(f"[kernels-train] K6 time: kernel {raw[0]:.4f}/{raw[1]:.4f} ms, "
          f"plain {raw[2]:.4f}/{raw[3]:.4f} ms, bound {bms:.4f} ms ({by})")
    res["ce_bwd"] = dict(max_abs_err=derr.max().item(), ms=km, plain_ms=pm,
                         bound_ms=bms, bound_by=by, library_ms=None,
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
    leaf = p.detach().clone().requires_grad_(True)
    leaf.grad = gr
    lib_opt = torch.optim.AdamW([leaf], lr=3e-4, weight_decay=0.1, fused=True)
    lib = cuda_ms(lib_opt.step)
    del lib_opt, leaf
    # reads p, g, m, v and writes p, m, v in fp32; about 16 operations each
    n = p.numel()
    bms, by = bound(16 * n, "fp32", 28 * n)
    print(f"[kernels-train] K7 time n=124439808 fp32: kernel "
          f"{raw[0]:.4f}/{raw[1]:.4f} ms, plain {raw[2]:.4f}/{raw[3]:.4f} ms, "
          f"AdamW(fused=True).step {lib:.4f} ms, bound {bms:.4f} ms ({by})")
    res["adamw"] = dict(max_abs_err=worst, ms=km, plain_ms=pm, bound_ms=bms,
                        bound_by=by, library_ms=lib,
                        shape="fp32 n=124439808, fp32 grads")
    return res


def _counters():
    from vitrs_tpu_torch.ops import flash_attention as FA
    from vitrs_tpu_torch.ops import flash_attention_gqa as FG
    from vitrs_tpu_torch.ops import flash_prefill as FP
    from vitrs_tpu_torch.ops import fused_adamw as FW
    from vitrs_tpu_torch.ops import fused_ce as CE
    return {"flash_fwd": FA.flash_fwd_cuda, "flash_bwd": FA.flash_bwd_cuda,
            "flash_gqa_fwd": FG.flash_gqa_fwd_cuda,
            "flash_gqa_bwd": FG.flash_gqa_bwd_cuda,
            "flash_prefill": FP.flash_prefill_cuda,
            "ce_fwd": CE.ce_fwd_cuda, "ce_bwd": CE.ce_bwd_cuda,
            "adamw": FW.adamw_cuda}


def reset_counts():
    for fn in _counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in _counters().items()}


def designed(**counts):
    """Every kernel's launch count: the given ones, 0 for the rest."""
    want = dict.fromkeys(_counters(), 0)
    want.update(counts)
    return want


def phase_train(smi, steps=12, kv_heads=0):
    """GPT-2 124M, full width and depth, through train/loop.train; with
    kv_heads, its GQA variant through K3."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.train import loop
    tag = "[train-gqa]" if kv_heads else "[train]"
    cfg = get_config("gpt2-124m", num_kv_heads=kv_heads)
    n_params = 114_990_336 if kv_heads == 4 else 124_439_808
    check(P.num_parameters(cfg) == n_params, f"{tag} parameter count")
    B = 8
    with tempfile.TemporaryDirectory() as work:
        tc = loop.TrainConfig(preset="gpt2-124m", dataset="", steps=steps,
                              batch_size=B, lr=6e-4, warmup=2, min_lr=6e-5,
                              weight_decay=0.1, dtype="bfloat16", log_every=1,
                              ckpt_every=0, workdir=work,
                              kv_heads=kv_heads, device="cuda")
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
    fwd, bwd = (("flash_gqa_fwd", "flash_gqa_bwd") if kv_heads
                else ("flash_fwd", "flash_bwd"))
    want = designed(**{fwd: L * steps, bwd: L * steps}, ce_fwd=steps,
                    ce_bwd=steps, adamw=steps)
    check(counts == want, f"{tag} launches {counts} != designed {want}")
    losses = [r["loss"] for r in recs]
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"{tag} losses {losses}")
    check(losses[-1] < losses[0], f"{tag} loss did not fall: {losses}")
    steady = recs[2:]                     # steps 1-2: warm-up (cuBLAS, allocator)
    tok_s = float(np.median([r["tok_per_sec"] for r in steady]))
    mfu = float(np.median([r["mfu"] for r in steady]))
    step_ms = B * cfg.max_seq_len / tok_s * 1e3
    print(f"{tag} gpt2-124m kv_heads={cfg.kv_heads} ({n_params} params) "
          f"bf16/fp32-master B={B} T=1024 {steps} steps: "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    print(f"{tag} losses {losses}")
    print(f"{tag} launches per step: {fwd} {counts[fwd] // steps}, "
          f"{bwd} {counts[bwd] // steps} (3 kernels each), "
          f"ce_fwd/ce_bwd/adamw 1, every other kernel 0")
    print(f"{tag} steady (steps 3-{steps}, median): {step_ms:.2f} ms/step, "
          f"{tok_s:.1f} tok/s, MFU {mfu:.4f} of 989 TFLOP/s; "
          f"max_memory_allocated {peak / 2**30:.3f} GiB; wall {wall:.1f} s "
          f"incl. init and final checkpoint  ({smi})")
    print(f"{tag} per-step tok/s {[r['tok_per_sec'] for r in recs]}")
    return counts, dict(step_ms=step_ms, tok_s=tok_s, mfu=mfu,
                        peak_gib=peak / 2**30, final_loss=summary["final_loss"])


def phase_xdevice_train(cfg=None, tag="xdevice-train"):
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
    if cfg is None:
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
    fwd, bwd = (("flash_gqa_fwd", "flash_gqa_bwd") if cfg.is_gqa
                else ("flash_fwd", "flash_bwd"))
    want = designed(**{fwd: 2 * L, bwd: 2 * L}, ce_fwd=2, ce_bwd=2, adamw=1)
    check(out["cuda"][4] == want, f"{tag}: CUDA launches {out['cuda'][4]}")
    check(not any(out["cpu"][4].values()), f"{tag}: a kernel ran on CPU")
    (lc, gc, pc, sc, _), (lp, gp, pp, sp, _) = out["cuda"], out["cpu"]
    check(abs(lc - lp) <= 1e-5 * abs(lp) and abs(sc - sp) <= 1e-5 * abs(sp),
          f"{tag}: loss {lc} vs {lp}")
    gerr = perr = 0.0
    for k in gp:
        atol = 2e-4 if k == "qkvb" else 1e-6
        d = (gc[k] - gp[k]).abs()
        check(bool((d <= atol + 1e-4 * gp[k].abs()).all()),
              f"{tag}: grad {k} max err {d.max().item()}")
        gerr = max(gerr, d.max().item())
        tol = torch.where(gp[k].abs() < 1e-6, torch.full_like(gp[k], lr),
                          1e-6 + 2e-5 * pp[k].abs())
        d = (pc[k] - pp[k]).abs()
        check(bool((d <= tol).all()),
              f"{tag}: param {k} max err {d.max().item()}")
        perr = max(perr, d.max().item())
    print(f"[{tag}] fp32 L=2 NH={cfg.num_heads} KH={cfg.kv_heads} "
          f"C={cfg.channels} V={cfg.vocab_size}: loss {lc:.6f} (cuda) vs "
          f"{lp:.6f} (cpu); 16 grads max_abs_err {gerr:.3e}; params after "
          f"one AdamW step max_abs_err {perr:.3e}")


def phase_kernels_gqa():
    """K3-fwd and K3-bwd against their plain versions at NH=12, KH in
    {4, 1} (R = 3 and MQA), T in {37, 512, 1000, 1024}, causal and full,
    then times at the GQA training shape (bf16 B=8 T=1024 KH=4 causal).
    Tolerances as K1/K2: out as `out_errors`, lse 1e-4 bf16 and 1e-5
    fp32; grads 2e-2 abs + rel bf16, 1e-4 fp32 (dk/dv sum up to 12 heads'
    fp32 terms in another order)."""
    from vitrs_tpu_torch.ops import flash_attention_gqa as FG
    gen = torch.Generator(device="cuda").manual_seed(4)
    tols = {torch.bfloat16: (1e-4, 2e-2), torch.float32: (1e-5, 1e-4)}
    worst = {"fwd": 0.0, "bwd": 0.0}
    for dtype, (lse_tol, bwd_tol) in tols.items():
        for KH in (4, 1):
            for T in (37, 512, 1000, 1024):
                for causal in (True, False):
                    qkv = torch.randn(4, T, C + 2 * KH * D, generator=gen,
                                      device="cuda").to(dtype)
                    do = torch.randn(4, T, C, generator=gen,
                                     device="cuda").to(dtype)
                    q, k, v = FG.split_gqa(qkv, NH, KH)
                    args = (NH, KH, causal, 0.125)
                    out, lse = FG.flash_gqa_fwd_cuda(q, k, v, *args)
                    ref, ref_lse = FG.flash_gqa_fwd_plain(q, k, v, *args)
                    got = FG.flash_gqa_bwd_cuda(q, k, v, out, lse, do, *args)
                    want = FG.flash_gqa_bwd_plain(q, k, v, out, lse, do, *args)
                    torch.cuda.synchronize()
                    where = f"K3 {dtype} KH={KH} T={T} causal={causal}"
                    check(torch.isfinite(out).all().item(),
                          f"{where}: out non-finite")
                    bad, err, rms = out_errors(out, ref)
                    check(bad == 0, f"{where}: {bad} out values beyond "
                          f"tolerance")
                    errs = [err]
                    for name, a, b in (("dq", got[0], want[0]),
                                       ("dk", got[1], want[1]),
                                       ("dv", got[2], want[2])):
                        check(torch.isfinite(a).all().item(),
                              f"{where}: {name} non-finite")
                        d = (a.float() - b.float()).abs()
                        bad = (d > bwd_tol + bwd_tol * b.float().abs()).sum().item()
                        check(bad == 0, f"{where}: {bad} {name} values beyond "
                              f"{bwd_tol}")
                        errs.append(d.max().item())
                    lse_err = (lse - ref_lse).abs().max().item()
                    check(lse_err <= lse_tol, f"{where}: lse err {lse_err}")
                    print(f"[kernels-gqa] {str(dtype)[6:]:8s} KH={KH} "
                          f"T={T:4d} causal={int(causal)} max_abs_err out "
                          f"{errs[0]:.3e} (rms {rms:.3e}) lse {lse_err:.3e} "
                          f"dq/dk/dv {errs[1]:.3e}/{errs[2]:.3e}/{errs[3]:.3e}")
                    if dtype == torch.bfloat16:
                        worst["fwd"] = max(worst["fwd"], errs[0])
                        worst["bwd"] = max(worst["bwd"], *errs[1:])
    KH = 4
    qkv = torch.randn(8, 1024, C + 2 * KH * D, generator=gen,
                      device="cuda").to(torch.bfloat16)
    do = torch.randn(8, 1024, C, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = FG.split_gqa(qkv, NH, KH)
    args = (NH, KH, True, 0.125)
    out, lse = FG.flash_gqa_fwd_cuda(q, k, v, *args)
    res = {}
    shape = "bf16 B=8 T=1024 NH=12 KH=4 D=64 causal"
    for name, kernel, plain, lib, bnd in (
            ("flash_gqa_fwd", lambda: FG.flash_gqa_fwd_cuda(q, k, v, *args),
             lambda: FG.flash_gqa_fwd_plain(q, k, v, *args),
             lambda: sdpa_fwd(q, k, v, KH),
             attn_fwd_bound(8, 1024, 0, 1024, KH, 2)),
            ("flash_gqa_bwd",
             lambda: FG.flash_gqa_bwd_cuda(q, k, v, out, lse, do, *args),
             lambda: FG.flash_gqa_bwd_plain(q, k, v, out, lse, do, *args),
             sdpa_bwd(q, k, v, do, KH), attn_bwd_bound(8, 1024, KH, 2))):
        km, pm, raw = timed_pair(kernel, plain)
        lib_ms = cuda_ms(lib)
        print(f"[kernels-gqa] {name} time {shape}: kernel {raw[0]:.4f}/"
              f"{raw[1]:.4f} ms, plain {raw[2]:.4f}/{raw[3]:.4f} ms, SDPA "
              f"(enable_gqa) {lib_ms:.4f} ms, bound {bnd[0]:.4f} ms "
              f"({bnd[1]})")
        res[name] = dict(max_abs_err=worst[name[-3:]], ms=km, plain_ms=pm,
                         bound_ms=bnd[0], bound_by=bnd[1], library_ms=lib_ms,
                         shape=shape)
    return res


def phase_kernels_prefill():
    """K4 against its plain version: B=8, S=512, q_offset in {512, 3584,
    7168}, an 8K cache of 7936 slots (7808 rounded up to 256), KH in {4, 12},
    with every slot past the chunk's frontier NaN; tolerance as
    `out_errors` (in bf16 about 3e-4 + 2^-7 |out| at q_offset 7168, where
    |out| is about 0.02).  Then times at the last chunk of a 7680-token
    prompt (q_offset 7168, KH=4)."""
    from vitrs_tpu_torch.ops import flash_prefill as FP
    gen = torch.Generator(device="cuda").manual_seed(5)
    B, S, Tk = 8, 512, 7936
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for KH in (4, 12):
            for q_off in (512, 3584, 7168):
                q = torch.randn(B, S, C, generator=gen, device="cuda").to(dtype)
                k, v = (torch.randn(B, Tk, KH * D, generator=gen,
                                    device="cuda").to(dtype) for _ in range(2))
                k[:, q_off + S:] = float("nan")
                v[:, q_off + S:] = float("nan")
                got = FP.flash_prefill_cuda(q, k, v, NH, KH, q_off, 0.125)
                want = FP.flash_prefill_plain(q, k, v, NH, KH, q_off, 0.125)
                torch.cuda.synchronize()
                check(torch.isfinite(got).all().item(),
                      f"K4 KH={KH} q_off={q_off}: non-finite out")
                bad, err, rms = out_errors(got, want)
                check(bad == 0, f"K4 {dtype} KH={KH} q_off={q_off}: {bad} "
                      f"values beyond tolerance")
                print(f"[kernels-prefill] {str(dtype)[6:]:8s} KH={KH:2d} "
                      f"S={S} q_off={q_off} Tk={Tk} (NaN tail): max_abs_err "
                      f"{err:.3e} (rms {rms:.3e})")
                if dtype == torch.bfloat16:
                    worst = max(worst, err)
                del q, k, v, got, want
    KH, q_off = 4, 7168
    q = torch.randn(B, S, C, generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(B, Tk, KH * D, generator=gen,
                        device="cuda").to(torch.bfloat16) for _ in range(2))
    front = q_off + S
    mask = (torch.arange(front, device="cuda")[None, :]
            <= q_off + torch.arange(S, device="cuda")[:, None])
    km, pm, raw = timed_pair(
        lambda: FP.flash_prefill_cuda(q, k, v, NH, KH, q_off, 0.125),
        lambda: FP.flash_prefill_plain(q, k, v, NH, KH, q_off, 0.125))
    lib = cuda_ms(lambda: sdpa_fwd(q, k[:, :front], v[:, :front], KH, mask))
    bms, by = attn_fwd_bound(B, S, q_off, Tk, KH, 2)
    shape = "bf16 B=8 S=512 q_off=7168 Tk=7936 NH=12 KH=4 D=64"
    print(f"[kernels-prefill] time {shape}: kernel {raw[0]:.4f}/{raw[1]:.4f}"
          f" ms, plain {raw[2]:.4f}/{raw[3]:.4f} ms, SDPA (mask, enable_gqa)"
          f" {lib:.4f} ms, bound {bms:.4f} ms ({by})")
    return dict(max_abs_err=worst, ms=km, plain_ms=pm, bound_ms=bms,
                bound_by=by, library_ms=lib, shape=shape)


def _prefill_logits(G, pp, prompt, cfg, chunk, cache_len):
    """Last-position logits of a prefill in chunks of `chunk` tokens (0:
    the whole prompt), as models/generate.generate runs it."""
    caches = G.init_kv_cache(cfg, prompt.shape[0], cache_len, device="cuda")
    T0 = prompt.shape[1]
    step = chunk or T0
    for off in range(0, T0, step):
        logits, caches = G.forward_with_cache(pp, prompt[:, off:off + step],
                                              caches, off, cfg,
                                              last_only=True)
    return logits[:, -1].float()


def phase_serve_gqa(smi):
    """The JAX package's long-context GQA serving row
    (benchmarks/gen_variants.py --mode gqa --prefill-chunk 512): gpt2-124m
    with 4 kv heads at max_seq_len 8192, seeded random weights, bf16, B=8,
    a 7680-token seeded prompt, greedy; chunked (512) and whole-prompt
    prefill, each for 1 new token (prefill ms) and 128 (tok/s with the
    prefill, ms per new token).  Chunked and whole last-position logits:
    each bf16 run is held against the fp32 whole-prompt prefill of the same
    weights, and the two bf16 runs against each other (see the check)."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.models import generate as G
    from vitrs_tpu_torch.models import model as M
    cfg = get_config("gpt2-124m", num_kv_heads=4, max_seq_len=8192,
                     dtype="bfloat16")
    check(P.num_parameters(cfg) == 120_495_360, "gpt2-124m kv=4 8K params")
    params = P.init_params(cfg, torch.Generator().manual_seed(0))
    params = {k: t.to("cuda") for k, t in params.items()}
    pp = M.prepare_params(params, cfg)
    B, T0, L = 8, 7680, cfg.num_layers
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, T0)), device="cuda")

    def run(chunk, max_new):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = G.generate(pp, prompt, cfg, max_new, temperature=0.0,
                         prefill_chunk=chunk)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check(out.shape == (B, T0 + max_new), f"serve-gqa shape {out.shape}")
        gen = out[:, T0:]
        check(bool(((gen >= 0) & (gen < cfg.vocab_size)).all()),
              "serve-gqa ids")
        return ms, read_counts()

    run(512, 2)                                # warm-up: cuBLAS, allocator
    run(0, 2)
    res = {}
    for chunk in (512, 0):
        ms1, c1 = run(chunk, 1)
        msn, cn = run(chunk, 128)
        want = designed(flash_gqa_fwd=L,
                        flash_prefill=L * (T0 // chunk - 1) if chunk else 0)
        check(c1 == want and cn == want,
              f"serve-gqa chunk {chunk}: launches {c1} / {cn} != {want}")
        per_tok = (msn - ms1) / 127
        res[chunk] = dict(prefill_ms=ms1, gen128_ms=msn,
                          tok_s=B * 128 / msn * 1e3, ms_per_new_token=per_tok,
                          launches=c1)
        print(f"[serve-gqa] chunk {chunk}: launches flash_gqa_fwd "
              f"{c1['flash_gqa_fwd']}, flash_prefill {c1['flash_prefill']}; "
              f"prefill (max_new=1) {ms1:.2f} ms; max_new=128 {msn:.2f} ms = "
              f"{B * 128 / msn * 1e3:.1f} tok/s incl. prefill, "
              f"{per_tok:.3f} ms per new token  ({smi})")
    chunked = _prefill_logits(G, pp, prompt, cfg, 512, 7936)
    whole = _prefill_logits(G, pp, prompt, cfg, 0, T0 + 1)
    cfg32 = cfg.replace(dtype="float32")
    ref = _prefill_logits(G, M.prepare_params(params, cfg32), prompt, cfg32,
                          0, T0 + 1)
    d_cw = (chunked - whole).abs().max().item()
    d_w = (whole - ref).abs().max().item()
    d_c = (chunked - ref).abs().max().item()
    check(all(torch.isfinite(t).all().item() for t in (chunked, whole, ref)),
          "serve-gqa: non-finite logits")
    # the last row's attention visits the same 64-key tiles in the same
    # order in K4 (chunk offsets are multiples of 64) as in K3-fwd, and the
    # other ops are row-wise, so on an H100 the two bf16 runs agree
    # bit for bit; 1e-3 (against logits up to about 2) leaves room for a
    # GEMM that picks another algorithm at another row count, and a wrong
    # chunk, mask or cache row moves logits by the bf16 run's own distance
    # from fp32 (about 3e-2) or more
    check(d_cw <= 1e-3, f"serve-gqa: chunked vs whole logits differ by "
          f"{d_cw}, bf16 vs fp32 by {d_w}")
    check(d_w <= 0.1, f"serve-gqa: bf16 vs fp32 logits differ by {d_w}")
    same = (chunked.argmax(-1) == whole.argmax(-1)).sum().item()
    print(f"[serve-gqa] last-position logits (max |logit| "
          f"{ref.abs().max().item():.3f}): chunked vs whole max_abs_err "
          f"{d_cw:.4e}; whole bf16 vs fp32 {d_w:.4e}; chunked bf16 vs fp32 "
          f"{d_c:.4e}; argmax equal in {same} of {B} rows")
    res["logits"] = dict(chunked_vs_whole=d_cw, whole_vs_fp32=d_w,
                         chunked_vs_fp32=d_c)
    del pp, params

    # MHA: K4 at KH = NH, the first chunk through K1-fwd
    mcfg = get_config("gpt2-124m", max_seq_len=4096, dtype="bfloat16")
    mp = M.prepare_params({k: t.to("cuda") for k, t in P.init_params(
        mcfg, torch.Generator().manual_seed(1)).items()}, mcfg)
    mprompt = torch.as_tensor(np.random.default_rng(1).integers(
        0, mcfg.vocab_size, (4, 3584)), device="cuda")
    times = []
    for _ in range(2):                          # warm-up, then timed
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = G.generate(mp, mprompt, mcfg, 1, temperature=0.0,
                         prefill_chunk=512)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts()
    want = designed(flash_fwd=L, flash_prefill=L * 6)
    check(counts == want, f"serve-mha chunked: launches {counts} != {want}")
    check(out.shape == (4, 3585), "serve-mha shape")
    print(f"[serve-gqa] MHA gpt2-124m B=4 3584-token prompt, chunk 512: "
          f"launches flash_fwd {counts['flash_fwd']}, flash_prefill "
          f"{counts['flash_prefill']}; prefill {times[1]:.2f} ms")
    res["mha_prefill_ms"] = times[1]
    return res


def phase_xdevice_gqa():
    """A small fp32 GQA model (L=2, NH=4, KH=2, C=256, D=64) on CUDA with
    the kernels and on the CPU with the plain versions: one training step
    (as xdevice-train), and a chunked generate (48-token prompt, chunk 16,
    8 new): the same greedy tokens, prefill logits within 1e-4, K3 and K4
    launched on CUDA only."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.models import generate as G
    from vitrs_tpu_torch.models import model as M
    cfg = get_config("gpt-nano").replace(num_layers=2, num_heads=4,
                                         num_kv_heads=2, channels=256,
                                         max_seq_len=64, vocab_size=16500)
    phase_xdevice_train(cfg, "xdevice-gqa")
    params = P.init_params(cfg, torch.Generator().manual_seed(6))
    prompt = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 48)))
    toks, logits = {}, {}
    for dev in ("cuda", "cpu"):
        pp = M.prepare_params({k: t.to(dev) for k, t in params.items()}, cfg)
        reset_counts()
        toks[dev] = G.generate(pp, prompt.to(dev), cfg, 8, temperature=0.0,
                               prefill_chunk=16).cpu()
        counts = read_counts()
        want = (designed(flash_gqa_fwd=2, flash_prefill=4) if dev == "cuda"
                else designed())
        check(counts == want, f"xdevice-gqa generate on {dev}: {counts}")
        caches = G.init_kv_cache(cfg, 2, 256, device=dev)
        for off in range(0, 48, 16):
            chunk = prompt[:, off:off + 16].to(dev)
            lg, caches = G.forward_with_cache(pp, chunk, caches, off, cfg)
        logits[dev] = lg.cpu()
    check(torch.equal(toks["cuda"], toks["cpu"]),
          "xdevice-gqa: chunked generate tokens differ")
    err = (logits["cuda"] - logits["cpu"]).abs().max().item()
    check(err <= 1e-4, f"xdevice-gqa: chunked prefill logits differ by {err}")
    print(f"[xdevice-gqa] fp32 chunked generate: tokens equal on cuda and "
          f"cpu; last-chunk logits max_abs_err {err:.3e}")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch sees no CUDA device")
    import vitrs_tpu_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    k1 = phase_kernels()
    serve_launches, prefill_ms, tok_s = phase_serve(smi)
    phase_xdevice()
    ktrain = phase_kernels_train()
    counts, train = phase_train(smi)
    phase_xdevice_train()
    kgqa = phase_kernels_gqa()
    kprefill = phase_kernels_prefill()
    gqa_counts, gqa_train = phase_train(smi, kv_heads=4)
    serve_gqa = phase_serve_gqa(smi)
    phase_xdevice_gqa()
    fa = "vitrs_tpu/ops/flash_attention.py:"
    fg = "vitrs_tpu/ops/flash_attention_gqa.py:"
    kernels = [
        dict(name="flash_fwd", route="cuda", source=CSRC + "flash_fwd.cu",
             replaces=fa + "567", also_replaces=[fa + "374"],
             launches=counts["flash_fwd"], serve_launches=serve_launches,
             **k1, prefill_ms=prefill_ms, decode_tok_s=tok_s),
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
        dict(name="flash_gqa_fwd", route="cuda", source=CSRC + "flash_fwd.cu",
             replaces=fg + "358", also_replaces=[fg + "262"],
             launches=gqa_counts["flash_gqa_fwd"],
             serve_launches=serve_gqa[512]["launches"]["flash_gqa_fwd"],
             **kgqa["flash_gqa_fwd"]),
        dict(name="flash_gqa_bwd", route="cuda", source=CSRC + "flash_bwd.cu",
             replaces=fg + "499", also_replaces=[fg + "538", fg + "470",
                                                 fg + "309"],
             launches=gqa_counts["flash_gqa_bwd"], kernels_per_launch=3,
             **kgqa["flash_gqa_bwd"]),
        dict(name="flash_prefill", route="cuda", source=CSRC + "flash_fwd.cu",
             replaces="vitrs_tpu/ops/flash_prefill.py:123",
             launches=serve_gqa[512]["launches"]["flash_prefill"],
             **kprefill, serve_gqa=serve_gqa),
    ]
    kernels[0]["train"] = train
    kernels[5]["train"] = gqa_train
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
