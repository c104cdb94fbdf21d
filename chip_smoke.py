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
                    training shapes; K2 also at ragged T (1 .. 1000 around
                    its 64-row tiles), sm_scale 1/8 and 0.1, twice with
                    bitwise equal results; then kernel and plain times, and
                    K2's registers, shared memory and TFLOP/s.
  6. train          GPT-2 124M at full width and depth (fp32 masters, bf16
                    compute, B=8, T=1024, the synthetic token stream) for
                    12 steps through train/loop.train: finite, falling loss;
                    every kernel launched on every step in the designed
                    counts (a K2 launch is one call that runs its three
                    kernels: pre-pass, dK/dV, dQ); step ms, tok/s, MFU and
                    peak memory.
  7. xdevice-train  one training step of a small fp32 model (D=64, fused CE
                    route) on CUDA with the kernels and on the CPU with the
                    plain versions, from the same weights and tokens: loss,
                    all 16 grads and the updated params agree.
  8. kernels-gqa    K3-fwd and K3-bwd (GQA at kv width) against their plain
                    versions, NH=12, KH in {4, 1}, K3-bwd also at K2's
                    ragged T, sm_scale and repeatability cases; then times
                    at the GQA training shape.
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
 13. kernels-rope-window  K1-fwd, K2 and K3 with rope and the sliding-window
                    band against their plain versions (W in {1, 63, 64, 65,
                    1024}, T in {1000, 8192}; band-edge inputs that a band
                    moved by one key fails), K1-fwd without rope at T=7680
                    and K4 with the band at q_offset 7168 at the serving
                    shapes, then times at T=8192, W=1024 beside the band-aware
                    bound and SDPA with a band mask; the windowed K2 must
                    take under half the full-causal K2's time; each
                    backward's TFLOP/s and resources.
 14. kernels-headce K8 (fused head + CE) against its plain version at
                    R in {8192, 16384}, then times; loss and gradients
                    through it against the two-op route (K5/K6).
 15. train-window   GPT-2 124M at T=8192 with window 1024 and rope
                    (129,944,832 parameters), B=2, 12 steps through
                    train/loop.train as in 6 (rope and the band inside K1-fwd
                    and K2); then the full-causal control (W=0).
 16. train-headce   phase 6's run with ops/fused_head_ce.ENABLE set: K8 in
                    place of K5, 12 launches in 12 steps.
 17. serve-window   the rope + window model at max_seq_len 8192, B=8, a
                    7680-token prompt: generate whole (K1-fwd with the band)
                    and in 512-token chunks (K4 with the band), last-position
                    logits within 1e-3; generate_streaming (ring cache) for
                    32 new tokens beside the dense-cache run.
 18. xdevice-window small fp32 rope + window models (kv 2 and 1): a training
                    step and a chunked generate on CUDA and on the CPU agree.

`python3 chip_smoke.py --phases a,b` runs only the named phases (after the
device phase) and prints no result lines.

Every kernel also gets a bound (the least time the card could take: the
larger of its operations over the card's peak for their type and its bytes
over the memory rate, counted for this run's inputs) and, where one
PyTorch call computes the same function, that call's time as a yardstick.
The line before the last is a JSON object describing the kernels; the last
is {"ok": true, "device": {...}}.  Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

CSRC = "vitrs_tpu_torch/csrc/"
LIBS = ("flash_fwd", "flash_bwd", "fused_ce", "fused_adamw", "fused_head_ce")
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


def attn_pairs(tq, q_off, keys, causal, window=0):
    """(query, key) pairs attention computes: each of tq rows at positions
    p = q_off.. sees its causal prefix, min(p + 1, window) keys under a
    sliding window, or all `keys`."""
    if not causal:
        return tq * keys
    return sum(min(q_off + i + 1, keys, window or keys) for i in range(tq))


def attn_fwd_bound(B, tq, q_off, keys, kh, es, causal=True, window=0,
                   rope=False):
    """Bound of a flash forward: 2 products of 2*D flops per pair on the
    tensor cores; reads q and the k/v rows it needs (from the first row the
    band reaches), and under rope the fp32 cos/sin rows of its positions;
    writes out and lse."""
    flops = 4 * B * NH * D * attn_pairs(tq, q_off, keys, causal, window)
    kv_rows = min(q_off + tq, keys) if causal else keys
    if causal and window:
        kv_rows -= max(0, q_off - window + 1)
    nbytes = (2 * B * tq * C * es + 2 * B * kv_rows * kh * D * es
              + B * NH * tq * 4 + (2 * (q_off + tq) * D * 4 if rope else 0))
    return bound(flops, "bf16" if es == 2 else "fp32", nbytes)


def bwd_flops(B, T, window=0):
    """Operations of a causal flash backward: 5 products of 2*D flops per
    (query, key) pair; the TFLOP/s each K2/K3-bwd time is printed with."""
    return 10 * B * NH * D * attn_pairs(T, 0, T, True, window)


def attn_bwd_bound(B, T, kh, es, window=0, rope=False):
    """Bound of a causal flash backward: 5 products per pair (s, dp, dv, dk,
    dq); reads q, k, v, out, do and lse (and the rope table), writes dq, dk,
    dv."""
    flops = bwd_flops(B, T, window)
    nbytes = (4 * B * T * C * es + 4 * B * T * kh * D * es + B * NH * T * 4
              + (2 * T * D * 4 if rope else 0))
    return bound(flops, "bf16" if es == 2 else "fp32", nbytes)


def bwd_resources(rope=False):
    """{kernel: registers per thread, spill bytes, shared memory per block,
    threads} of the bf16 K2/K3-bwd kernels as built (the pre-pass, dK/dV,
    dQ; csrc/flash_bwd.cu's vitrs_flash_bwd_attrs), at sm_scale 1/8."""
    import ctypes
    from vitrs_tpu_torch.ops import _build
    fn = _build.load("flash_bwd").lib.vitrs_flash_bwd_attrs
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    res = {}
    for i, name in enumerate(("prep", "dkv", "dq")):
        out = (ctypes.c_int * 5)()
        rc = fn(i, int(rope), 0, ctypes.cast(out, ctypes.c_void_p))
        check(rc == 0, f"vitrs_flash_bwd_attrs({name}): CUDA error {rc}")
        res[name] = dict(registers=out[0], spill_bytes=out[1],
                         smem_bytes=out[2] + out[3], threads=out[4])
    return res


def print_bwd_rate(tag, name, ms, flops, res):
    print(f"[{tag}] {name}: {flops / ms / 1e9:.1f} TFLOP/s on the five-product "
          f"count; " + "; ".join(
              f"{k} {v['registers']} registers, {v['spill_bytes']} B spilled, "
              f"{v['smem_bytes']} B shared, {v['threads']} threads"
              for k, v in res.items()))


def bwd_edge_cases(tag, KHs, gen):
    """K2 (KH = NH, flash_bwd_cuda) or K3-bwd (flash_gqa_bwd_cuda) in bf16
    against the plain version at T in {1, 63, 64, 65, 127, 128, 129, 1000}
    (around the 64-row tiles), causal and not, at sm_scale 1/8 (s scaled in
    fp32) and 0.1 (q^ from the pre-pass), and with rope and the band (W=65)
    at T=1000, sm_scale 0.1; 2e-2 abs + rel as every K2 check.  Each case
    runs twice, and the two results must be the same bits (no atomics).
    Returns the largest error."""
    from vitrs_tpu_torch.ops import flash_attention as FA
    from vitrs_tpu_torch.ops import flash_attention_gqa as FG
    cases = [(T, causal, scale, 0, False)
             for T in (1, 63, 64, 65, 127, 128, 129, 1000)
             for causal in (True, False) for scale in (0.125, 0.1)]
    cases.append((1000, True, 0.1, 65, True))
    worst = 0.0
    for KH in KHs:
        errs = []
        for T, causal, scale, W, rope in cases:
            q, do = (torch.randn(2, T, C, generator=gen, device="cuda").bfloat16()
                     for _ in range(2))
            k, v = (torch.randn(2, T, KH * D, generator=gen, device="cuda").bfloat16()
                    for _ in range(2))
            args = (NH, KH, causal, scale, W, rope)
            out, lse = FG.flash_gqa_fwd_plain(q, k, v, *args)
            if KH == NH:
                got, again = (FA.flash_bwd_cuda(q, k, v, out, lse, do, NH, causal,
                                                scale, W, rope) for _ in range(2))
            else:
                got, again = (FG.flash_gqa_bwd_cuda(q, k, v, out, lse, do, *args)
                              for _ in range(2))
            want = FG.flash_gqa_bwd_plain(q, k, v, out, lse, do, *args)
            torch.cuda.synchronize()
            where = (f"KH={KH} T={T} causal={int(causal)} sm_scale={scale} W={W} "
                     f"rope={int(rope)}")
            for name, a, b, c in zip(("dq", "dk", "dv"), got, again, want):
                check(torch.equal(a, b), f"{where}: {name} differs between two "
                      f"calls")
                d = (a.float() - c.float()).abs()
                bad = ((d > 2e-2 + 2e-2 * c.float().abs()).sum().item()
                       + (~torch.isfinite(a)).sum().item())
                check(bad == 0, f"{where}: {bad} {name} values beyond 2e-2")
                errs.append(d.max().item())
        worst = max(worst, *errs)
        print(f"[{tag}] KH={KH}: {len(cases)} ragged-T / sm_scale / rope cases "
              f"within 2e-2 (max_abs_err {max(errs):.3e}), each bitwise equal "
              f"over two calls")
    return worst


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


def sdpa_bwd(q, k, v, do, kh, mask=None):
    """A closure running the backward of `sdpa_fwd` (a yardstick only)."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = sdpa_fwd(*leaves, kh, mask)
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
            if any(w in line for w in ("registers", "spill", "Compiling", "wgmma")):
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



def timed_pair(kernel, plain, iters=20, warmup=3):
    """(kernel ms, plain ms): each the mean of two cuda_ms runs, in the
    order plain, kernel, kernel, plain, so both halves see the same card."""
    p1, k1, k2, p2 = (cuda_ms(f, iters, warmup)
                      for f in (plain, kernel, kernel, plain))
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
    worst = max(worst, bwd_edge_cases("kernels-train", (NH,), gen))
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
    rsc, flops = bwd_resources(), bwd_flops(8, 1024)
    print_bwd_rate("kernels-train", "K2", km, flops, rsc)
    res["flash_bwd"] = dict(max_abs_err=worst, ms=km, plain_ms=pm,
                            bound_ms=bms, bound_by=by, library_ms=lib,
                            tflops=flops / km / 1e9, resources=rsc,
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
    from vitrs_tpu_torch.ops import fused_head_ce as FH
    return {"flash_fwd": FA.flash_fwd_cuda, "flash_bwd": FA.flash_bwd_cuda,
            "flash_gqa_fwd": FG.flash_gqa_fwd_cuda,
            "flash_gqa_bwd": FG.flash_gqa_bwd_cuda,
            "flash_prefill": FP.flash_prefill_cuda,
            "ce_fwd": CE.ce_fwd_cuda, "ce_bwd": CE.ce_bwd_cuda,
            "adamw": FW.adamw_cuda, "head_ce_fwd": FH.head_ce_fwd_cuda}


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


def phase_train(smi, steps=12, kv_heads=0, overrides=None, B=8, tag=None,
                n_params=None, head_ce=False):
    """GPT-2 124M, full width and depth, through train/loop.train; with
    kv_heads, its GQA variant through K3; `overrides` are the TrainConfig's
    model_overrides (the long-context rope + window model); head_ce sets
    ops/fused_head_ce.ENABLE, so the loss runs through K8 (and K6) instead
    of K5/K6."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.ops import fused_head_ce as FH
    from vitrs_tpu_torch.train import loop
    tag = tag or ("[train-gqa]" if kv_heads else "[train]")
    overrides = dict(overrides or {})
    cfg = get_config("gpt2-124m", num_kv_heads=kv_heads, **overrides)
    n_params = n_params or (114_990_336 if kv_heads == 4 else 124_439_808)
    check(P.num_parameters(cfg) == n_params, f"{tag} parameter count")
    T = cfg.max_seq_len
    with tempfile.TemporaryDirectory() as work:
        tc = loop.TrainConfig(preset="gpt2-124m", dataset="", steps=steps,
                              batch_size=B, lr=6e-4, warmup=2, min_lr=6e-5,
                              weight_decay=0.1, dtype="bfloat16", log_every=1,
                              ckpt_every=0, workdir=work,
                              kv_heads=kv_heads, device="cuda",
                              model_overrides=overrides or None)
        torch.cuda.reset_peak_memory_stats()
        FH.ENABLE = head_ce
        reset_counts()
        t0 = time.perf_counter()
        try:
            summary = loop.train(tc)
            torch.cuda.synchronize()
        finally:
            FH.ENABLE = False
        wall = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(work, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
    L = cfg.num_layers
    fwd, bwd = (("flash_gqa_fwd", "flash_gqa_bwd") if kv_heads
                else ("flash_fwd", "flash_bwd"))
    loss_kernel = {"head_ce_fwd": steps} if head_ce else {"ce_fwd": steps}
    want = designed(**{fwd: L * steps, bwd: L * steps}, ce_bwd=steps,
                    adamw=steps, **loss_kernel)
    check(counts == want, f"{tag} launches {counts} != designed {want}")
    losses = [r["loss"] for r in recs]
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"{tag} losses {losses}")
    check(losses[-1] < losses[0], f"{tag} loss did not fall: {losses}")
    steady = recs[2:]                     # steps 1-2: warm-up (cuBLAS, allocator)
    tok_s = float(np.median([r["tok_per_sec"] for r in steady]))
    mfu = float(np.median([r["mfu"] for r in steady]))
    step_ms = B * T / tok_s * 1e3
    what = ", ".join(f"{k}={v}" for k, v in overrides.items())
    print(f"{tag} gpt2-124m kv_heads={cfg.kv_heads} {what} ({n_params} "
          f"params) bf16/fp32-master B={B} T={T} {steps} steps: "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    print(f"{tag} losses {losses}")
    print(f"{tag} launches per step: {fwd} {counts[fwd] // steps}, "
          f"{bwd} {counts[bwd] // steps} (3 kernels each), "
          f"{'head_ce_fwd' if head_ce else 'ce_fwd'}/ce_bwd/adamw 1, every "
          f"other kernel 0")
    print(f"{tag} steady (steps 3-{steps}, median): {step_ms:.2f} ms/step, "
          f"{tok_s:.1f} tok/s, MFU {mfu:.4f} of 989 TFLOP/s; "
          f"max_memory_allocated {peak / 2**30:.3f} GiB; wall {wall:.1f} s "
          f"incl. init and final checkpoint  ({smi})")
    print(f"{tag} per-step tok/s {[r['tok_per_sec'] for r in recs]}")
    return counts, dict(step_ms=step_ms, tok_s=tok_s, mfu=mfu,
                        peak_gib=peak / 2**30, final_loss=summary["final_loss"],
                        losses=losses)


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
        # a tensor the loss does not read (wpe under rope) has no gradient
        out[dev] = (loss.item(), {k: torch.zeros(t.shape) if t.grad is None
                                  else t.grad.cpu() for k, t in leaves.items()},
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
    return out["cuda"][4]


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
    worst["bwd"] = max(worst["bwd"], bwd_edge_cases("kernels-gqa", (4, 1), gen))
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
    rsc, flops = bwd_resources(), bwd_flops(8, 1024)
    print_bwd_rate("kernels-gqa", "K3-bwd", res["flash_gqa_bwd"]["ms"], flops, rsc)
    res["flash_gqa_bwd"].update(tflops=flops / res["flash_gqa_bwd"]["ms"] / 1e9,
                                resources=rsc)
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


# ---------------------------------------------------------------------------
# rope and the sliding window (K1-fwd, K2, K3, K4), and K8
# ---------------------------------------------------------------------------

EDGE_R2 = 12.0      # squared norm of each rotation pair of the band-edge q, k
EDGE_PAIRS = 12     # the rotation pairs they use: rope's 12 fastest


def band_edge_qk(B, S, Tk, nh, kh, window, q_off=0, rope=False,
                 device="cuda"):
    """q (B, S, nh*D) at positions q_off.. and k (B, Tk, kh*D) at 0.., fp32,
    whose scores peak at the lower edge of every query's band: pair i <
    EDGE_PAIRS of the rotated q and k gives EDGE_R2 cos(w_i (j - t - d0)),
    w_i rope's frequencies and d0 = 1/2 - window (the other pairs are 0),
    so the score of query t and key j is largest, and equal, at keys
    t - window + 1 (the band's last key) and t - window (the first key
    outside it), and at least 2 EDGE_R2 lower at every other key up to
    9000 away (3 after the 1/8 softmax scale; the peak is 17.6, so fp32
    scores keep most of their precision).  A band that ends one
    key early or late then moves the output by about |v|, where random
    inputs move it by about 1/window of its rms, below the bf16 bound
    (tests/test_torch_smoke_tolerance.py).  rope=True: q and k come
    unrotated (every row the same) for the kernels to rotate; else rotated
    at their positions."""
    from vitrs_tpu_torch.ops.rope import rope_table, rotate
    half = D // 2
    w = 10000.0 ** (-torch.arange(half, dtype=torch.float64) / half)
    d0 = 0.5 - window
    r = math.sqrt(EDGE_R2) * (torch.arange(half) < EDGE_PAIRS).double()
    a = torch.cat([r, torch.zeros(half, dtype=torch.float64)])
    b = torch.cat([r * torch.cos(w * d0), -r * torch.sin(w * d0)])
    q = a.float().repeat(nh).to(device).expand(B, S, -1)
    k = b.float().repeat(kh).to(device).expand(B, Tk, -1)
    if not rope:
        cos, sin = rope_table(max(q_off + S, Tk), D, device)
        q = rotate(q, cos[q_off:q_off + S], sin[q_off:q_off + S], nh)
        k = rotate(k, cos[:Tk], sin[:Tk], kh)
    return q.contiguous(), k.contiguous()


def band_mask(tq, q_off, keys, window, device="cuda"):
    """(tq, keys) bool, True where query row i sees key j: the explicit
    band PyTorch's SDPA takes."""
    rows = q_off + torch.arange(tq, device=device)[:, None]
    cols = torch.arange(keys, device=device)[None, :]
    return (cols <= rows) & (cols > rows - window)


def _attn_fns(kh):
    """(fwd kernel, fwd plain, bwd kernel, bwd plain) at kv width kh, each
    called as f(q, k, v, [out, lse, do,] causal, window, rope)."""
    from vitrs_tpu_torch.ops import flash_attention as FA
    from vitrs_tpu_torch.ops import flash_attention_gqa as FG
    if kh == NH:
        return (lambda q, k, v, c, w, r: FA.flash_fwd_cuda(q, k, v, NH, c, 0.125, w, r),
                lambda q, k, v, c, w, r: FA.flash_fwd_plain(q, k, v, NH, c, 0.125,
                                                            window=w, rope=r),
                lambda q, k, v, o, l, d, c, w, r: FA.flash_bwd_cuda(
                    q, k, v, o, l, d, NH, c, 0.125, w, r),
                lambda q, k, v, o, l, d, c, w, r: FA.flash_bwd_plain(
                    q, k, v, o, l, d, NH, c, 0.125, window=w, rope=r))
    return (lambda q, k, v, c, w, r: FG.flash_gqa_fwd_cuda(q, k, v, NH, kh, c, 0.125,
                                                           w, r),
            lambda q, k, v, c, w, r: FG.flash_gqa_fwd_plain(q, k, v, NH, kh, c, 0.125,
                                                            w, r),
            lambda q, k, v, o, l, d, c, w, r: FG.flash_gqa_bwd_cuda(
                q, k, v, o, l, d, NH, kh, c, 0.125, w, r),
            lambda q, k, v, o, l, d, c, w, r: FG.flash_gqa_bwd_plain(
                q, k, v, o, l, d, NH, kh, c, 0.125, w, r))


def _check_band_fwd(where, W, out, lse, ref, ref_lse, v, kh, lse_tol):
    """Holds a forward with window W (out, lse) to its plain version (ref,
    ref_lse): out as `out_errors` and, at W=1, equal to v; lse relative to
    max(1, |lse|).  Returns (max_abs_err, rms, lse_err)."""
    check(torch.isfinite(out).all().item(), f"{where}: out non-finite")
    bad, err, rms = out_errors(out, ref)
    check(bad == 0, f"{where}: {bad} out values beyond tolerance "
          f"(max_abs_err {err:.3e})")
    if W == 1:        # p = 1 on the query's own key
        B, T = v.shape[:2]
        own = v.unflatten(-1, (kh, 1, D)).expand(
            B, T, kh, NH // kh, D).reshape(B, T, C)
        check(torch.equal(out, own), f"{where}: out != v at W=1")
    lse_err = ((lse - ref_lse).abs()
               / ref_lse.abs().clamp_min(1.0)).max().item()
    check(lse_err <= lse_tol, f"{where}: lse err {lse_err}")
    return err, rms, lse_err


def phase_kernels_rope_window():
    """K1-fwd and K2 (MHA), K3-fwd and K3-bwd (KH in {4, 1}) with rope and
    the band against their plain versions, bf16 and fp32, B=2, W in
    {1, 63, 64, 65, 1024}, T in {1000, 8192} with rope and T=1000 without
    it; then K1-fwd alone without rope at T=7680 (the serving prefill's
    band).  Inputs are the band-edge ones of `band_edge_qk`, except at
    T=1000, W=1024 (causal), where q and k are random.  At W=1 the output
    must equal v exactly.  Tolerances as K1-K3's: out as `out_errors`,
    grads 2e-2 abs + rel bf16 and 1e-4 fp32; lse 1e-4 bf16 and 1e-5 fp32,
    relative to max(1, |lse|) (the band-edge scores reach about 18).  Then
    K4 with W=1024 at q_offset 7168 (NaN tail) at B=8, KH=12 (the serving
    shape) and B=2, KH=4.  Times at T=8192, W=1024 with rope, and K4's at
    the serving shape, beside the band-aware bound (pairs = sum_t min(t +
    1, W) per (b, h)) and SDPA with an explicit band mask on q and k
    rotated beforehand; the windowed K2 must take under half the
    full-causal K2's time."""
    from vitrs_tpu_torch.ops import flash_attention as FA
    from vitrs_tpu_torch.ops import flash_attention_gqa as FG
    from vitrs_tpu_torch.ops import flash_prefill as FP
    from vitrs_tpu_torch.ops.rope import rope_qk
    gen = torch.Generator(device="cuda").manual_seed(8)
    tols = {torch.bfloat16: (1e-4, 2e-2), torch.float32: (1e-5, 1e-4)}
    worst = {}
    B = 2
    n_cases = 0
    for dtype, (lse_tol, bwd_tol) in tols.items():
        for kh in (NH, 4, 1):
            fwd_k, fwd_p, bwd_k, bwd_p = _attn_fns(kh)
            for T, ropes in ((1000, (False, True)), (8192, (True,))):
                for rope in ropes:
                    for W in (1, 63, 64, 65, 1024):
                        if W < T:
                            q, k = band_edge_qk(B, T, T, NH, kh, W, rope=rope)
                        else:
                            q = torch.randn(B, T, C, generator=gen, device="cuda")
                            k = torch.randn(B, T, kh * D, generator=gen,
                                            device="cuda")
                        v = torch.randn(B, T, kh * D, generator=gen, device="cuda")
                        do = torch.randn(B, T, C, generator=gen, device="cuda")
                        q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
                        where = (f"{str(dtype)[6:]} KH={kh} T={T} W={W} "
                                 f"rope={int(rope)}")
                        out, lse = fwd_k(q, k, v, True, W, rope)
                        ref, ref_lse = fwd_p(q, k, v, True, W, rope)
                        got = bwd_k(q, k, v, out, lse, do, True, W, rope)
                        want = bwd_p(q, k, v, out, lse, do, True, W, rope)
                        torch.cuda.synchronize()
                        err, rms, lse_err = _check_band_fwd(
                            where, W, out, lse, ref, ref_lse, v, kh, lse_tol)
                        errs = [err]
                        for name, a, b in zip(("dq", "dk", "dv"), got, want):
                            check(torch.isfinite(a).all().item(),
                                  f"{where}: {name} non-finite")
                            d = (a.float() - b.float()).abs()
                            nbad = (d > bwd_tol + bwd_tol * b.float().abs()
                                    ).sum().item()
                            check(nbad == 0, f"{where}: {nbad} {name} values "
                                  f"beyond {bwd_tol}")
                            errs.append(d.max().item())
                        n_cases += 1
                        print(f"[kernels-rope-window] {where}: max_abs_err out "
                              f"{errs[0]:.3e} (rms {rms:.3e}) lse(rel) "
                              f"{lse_err:.3e} dq/dk/dv {errs[1]:.3e}/"
                              f"{errs[2]:.3e}/{errs[3]:.3e}")
                        if dtype == torch.bfloat16:
                            key = "mha" if kh == NH else "gqa"
                            worst[key + "_fwd"] = max(worst.get(key + "_fwd", 0.0),
                                                      errs[0])
                            worst[key + "_bwd"] = max(worst.get(key + "_bwd", 0.0),
                                                      *errs[1:])
                        del q, k, v, do, out, lse, ref, ref_lse, got, want
    print(f"[kernels-rope-window] {n_cases} cases within tolerance")

    # the serving prefill's K1-fwd: the band with rope=False (generate
    # rotates q and k before the cache write) on a whole 7680-token prompt,
    # as serve-window runs it (there at B=8; B=2 keeps the plain version's
    # fp32 T x T scores small); forward only
    T = 7680
    fwd_k, fwd_p = _attn_fns(NH)[:2]
    for dtype, (lse_tol, _) in tols.items():
        for W in (1, 63, 64, 65, 1024):
            q, k = band_edge_qk(B, T, T, NH, NH, W)
            v = torch.randn(B, T, C, generator=gen, device="cuda")
            q, k, v = (t.to(dtype) for t in (q, k, v))
            where = f"{str(dtype)[6:]} KH={NH} T={T} W={W} rope=0 (fwd only)"
            out, lse = fwd_k(q, k, v, True, W, False)
            ref, ref_lse = fwd_p(q, k, v, True, W, False)
            torch.cuda.synchronize()
            err, rms, lse_err = _check_band_fwd(where, W, out, lse, ref,
                                                ref_lse, v, NH, lse_tol)
            print(f"[kernels-rope-window] {where}: max_abs_err out {err:.3e} "
                  f"(rms {rms:.3e}) lse(rel) {lse_err:.3e}")
            if dtype == torch.bfloat16:
                worst["mha_fwd"] = max(worst["mha_fwd"], err)
            del q, k, v, out, lse, ref, ref_lse

    # K4: a 512-query chunk at q_offset 7168 against an 8K cache, W=1024:
    # at the serving shape (B=8, the window model's 12 kv heads) and at
    # B=2, KH=4
    S, q_off, Tk, W = 512, 7168, 7936, 1024
    for dtype in (torch.bfloat16, torch.float32):
        for Bp, kh in ((8, NH), (B, 4)):
            q, k = band_edge_qk(Bp, S, Tk, NH, kh, W, q_off=q_off)
            v = torch.randn(Bp, Tk, kh * D, generator=gen, device="cuda")
            q, k, v = (t.to(dtype) for t in (q, k, v))
            k[:, q_off + S:] = float("nan")
            v[:, q_off + S:] = float("nan")
            got = FP.flash_prefill_cuda(q, k, v, NH, kh, q_off, 0.125, W)
            want = FP.flash_prefill_plain(q, k, v, NH, kh, q_off, 0.125, W)
            torch.cuda.synchronize()
            check(torch.isfinite(got).all().item(), "K4 window: non-finite")
            bad, err, rms = out_errors(got, want)
            check(bad == 0, f"K4 window {dtype} B={Bp} KH={kh}: {bad} values "
                  f"beyond tolerance")
            print(f"[kernels-rope-window] K4 {str(dtype)[6:]} B={Bp} KH={kh} "
                  f"S={S} q_off={q_off} W={W} (NaN tail): max_abs_err "
                  f"{err:.3e} (rms {rms:.3e})")
            del q, k, v, got, want
            if dtype == torch.bfloat16:
                worst["prefill"] = max(worst.get("prefill", 0.0), err)

    # times at the training shape: bf16 B=2 T=8192 W=1024 rope
    T = 8192
    res = {}
    for kh in (NH, 4):
        fwd_k, fwd_p, bwd_k, bwd_p = _attn_fns(kh)
        q, k, v, do = (torch.randn(B, T, n, generator=gen, device="cuda")
                       .bfloat16() for n in (C, kh * D, kh * D, C))
        out, lse = fwd_k(q, k, v, True, W, True)
        qr, kr = rope_qk(q, k, torch.arange(T, device="cuda"), NH, kh)
        mask = band_mask(T, 0, T, W)
        key = "mha" if kh == NH else "gqa"
        shape = f"bf16 B=2 T=8192 NH=12 KH={kh} D=64 W=1024 rope"
        for part, kern, plain, lib, bnd in (
                ("fwd", lambda: fwd_k(q, k, v, True, W, True),
                 lambda: fwd_p(q, k, v, True, W, True),
                 lambda: sdpa_fwd(qr, kr, v, kh, mask),
                 attn_fwd_bound(B, T, 0, T, kh, 2, window=W, rope=True)),
                ("bwd", lambda: bwd_k(q, k, v, out, lse, do, True, W, True),
                 lambda: bwd_p(q, k, v, out, lse, do, True, W, True),
                 sdpa_bwd(qr, kr, v, do, kh, mask),
                 attn_bwd_bound(B, T, kh, 2, window=W, rope=True))):
            km, pm, raw = timed_pair(kern, plain, iters=5, warmup=1)
            lib_ms = cuda_ms(lib, iters=5, warmup=1)
            print(f"[kernels-rope-window] {key}_{part} time {shape}: kernel "
                  f"{raw[0]:.4f}/{raw[1]:.4f} ms, plain {raw[2]:.4f}/"
                  f"{raw[3]:.4f} ms, SDPA (band mask) {lib_ms:.4f} ms, bound "
                  f"{bnd[0]:.4f} ms ({bnd[1]})")
            res[f"{key}_{part}"] = dict(
                max_abs_err=worst[f"{key}_{part}"], ms=km, plain_ms=pm,
                bound_ms=bnd[0], bound_by=bnd[1], library_ms=lib_ms,
                shape=shape)
            if part == "bwd":
                rsc, flops = bwd_resources(True), bwd_flops(B, T, W)
                print_bwd_rate("kernels-rope-window", f"{key}_bwd", km, flops, rsc)
                res[f"{key}_bwd"].update(tflops=flops / km / 1e9, resources=rsc)
        if kh == NH:
            # the band must skip tiles: the full-causal K2 at the same shape
            out_c, lse_c = fwd_k(q, k, v, True, 0, True)
            full = cuda_ms(lambda: bwd_k(q, k, v, out_c, lse_c, do, True, 0,
                                         True), iters=5, warmup=1)
            win = cuda_ms(lambda: bwd_k(q, k, v, out, lse, do, True, W, True),
                          iters=5, warmup=1)
            print(f"[kernels-rope-window] K2 T=8192 rope: W=1024 {win:.4f} ms, "
                  f"full causal {full:.4f} ms (ratio {win / full:.3f}, "
                  f"{bwd_flops(B, T) / full / 1e9:.1f} TFLOP/s)")
            check(win < 0.5 * full, f"windowed K2 {win} ms is not under half "
                  f"the full-causal {full} ms: the band skips nothing")
            res["mha_bwd"]["full_causal_ms"] = full
            res["mha_bwd"]["full_causal_bound_ms"] = attn_bwd_bound(
                B, T, kh, 2, rope=True)[0]
        del q, k, v, do, out, lse, qr, kr, mask
    # K4 at the serving shape: B=8, the window model's 12 kv heads
    Bp, kh = 8, NH
    q, k = band_edge_qk(Bp, S, Tk, NH, kh, W, q_off=q_off)
    v = torch.randn(Bp, Tk, kh * D, generator=gen, device="cuda")
    q, k, v = (t.bfloat16() for t in (q, k, v))
    front = q_off + S
    mask = band_mask(S, q_off, front, W)
    km, pm, raw = timed_pair(
        lambda: FP.flash_prefill_cuda(q, k, v, NH, kh, q_off, 0.125, W),
        lambda: FP.flash_prefill_plain(q, k, v, NH, kh, q_off, 0.125, W))
    lib = cuda_ms(lambda: sdpa_fwd(q, k[:, :front], v[:, :front], kh, mask))
    bms, by = attn_fwd_bound(Bp, S, q_off, Tk, kh, 2, window=W)
    shape = "bf16 B=8 S=512 q_off=7168 Tk=7936 NH=12 KH=12 D=64 W=1024"
    print(f"[kernels-rope-window] K4 time {shape}: kernel {raw[0]:.4f}/"
          f"{raw[1]:.4f} ms, plain {raw[2]:.4f}/{raw[3]:.4f} ms, SDPA (band "
          f"mask) {lib:.4f} ms, bound {bms:.4f} ms ({by})")
    res["prefill"] = dict(max_abs_err=worst["prefill"], ms=km, plain_ms=pm,
                          bound_ms=bms, bound_by=by, library_ms=lib,
                          shape=shape)
    return res


def phase_kernels_headce():
    """K8 against its plain version at R in {8192, 16384}, C=768, Vp=50304
    (real vocab 50257, zero pad rows), bf16: logits within one bf16 ulp
    plus the picked bound (2^-7 |want| + 1e-5: each side rounds an fp32 sum
    of 768 products, summed in another order, so near 0, where the ulp is
    smaller than that sum's error, the two roundings can differ by more
    than one ulp), lse 1e-4 (K5's: an fp32 logsumexp over 50257 columns in
    another order), picked 1e-5 (one fp32 dot, |picked| about 0.6).  Times
    beside the bound (2 R C Vp operations on the tensor cores: 0.640 and
    1.280 ms), torch.matmul + F.cross_entropy on the bf16 logits (two
    calls: no one PyTorch call computes the same function) and the port's
    two-op route that K8 replaces (cuBLAS, then K5).  Then the loss and both
    gradients through `head_ce_mean` (K8, K6 and two matmuls) against the
    two-op route (matmul, K5, K6) at R=8192: loss rtol 1e-4 (K8's lse reads
    the fp32 product, K5's the bf16 logits), grads within 1e-2 of their
    largest value."""
    import torch.nn.functional as F
    from vitrs_tpu_torch.ops import basic
    from vitrs_tpu_torch.ops import fused_ce as CE
    from vitrs_tpu_torch.ops import fused_head_ce as FH
    gen = torch.Generator(device="cuda").manual_seed(9)
    V, Vp = 50257, 50304
    res = {}
    worst = 0.0
    for R in (8192, 16384):
        x = torch.randn(R, C, generator=gen, device="cuda").bfloat16()
        w = (0.02 * torch.randn(Vp, C, generator=gen, device="cuda")).bfloat16()
        w[V:] = 0
        t = torch.randint(0, V, (R,), generator=gen, device="cuda")
        logits, lse, picked = FH.head_ce_fwd_cuda(x, w, t, V)
        rl, rlse, rpick = FH.head_ce_fwd_plain(x, w, t, V)
        torch.cuda.synchronize()
        dl = (logits.float() - rl.float()).abs()
        over = dl - (2.0 ** -7 * rl.float().abs() + 1e-5)
        bad = (over > 0).sum().item()
        logit_err = dl.max().item()
        i = int(over.argmax())
        worst_pair = (logits.flatten()[i].item(), rl.flatten()[i].item())
        lse_err = (lse - rlse).abs().max().item()
        pick_err = (picked - rpick).abs().max().item()
        check(torch.isfinite(logits).all().item(), f"K8 R={R}: non-finite")
        check(bad == 0, f"K8 R={R}: {bad} logits beyond one bf16 ulp + "
              f"1e-5 (worst got/want {worst_pair})")
        check(lse_err <= 1e-4 and pick_err <= 1e-5,
              f"K8 R={R}: lse err {lse_err}, picked err {pick_err}")
        worst = max(worst, logit_err, lse_err, pick_err)
        del rl, dl
        km, pm, raw = timed_pair(lambda: FH.head_ce_fwd_cuda(x, w, t, V),
                                 lambda: FH.head_ce_fwd_plain(x, w, t, V),
                                 iters=10, warmup=2)
        # the yardstick: the padded product (an aligned N for cuBLAS; the
        # 50257 real rows alone take an odd N and a slower GEMM), then
        # F.cross_entropy on the real columns of the bf16 logits, no cast
        lib = cuda_ms(lambda: F.cross_entropy(
            torch.matmul(x, w.t())[:, :V], t, reduction="none"),
            iters=10, warmup=2)
        # the port's own route that K8 replaces: cuBLAS, then K5
        two_op = cuda_ms(lambda: CE.ce_fwd_cuda(basic.linear(x, w), t, V),
                         iters=10, warmup=2)
        # reads x, w and the targets, writes the bf16 logits, lse, picked
        bms, by = bound(2 * R * C * Vp, "bf16",
                        2 * R * C + 2 * Vp * C + 8 * R + 2 * R * Vp + 8 * R)
        shape = f"bf16 R={R} C=768 Vp={Vp} real_vocab={V}"
        print(f"[kernels-headce] K8 {shape}: logits max_abs_err "
              f"{logit_err:.3e}, lse {lse_err:.3e}, picked {pick_err:.3e}; kernel {raw[0]:.4f}/"
              f"{raw[1]:.4f} ms, plain {raw[2]:.4f}/{raw[3]:.4f} ms, "
              f"torch.matmul + F.cross_entropy (bf16) {lib:.4f} ms, cuBLAS "
              f"+ K5 {two_op:.4f} ms, bound {bms:.4f} ms ({by})")
        res[R] = dict(ms=km, plain_ms=pm, bound_ms=bms, bound_by=by,
                      library_ms=lib, two_op_ms=two_op, shape=shape)
        del x, w, t, logits, lse, picked
    res[8192]["max_abs_err"] = worst

    R = 8192
    x = torch.randn(R, C, generator=gen, device="cuda").bfloat16()
    w = (0.02 * torch.randn(Vp, C, generator=gen, device="cuda")).bfloat16()
    w[V:] = 0
    t = torch.randint(0, V, (R,), generator=gen, device="cuda")
    out = {}
    for route in ("k8", "two-op"):
        xl, wl = (a.detach().clone().requires_grad_(True) for a in (x, w))
        if route == "k8":
            loss = FH.head_ce_mean(xl, wl, t, V)
        else:
            loss = CE.cross_entropy_mean(basic.linear(xl, wl), t, real_vocab=V)
        loss.backward()
        out[route] = (loss.item(), xl.grad.float(), wl.grad.float())
    (l8, dx8, dw8), (l2, dx2, dw2) = out["k8"], out["two-op"]
    ex = ((dx8 - dx2).abs().max() / dx2.abs().max()).item()
    ew = ((dw8 - dw2).abs().max() / dw2.abs().max()).item()
    print(f"[kernels-headce] autograd R={R}: loss {l8:.6f} (K8) vs {l2:.6f} "
          f"(two-op); dX, dW max err {ex:.3e}, {ew:.3e} of their largest; "
          f"dW pad rows {dw8[V:].abs().max().item():.1e}")
    check(abs(l8 - l2) <= 1e-4 * abs(l2), f"K8 loss {l8} vs two-op {l2}")
    check(ex <= 1e-2 and ew <= 1e-2, f"K8 grads differ: {ex}, {ew}")
    check(bool((dw8[V:] == 0).all()), "K8: dW pad rows not 0")
    return res


def phase_serve_window(smi):
    """The JAX package's streaming-window serving row (benchmarks/
    gen_variants.py --mode window): gpt2-124m at max_seq_len 8192 with
    window 1024 and rope (129,944,832 parameters), seeded random weights,
    bf16, B=8, a 7680-token seeded prompt, greedy.  `generate` whole (K1-fwd
    with the band, q and k rotated before the cache write) and in 512-token
    chunks (then K4 with the band): launches, prefill ms, and the chunked
    and whole last-position logits within 1e-3 (they read the same 64-key
    tiles in the same order).  Then `generate_streaming` (the ring cache,
    plain torch) for 32 new tokens: ms per new token, and the first token
    where it departs from the dense-cache `generate` (bf16 near-ties: the
    ring attends in another order)."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.models import generate as G
    from vitrs_tpu_torch.models import model as M
    cfg = get_config("gpt2-124m", max_seq_len=8192, window=1024,
                     pos_emb="rope", dtype="bfloat16")
    check(P.num_parameters(cfg) == 129_944_832, "rope + window 8K params")
    params = P.init_params(cfg, torch.Generator().manual_seed(0))
    pp = M.prepare_params({k: t.to("cuda") for k, t in params.items()}, cfg)
    del params
    B, T0, L = 8, 7680, cfg.num_layers
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, T0)), device="cuda")

    def timed(fn):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3, read_counts()

    res = {}
    for chunk in (512, 0):
        gen = lambda n: G.generate(pp, prompt, cfg, n, temperature=0.0,
                                   prefill_chunk=chunk)
        timed(lambda: gen(2))                  # warm-up: cuBLAS, allocator
        _, ms1, counts = timed(lambda: gen(1))
        want = designed(flash_fwd=L,
                        flash_prefill=L * (T0 // chunk - 1) if chunk else 0)
        check(counts == want, f"serve-window chunk {chunk}: launches "
              f"{counts} != {want}")
        res[chunk] = dict(prefill_ms=ms1, launches=counts)
        print(f"[serve-window] chunk {chunk}: launches flash_fwd "
              f"{counts['flash_fwd']}, flash_prefill {counts['flash_prefill']}"
              f"; prefill (max_new=1) {ms1:.2f} ms  ({smi})")
    chunked = _prefill_logits(G, pp, prompt, cfg, 512, 7936)
    whole = _prefill_logits(G, pp, prompt, cfg, 0, T0 + 1)
    d_cw = (chunked - whole).abs().max().item()
    check(torch.isfinite(whole).all().item(), "serve-window: non-finite")
    print(f"[serve-window] last-position logits chunked vs whole max_abs_err "
          f"{d_cw:.4e} (max |logit| {whole.abs().max().item():.3f})")
    check(d_cw <= 1e-3, f"serve-window: chunked vs whole logits differ by "
          f"{d_cw}")
    res["chunked_vs_whole"] = d_cw

    n = 32
    dense, dense_ms, _ = timed(lambda: G.generate(pp, prompt, cfg, n,
                                                  temperature=0.0))
    G.generate_streaming(pp, prompt, cfg, 2, temperature=0.0)   # warm-up
    _, s1, c1 = timed(lambda: G.generate_streaming(pp, prompt, cfg, 1,
                                                   temperature=0.0))
    ring, sn, cn = timed(lambda: G.generate_streaming(pp, prompt, cfg, n,
                                                      temperature=0.0))
    check(c1 == designed() and cn == designed(),
          f"serve-window: the ring path launched a kernel: {cn}")
    check(ring.shape == (B, T0 + n) and bool(
        ((ring[:, T0:] >= 0) & (ring[:, T0:] < cfg.vocab_size)).all()),
        "serve-window: streaming output")
    diff = (ring[:, T0:] != dense[:, T0:]).int()
    first = [int(r.argmax()) if r.any() else None for r in diff.cpu()]
    per_tok = (sn - s1) / (n - 1)
    print(f"[serve-window] generate_streaming B={B} {n} new: prefill "
          f"(max_new=1) {s1:.2f} ms, {sn:.2f} ms in all, {per_tok:.3f} ms per "
          f"new token; dense-cache generate {dense_ms:.2f} ms; first new token "
          f"where ring and dense differ, per row: {first}")
    res.update(stream_ms_per_token=per_tok, stream_prefill_ms=s1,
               dense_gen_ms=dense_ms, first_divergence=first)
    return res


def phase_xdevice_window():
    """Small fp32 models with rope and window 8 (L=2, NH=2, C=128, D=64,
    vocab 16500), kv in {2 (MHA), 1}: one training step (as xdevice-train:
    K1/K2 or K3, K5, K6, K7 on CUDA) and a chunked generate (48-token
    prompt, chunk 16, 8 new: K1-fwd or K3-fwd, then K4, each with the band)
    on CUDA against the CPU's plain versions: the same greedy tokens,
    last-chunk logits within 1e-4."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.models import generate as G
    from vitrs_tpu_torch.models import model as M
    counts = {}
    for kv in (2, 1):
        cfg = get_config("gpt-nano").replace(
            num_layers=2, num_heads=2, num_kv_heads=kv, channels=128,
            max_seq_len=64, vocab_size=16500, pos_emb="rope", window=8)
        train = phase_xdevice_train(cfg, f"xdevice-window kv={kv}")
        params = P.init_params(cfg, torch.Generator().manual_seed(10))
        prompt = torch.as_tensor(np.random.default_rng(10).integers(
            0, cfg.vocab_size, (2, 48)))
        fwd = "flash_gqa_fwd" if cfg.is_gqa else "flash_fwd"
        toks, logits = {}, {}
        for dev in ("cuda", "cpu"):
            pp = M.prepare_params({k: t.to(dev) for k, t in params.items()},
                                  cfg)
            reset_counts()
            toks[dev] = G.generate(pp, prompt.to(dev), cfg, 8,
                                   temperature=0.0, prefill_chunk=16).cpu()
            got = read_counts()
            want = (designed(**{fwd: 2, "flash_prefill": 4}) if dev == "cuda"
                    else designed())
            check(got == want, f"xdevice-window generate on {dev}: {got}")
            caches = G.init_kv_cache(cfg, 2, 256, device=dev)
            for off in range(0, 48, 16):
                lg, caches = G.forward_with_cache(
                    pp, prompt[:, off:off + 16].to(dev), caches, off, cfg)
            logits[dev] = lg.cpu()
        check(torch.equal(toks["cuda"], toks["cpu"]),
              f"xdevice-window kv={kv}: generate tokens differ")
        err = (logits["cuda"] - logits["cpu"]).abs().max().item()
        check(err <= 1e-4, f"xdevice-window kv={kv}: logits differ by {err}")
        print(f"[xdevice-window] kv={kv} fp32 rope W=8 chunked generate: "
              f"tokens equal on cuda and cpu; last-chunk logits max_abs_err "
              f"{err:.3e}")
        counts[kv] = train
    return counts


WINDOW = {"max_seq_len": 8192, "window": 1024, "pos_emb": "rope"}
WINDOW_PARAMS = 129_944_832      # 124,439,808 + 7,168 extra wpe rows x 768


def phase_train_window(smi):
    """The long-context path: GPT-2 124M at T=8192, W=1024, rope, B=2, 12
    steps (K1-fwd and K2 with the in-kernel rotation and the band), then
    the full-causal control (W=0, rope) in the same call."""
    counts, res = phase_train(smi, overrides=WINDOW, B=2, tag="[train-window]",
                              n_params=WINDOW_PARAMS)
    _, full = phase_train(smi, overrides=dict(WINDOW, window=0), B=2,
                          tag="[train-window W=0]", n_params=WINDOW_PARAMS)
    print(f"[train-window] W=1024 {res['step_ms']:.2f} ms/step vs full causal "
          f"{full['step_ms']:.2f} ms/step (ratio "
          f"{res['step_ms'] / full['step_ms']:.3f})")
    res["full_causal"] = full
    return counts, res


def phase_train_headce(smi, two_op):
    """The MHA step of phase 6 with ops/fused_head_ce.ENABLE set: K8 (and
    K6) in place of K5/K6, 12 K8 launches and no K5 launch in 12 steps;
    ms/step beside the two-op run of this call."""
    counts, res = phase_train(smi, tag="[train-headce]", head_ce=True)
    print(f"[train-headce] K8 loss route {res['step_ms']:.2f} ms/step vs "
          f"two-op (phase train) {two_op['step_ms']:.2f} ms/step")
    res["two_op_step_ms"] = two_op["step_ms"]
    return counts, res


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch sees no CUDA device")
    import vitrs_tpu_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # --phases a,b,...: run only those (no result lines); for iterating
    only = None
    if len(sys.argv) > 2 and sys.argv[1] == "--phases":
        only = set(sys.argv[2].split(","))
    smi = phase_device()
    R = {}
    phases = (
        ("kernels", phase_kernels),
        ("serve", lambda: phase_serve(smi)),
        ("xdevice", phase_xdevice),
        ("kernels-train", phase_kernels_train),
        ("train", lambda: phase_train(smi)),
        ("xdevice-train", phase_xdevice_train),
        ("kernels-gqa", phase_kernels_gqa),
        ("kernels-prefill", phase_kernels_prefill),
        ("train-gqa", lambda: phase_train(smi, kv_heads=4)),
        ("serve-gqa", lambda: phase_serve_gqa(smi)),
        ("xdevice-gqa", phase_xdevice_gqa),
        ("kernels-rope-window", phase_kernels_rope_window),
        ("kernels-headce", phase_kernels_headce),
        ("train-window", lambda: phase_train_window(smi)),
        ("train-headce", lambda: phase_train_headce(smi, R["train"][1])),
        ("serve-window", lambda: phase_serve_window(smi)),
        ("xdevice-window", phase_xdevice_window),
    )
    for name, fn in phases:
        if only is None or name in only:
            t0 = time.perf_counter()
            R[name] = fn()
            print(f"[smoke] phase {name} done in "
                  f"{time.perf_counter() - t0:.1f} s")
    if only is not None:
        print(f"[smoke] ran {sorted(R)}")
        return
    k1 = R["kernels"]
    serve_launches, prefill_ms, tok_s = R["serve"]
    ktrain = R["kernels-train"]
    counts, train = R["train"]
    kgqa, kprefill = R["kernels-gqa"], R["kernels-prefill"]
    gqa_counts, gqa_train = R["train-gqa"]
    serve_gqa = R["serve-gqa"]
    krw, k8 = R["kernels-rope-window"], R["kernels-headce"]
    win_counts, win_train = R["train-window"]
    h8_counts, h8_train = R["train-headce"]
    serve_win, xwin = R["serve-window"], R["xdevice-window"]
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
        # the rope and band variants of the same kernels: launches on the
        # long-context training run, the windowed serving run, and (K3) the
        # rope + window GQA training step of xdevice-window
        dict(name="flash_fwd_rope_window", route="cuda",
             source=CSRC + "flash_fwd.cu", replaces=fa + "567",
             launches=win_counts["flash_fwd"],
             serve_launches=serve_win[512]["launches"]["flash_fwd"],
             **krw["mha_fwd"]),
        dict(name="flash_bwd_rope_window", route="cuda",
             source=CSRC + "flash_bwd.cu", replaces=fa + "844",
             also_replaces=[fa + "986", fa + "901"],
             launches=win_counts["flash_bwd"], kernels_per_launch=3,
             **krw["mha_bwd"]),
        dict(name="flash_gqa_fwd_rope_window", route="cuda",
             source=CSRC + "flash_fwd.cu", replaces=fg + "358",
             launches=xwin[1]["flash_gqa_fwd"], **krw["gqa_fwd"]),
        dict(name="flash_gqa_bwd_rope_window", route="cuda",
             source=CSRC + "flash_bwd.cu", replaces=fg + "499",
             launches=xwin[1]["flash_gqa_bwd"], kernels_per_launch=3,
             **krw["gqa_bwd"]),
        dict(name="flash_prefill_window", route="cuda",
             source=CSRC + "flash_fwd.cu",
             replaces="vitrs_tpu/ops/flash_prefill.py:123",
             launches=serve_win[512]["launches"]["flash_prefill"],
             **krw["prefill"], serve_window=serve_win),
        dict(name="head_ce_fwd", route="cuda",
             source=CSRC + "fused_head_ce.cu",
             replaces="vitrs_tpu/ops/fused_head_ce.py:68",
             launches=h8_counts["head_ce_fwd"], kernels_per_launch=2,
             **k8[8192], r16384=k8[16384], train=h8_train),
    ]
    kernels[0]["train"] = train
    kernels[5]["train"] = gqa_train
    kernels[8]["train"] = win_train
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
