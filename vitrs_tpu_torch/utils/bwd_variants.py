"""Variants of csrc/flash_bwd.cu (K2, K3-bwd) timed beside it on the card:
the measurements behind the kernel's design choices (PERF.md §6).

A variant is a named list of textual edits of the source, each replacing
every occurrence of its text.  The script builds the source and each chosen
variant with nvcc, all at once, into `_build/variants/`, checks each
against the plain version, then times the backward's three kernels
(pre-pass, dK/dV, dQ) with torch.profiler at the training shapes, in the
order base, variants, variants reversed, base, and prints one line per run
and shape.

    python -m vitrs_tpu_torch.utils.bwd_variants              # every variant
    python -m vitrs_tpu_torch.utils.bwd_variants dq-shared-kv no-exp

Design alternatives compute the same gradients; ablations (no-*) compute
wrong ones on purpose and only show what a part of the kernel costs.  Needs
a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import os
import subprocess

import torch

from ..ops import _build
from ..ops import flash_attention as FA
from ..ops import flash_attention_gqa as FG

NH, D = 12, 64
C = NH * D
SRC = os.path.join(_build.CSRC_DIR, "flash_bwd.cu")
OUT = os.path.join(_build.BUILD_DIR, "variants")

_DKV = "__launch_bounds__(128, 2)\n    flash_bwd_dkv_wgmma"
VARIANTS = {
    # dQ blocks of up to 3 warpgroups, the query heads of one kv head, that
    # share every staged K/V tile (the largest divisor of the group <= 3)
    "dq-shared-kv": [
        ("__launch_bounds__(128, kDqMinBlocks)\n    flash_bwd_dq_wgmma",
         "__launch_bounds__(384)\n    flash_bwd_dq_wgmma"),
        ("""  const uint32_t sq = base, sdo = base + kTile;
  const uint32_t skv = base + 2 * kTile;""",
         """  const int heads = blockDim.x >> 7, wg = threadIdx.x >> 7;
  const uint32_t sq = base + 2 * wg * kTile, sdo = sq + kTile;
  const uint32_t skv = base + 2 * heads * kTile;"""),
        ("""  const int b = blockIdx.x / a.num_heads, h = blockIdx.x % a.num_heads;
  const int hk = h / a.group;""",
         """  const int chunks = a.num_heads / heads;
  const int b = blockIdx.x / chunks, h0 = (blockIdx.x % chunks) * heads, h = h0 + wg;
  const int hk = h0 / a.group;"""),
        ("const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n"
         "  const int g = lane >> 2, t = lane & 3;\n  const int r0",
         "const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;\n"
         "  const int g = lane >> 2, t = lane & 3;\n  const int r0"),
        ("""  if (tid == 0) {
    const uint32_t bar = bars + 8 * kStagesQ;
    mbar_expect(bar, 2 * kTile);
    tma_head<kHeadDim>(sq, kQhat ? &maps.qh : &maps.q, bar, h, m0, b);
    tma_head<kHeadDim>(sdo, &maps.dout, bar, h, m0, b);
  }""", """  if (threadIdx.x == 0) {
    const uint32_t bar = bars + 8 * kStagesQ;
    mbar_expect(bar, 2 * heads * kTile);
    for (int w = 0; w < heads; ++w) {
      tma_head<kHeadDim>(base + 2 * w * kTile, kQhat ? &maps.qh : &maps.q, bar, h0 + w,
                         m0, b);
      tma_head<kHeadDim>(base + (2 * w + 1) * kTile, &maps.dout, bar, h0 + w, m0, b);
    }
  }"""),
        ("    if (it < n_it && tid == 0) {", "    if (it < n_it && threadIdx.x == 0) {"),
        ("return 1024 + (2 + 2 * kStagesQ) * kTile",
         "return 1024 + (2 * 3 + 2 * kStagesQ) * kTile"),
        ("  dq<<<dim3(batch * a.num_heads, tiles, slices), 128, dq_smem_of(), s>>>(maps, a);",
         """  const int heads = a.group % 3 == 0 ? 3 : a.group % 2 == 0 ? 2 : 1;
  dq<<<dim3(batch * a.num_heads / heads, tiles, slices), 128 * heads, dq_smem_of(),
       s>>>(maps, a);"""),
    ],
    "dq-3-stages": [("constexpr int kStagesQ = 2;", "constexpr int kStagesQ = 3;")],
    "dkv-2-stages": [("constexpr int kStagesKV = kHeadDim == 256 ? 2 : 3;",
                      "constexpr int kStagesKV = 2;")],
    "dkv-3-blocks": [(_DKV, _DKV.replace("(128, 2)", "(128, 3)"))],
    # the dK product of q tile m left running into iteration m + 1 (waited
    # there with S^T and dP^T); the ring refills the stage of m - 1 one
    # iteration later, so it is one deeper for the same lookahead
    "dkv-overlap-dk": [
        ("constexpr int kStagesKV = kHeadDim == 256 ? 2 : 3;", "constexpr int kStagesKV = 4;"),
        ("  for (int s = 0; s < kStagesKV - 1; ++s) issue(s);",
         "  for (int s = 0; s < kStagesKV - 2; ++s) issue(s);"),
        ("    cp_async_wait<kStagesKV - 2>();", "    cp_async_wait<kStagesKV - 3>();"),
        ("    issue(it + kStagesKV - 1);", "    issue(it + kStagesKV - 2);"),
        ("""    product_cols<kHeadDim>(dk, da, sq);
    wg_commit();
    wg_wait<0>();
    fence_acc(dv);
    fence_acc(dk);
  }
""", """    product_cols<kHeadDim>(dk, da, sq);
    wg_commit();
  }
  wg_wait<0>();
  fence_acc(dv);
  fence_acc(dk);
"""),
    ],
    # ablations
    "no-exp": [("ex2(fmaf(s[nt][i], s_mul, -l2[nt][i & 1]))",
                "fmaf(s[nt][i], s_mul, -l2[nt][i & 1])")],
    "no-dkv-copies": [
        ("""        mbar_expect(bar, kPer * kTile);
        tma_head<kHeadDim>(s0, &maps.q, bar, h, m0, b);
        tma_head<kHeadDim>(s0 + kTile, &maps.dout, bar, h, m0, b);""",
         "        mbar_expect(bar, 0);")],
    "no-dk-product": [("    product_cols<kHeadDim>(dk, da, sq);\n", "")],
}


def _build_variant(name: str):
    """(name, ctypes function or None, ptxas register counts or nvcc's error)."""
    with open(SRC) as f:
        src = f.read()
    for old, new in VARIANTS.get(name, []):
        if old not in src:
            return name, None, f"edit does not apply: {old[:60]!r}"
        src = src.replace(old, new)
    path = os.path.join(OUT, f"flash_bwd_{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(OUT, f"lib_{name}.so")
    res = subprocess.run([_build.nvcc(), *_build.flags_for(D), "-I",
                          _build.CSRC_DIR, "-o", lib, path],
                         capture_output=True, text=True)
    log = res.stdout + res.stderr
    if res.returncode:
        return name, None, log[-2000:]
    fn = ctypes.CDLL(os.path.abspath(lib)).vitrs_flash_bwd
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [I] + [P] * 13 + [LL] * 14 + [I] * 9 + [ctypes.c_float, P, P, P]
    fn.restype = I
    regs = [line.split("Used ")[1].split(",")[0] for line in log.splitlines()
            if "Used" in line and "registers" in line]
    notes = [line.strip() for line in log.splitlines() if "wgmma" in line]
    return name, fn, "; ".join(regs + notes)


def _inputs(B, T, KH, W, rope, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn(B, T, C, generator=g, device="cuda").bfloat16()
             for _ in range(2))
    k, v = (torch.randn(B, T, KH * D, generator=g, device="cuda").bfloat16()
            for _ in range(2))
    out, lse = FG.flash_gqa_fwd_cuda(q, k, v, NH, KH, True, 0.125, W, rope)
    return q, k, v, out, lse, do


def _kernel_ms(call, iters=5):
    """{kernel: device ms per call} of the backward's three kernels."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    res = {}
    for ev in prof.key_averages():
        for part in ("prep", "dkv", "dq"):
            if f"flash_bwd_{part}" in ev.key:
                res[part] = ev.device_time_total / iters / 1e3
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("names", nargs="*", help=f"variants (default all): {sorted(VARIANTS)}")
    args = p.parse_args(argv)
    names = args.names or list(VARIANTS)
    if not torch.cuda.is_available():
        raise SystemExit("bwd_variants: needs a CUDA device")
    os.makedirs(OUT, exist_ok=True)
    print("[variants] " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    with concurrent.futures.ThreadPoolExecutor(len(names) + 1) as ex:
        built = list(ex.map(_build_variant, ["base"] + names))
    fns = {}
    for name, fn, info in built:
        print(f"[variants] {name}: {info if fn else 'FAILED ' + info}")
        if fn:
            fns[name] = fn
    real = FA._bwd_kernel

    # each against the plain version at B=2, T=1000, KH=4, rope and a band
    q, k, v, out, lse, do = _inputs(2, 1000, 4, 300, True, 0)
    want = FA.flash_bwd_plain(q, k, v, out, lse, do, NH, True, 0.125, kv_heads=4,
                              window=300, rope=True)
    for name, fn in fns.items():
        FA._bwd_kernel = lambda head_dim, fn=fn: fn
        got = FA.launch_bwd("variant", q, k, v, out, lse, do, NH, 4, True, 0.125, 300, True)
        err = max(((a.float() - b.float()).abs() / (2e-2 + 2e-2 * b.float().abs())).max().item()
                  for a, b in zip(got, want))
        print(f"[variants] {name}: largest error / (2e-2 abs + rel) {err:.3f}"
              f"{'' if err <= 1 else ' (wrong gradients)'}")

    shapes = [(8, 1024, 12, 0, False), (8, 1024, 4, 0, False), (8, 1024, 1, 0, False),
              (2, 8192, 12, 1024, True), (2, 8192, 4, 1024, True), (2, 8192, 12, 0, True)]
    data = [(s, _inputs(*s, 1)) for s in shapes]
    order = list(fns) + list(fns)[::-1]
    for name in order:
        FA._bwd_kernel = lambda head_dim, fn=fns[name]: fn
        for (B, T, KH, W, rope), x in data:
            ms = _kernel_ms(lambda: FA.launch_bwd("variant", *x[:5], x[5], NH, KH, True,
                                                  0.125, W, rope))
            print(f"[variants] {name:14s} B={B} T={T} KH={KH:2d} W={W:4d}: "
                  + "  ".join(f"{k} {v:.4f}" for k, v in sorted(ms.items()))
                  + f"  sum {sum(ms.values()):.4f} ms")
    FA._bwd_kernel = real


if __name__ == "__main__":
    main()
