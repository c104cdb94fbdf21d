"""Variants of csrc/fused_head_ce.cu (K8, the fused head + CE forward) timed
beside it on the card: the measurements behind its design choices (PERF.md
§6).

A variant is a named list of textual edits of the source, each replacing
every occurrence of its text.  The script builds the source and each chosen
variant with nvcc, all at once, into `_build/variants/`, checks each bf16
build against the plain version (ragged rows, a ragged last vocab tile, a
half k step), then times it with CUDA events at the main path's shapes
(R = 8192 and 16384, C = 768, Vp = 50304), in the order base, variants,
variants reversed, base, and prints one line per variant and shape.

    python -m vitrs_tpu_torch.utils.head_ce_variants             # every variant
    python -m vitrs_tpu_torch.utils.head_ce_variants cooperative n192

Design alternatives compute the same function; ablations (no-*) compute a
wrong one on purpose and only show what a part of the kernel costs: without
the statistics or the logits store, what is left is the product's time.
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import os
import subprocess

import torch

from ..ops import _build
from ..ops import fused_head_ce as FH

SRC = os.path.join(_build.CSRC_DIR, "fused_head_ce.cu")
OUT = os.path.join(_build.BUILD_DIR, "variants")

_TILE = "constexpr int kBN = 256;"
_RING = "constexpr int kStages = 4;"
_PP = "constexpr bool kPingPong = true;"
_COOP = "constexpr bool kPingPong = false;"
_STORE = "      store_tile(acc, &maps.out, staged + c * kOut, c, m0, n0, a, tid);\n"
_STATS = "      tile_stats(acc, a, r0, tg0, tg1, n0, vt, tid);\n"
_PICK = "// picked[row] from the thread whose columns hold the row's target"
_ILP = """  // four independent partial maxima and sums a row, so that two warps a
  // scheduler keep the special function unit busy instead of waiting out
  // one long chain of dependent adds
  float m0[4], m1[4], p0[4], p1[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) m0[j] = m1[j] = -INFINITY, p0[j] = p1[j] = 0.f;
#pragma unroll
  for (int nt = 0; nt < kBN / 8; ++nt) {
    m0[nt & 3] = fmaxf(m0[nt & 3], fmaxf(acc[nt][0], acc[nt][1]));
    m1[nt & 3] = fmaxf(m1[nt & 3], fmaxf(acc[nt][2], acc[nt][3]));
  }
  float mx0 = quad_max(fmaxf(fmaxf(m0[0], m0[1]), fmaxf(m0[2], m0[3])));
  float mx1 = quad_max(fmaxf(fmaxf(m1[0], m1[1]), fmaxf(m1[2], m1[3])));
  // a row with no real column here keeps a finite reference: ex2 gives 0
  const float nl0 = mx0 == -INFINITY ? 0.f : -mx0 * kLog2e;
  const float nl1 = mx1 == -INFINITY ? 0.f : -mx1 * kLog2e;
#pragma unroll
  for (int nt = 0; nt < kBN / 8; ++nt) {
    p0[nt & 3] += ex2(fmaf(acc[nt][0], kLog2e, nl0)) + ex2(fmaf(acc[nt][1], kLog2e, nl0));
    p1[nt & 3] += ex2(fmaf(acc[nt][2], kLog2e, nl1)) + ex2(fmaf(acc[nt][3], kLog2e, nl1));
  }
  const float s0 = quad_sum((p0[0] + p0[1]) + (p0[2] + p0[3]));
  const float s1 = quad_sum((p1[0] + p1[1]) + (p1[2] + p1[3]));
"""
SERIAL = """  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < kBN / 8; ++nt) {
    mx0 = fmaxf(mx0, fmaxf(acc[nt][0], acc[nt][1]));
    mx1 = fmaxf(mx1, fmaxf(acc[nt][2], acc[nt][3]));
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  const float nl0 = mx0 == -INFINITY ? 0.f : -mx0 * kLog2e;
  const float nl1 = mx1 == -INFINITY ? 0.f : -mx1 * kLog2e;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < kBN / 8; ++nt) {
    s0 += ex2(fmaf(acc[nt][0], kLog2e, nl0)) + ex2(fmaf(acc[nt][1], kLog2e, nl0));
    s1 += ex2(fmaf(acc[nt][2], kLog2e, nl1)) + ex2(fmaf(acc[nt][3], kLog2e, nl1));
  }
  s0 = quad_sum(s0);
  s1 = quad_sum(s1);
"""
# the parent's epilogue store: 4-byte bf16 pairs straight from the
# accumulators to device memory, eight rows a warp instruction
DIRECT = r"""// the logits straight from the accumulators, 4 bytes a thread and row
__device__ __forceinline__ void store_direct(const float (&acc)[kBN / 8][4], int m0, int n0,
                                             const Args& a, int tid) {
  const int r0 = m0 + (tid >> 5) * 16 + ((tid & 31) >> 2), t4 = tid & 3;
  bf16* L = static_cast<bf16*>(a.logits);
#pragma unroll
  for (int nt = 0; nt < kBN / 8; ++nt) {
    const int col = n0 + 8 * nt + 2 * t4;
    if (col < a.Vp) {
      if (r0 < a.rows)
        *reinterpret_cast<uint32_t*>(L + (long long)r0 * a.Vp + col) =
            pack_f32(acc[nt][0], acc[nt][1]);
      if (r0 + 8 < a.rows)
        *reinterpret_cast<uint32_t*>(L + (long long)(r0 + 8) * a.Vp + col) =
            pack_f32(acc[nt][2], acc[nt][3]);
    }
  }
}

"""

VARIANTS = {
    # the tile's vocab width: wgmma m64n128 / m64n192
    "n128": [(_TILE, "constexpr int kBN = 128;")],
    "n192": [(_TILE, "constexpr int kBN = 192;")],
    # the ring's depth (4 is the most that fits beside the staging buffers)
    "2-stages": [(_RING, "constexpr int kStages = 2;")],
    "3-stages": [(_RING, "constexpr int kStages = 3;")],
    # cooperative: both consumers on the two 64-row halves of one 128-row
    # tile at once, sharing each w stage (their epilogues at the same time,
    # with the tensor cores idle); 192 columns with a 4-deep ring, 256 with
    # a 3-deep one
    "cooperative": [(_PP, _COOP), (_TILE, "constexpr int kBN = 192;")],
    "cooperative-n256": [(_PP, _COOP), (_RING, "constexpr int kStages = 3;")],
    "cooperative-n128-6-stages": [(_PP, _COOP), (_TILE, "constexpr int kBN = 128;"),
                                  (_RING, "constexpr int kStages = 6;")],
    # the vocab swept once by all rows (no 8192-row groups)
    "ungrouped": [("constexpr int kGroupRows = 8192;", "constexpr int kGroupRows = 1 << 24;")],
    # the statistics as one chain of maxima and one of sums a row
    "serial-stats": [(_ILP, SERIAL)],
    # the parent's store: straight from registers, no staging, no TMA
    "direct-store": [(_STORE, "      store_direct(acc, m0, n0, a, tid);\n"),
                     (_PICK, DIRECT + _PICK)],
    # ablations
    "no-stats": [(_STATS, "")],
    "no-store": [(_STORE, "")],
    "no-epilogue": [(_STATS, ""), (_STORE, "")],
}


def _build_variant(name: str):
    """(name, (vitrs_head_ce_fwd, vitrs_head_ce_tile) or None, ptxas register
    counts or nvcc's error)."""
    with open(SRC) as f:
        src = f.read()
    for old, new in VARIANTS.get(name, []):
        if old not in src:
            return name, None, f"edit does not apply: {old[:60]!r}"
        src = src.replace(old, new)
    path = os.path.join(OUT, f"fused_head_ce_{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    lib_path = os.path.join(OUT, f"libheadce_{name}.so")
    res = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
                          "-o", lib_path, path], capture_output=True, text=True)
    log = res.stdout + res.stderr
    if res.returncode:
        return name, None, log[-2000:]
    lib = ctypes.CDLL(os.path.abspath(lib_path))
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn, tile = lib.vitrs_head_ce_fwd, lib.vitrs_head_ce_tile
    fn.argtypes = [I, P, P, P, I, I, I, I, LL, LL, P, P, P, P, P, P]
    fn.restype = I
    tile.argtypes = [I]
    tile.restype = I
    attrs = lib.vitrs_head_ce_attrs
    attrs.argtypes = [I, P]
    out = (ctypes.c_int * 6)()
    rc = attrs(0, ctypes.cast(out, P))
    grid = f"grid {out[5]} blocks" if rc == 0 else f"attrs: CUDA error {rc}"
    regs = [line.split("Used ")[1].split(",")[0] for line in log.splitlines()
            if "Used" in line and "registers" in line]
    notes = [line.strip()[:200] for line in log.splitlines()
             if "warning" in line or ("spill stores" in line
                                      and " 0 bytes spill stores" not in line)]
    return name, (fn, tile), "; ".join([grid] + regs + notes)


def _inputs(R, C, Vp, V, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(R, C, generator=g, device="cuda").bfloat16()
    w = (0.02 * torch.randn(Vp, C, generator=g, device="cuda")).bfloat16()
    w[V:] = 0
    t = torch.randint(0, V, (R,), generator=g, device="cuda")
    return x, w, t


# (R, C, Vp, real_vocab): the checks' shapes
CHECKS = [(129, 768, 50304, 50257), (1000, 96, 1152, 1100), (8192, 768, 50304, 50257)]
# the timed shapes: the main path's loss (B=8, T=1024) and twice its rows
TIMED = [(8192, 768, 50304, 50257), (16384, 768, 50304, 50257)]


def _run(fns, x, w, t, V):
    FH._kernel = lambda fns=fns: fns
    return FH.head_ce_fwd_cuda(x, w, t, V)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("names", nargs="*", help=f"variants (default all): {sorted(VARIANTS)}")
    p.add_argument("--no-time", action="store_true", help="checks only")
    args = p.parse_args(argv)
    names = args.names or list(VARIANTS)
    if not torch.cuda.is_available():
        raise SystemExit("head_ce_variants: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
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
    real = FH._kernel
    try:
        for R, C, Vp, V in CHECKS:
            x, w, t = _inputs(R, C, Vp, V, R + C)
            rl, rlse, rpick = FH.head_ce_fwd_plain(x, w, t, V)
            for name, fn in fns.items():
                logits, lse, picked = _run(fn, x, w, t, V)
                torch.cuda.synchronize()
                dl = (logits.float() - rl.float()).abs()
                bad = (dl > 2.0 ** -7 * rl.float().abs() + 1e-5).sum().item()
                print(f"[variants] check {name:14s} R={R} C={C} Vp={Vp}: logits "
                      f"err {dl.max().item():.3e} ({bad} beyond one ulp + 1e-5), "
                      f"lse err {(lse - rlse).abs().max().item():.3e}, picked err "
                      f"{(picked - rpick).abs().max().item():.3e}")
            del rl, rlse, rpick
        if args.no_time:
            return
        # per shape, every variant in the order base, variants, variants
        # reversed, base, so that a drifting clock touches all of them alike
        order = list(fns) + list(fns)[::-1]
        for R, C, Vp, V in TIMED:
            x, w, t = _inputs(R, C, Vp, V, 1)
            times = {}
            for name in order:
                call = lambda: _run(fns[name], x, w, t, V)
                for _ in range(2):
                    call()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(10):
                    call()
                end.record()
                torch.cuda.synchronize()
                times.setdefault(name, []).append(start.elapsed_time(end) / 10)
            flops = 2 * R * C * Vp
            for name, ms in times.items():
                print(f"[variants] R={R:5d} {name:14s} "
                      + " / ".join(f"{m:.4f}" for m in ms) + " ms ("
                      + f"{flops / (sum(ms) / len(ms)) / 1e9:.1f} TFLOP/s)")
    finally:
        FH._kernel = real


if __name__ == "__main__":
    main()
