"""Variants of csrc/flash_fwd.cu (K1-fwd, K3-fwd, K4) timed beside it on the
card: the measurements behind the forward's design choices (PERF.md §6).

A variant is a named list of textual edits of the source, each replacing
every occurrence of its text.  The script builds the source and each chosen
variant with nvcc, all at once, into `_build/variants/`, checks each
against the plain version at ragged shapes (rope, the band, GQA, a query
offset), then times the bf16 forward with CUDA events at the main path's
shapes, in the order base, variants, variants reversed, base, and prints
one line per variant and shape.

    python -m vitrs_tpu_torch.utils.fwd_variants              # every variant
    python -m vitrs_tpu_torch.utils.fwd_variants rope-in-smem

Design alternatives compute the same function; ablations (no-*) compute a
wrong one on purpose and only show what a part of the kernel costs.  Needs
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

NH, D = 12, 64
C = NH * D
SRC = os.path.join(_build.CSRC_DIR, "flash_fwd.cu")
OUT = os.path.join(_build.BUILD_DIR, "variants")

ROT = r"""    if constexpr (kRope) {
      const uint32_t ks = KS;
      uint8_t* const kt = smem + (ks - smem_u32(smem));
      const int r = tid >> 1, j = KN0 + r;
      if (j < a.seq_len) {
#pragma unroll
        for (int c = (tid & 1) * 16; c < (tid & 1) * 16 + 16; c += 2) {
          __nv_bfloat162* lo = reinterpret_cast<__nv_bfloat162*>(kt + Tile::offset(r, c));
          __nv_bfloat162* hi = reinterpret_cast<__nv_bfloat162*>(kt + Tile::offset(r, c + kHalf));
          float x1 = __bfloat162float(lo->x), x2 = __bfloat162float(hi->x);
          float y1 = __bfloat162float(lo->y), y2 = __bfloat162float(hi->y);
          const float* cs = a.rope_cos + (long long)j * kHalf + c;
          const float* sn_ = a.rope_sin + (long long)j * kHalf + c;
          rope_pair(x1, x2, cs[0], sn_[0]);
          rope_pair(y1, y2, cs[1], sn_[1]);
          *lo = __floats2bfloat162_rn(x1, y1);
          *hi = __floats2bfloat162_rn(x2, y2);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
"""

VARIANTS = {
    # a 3-deep K/V ring (58 KB: three blocks an SM instead of five)
    "3-stages": [("constexpr int kStages = 2;", "constexpr int kStages = 3;"),
                 ("__launch_bounds__(128, kMinBlocks)", "__launch_bounds__(128, 3)")],
    # a 128-row q block: two warpgroups sharing each staged K/V tile (half
    # the K/V traffic per q row), each skipping the tiles outside its own
    # rows' range; 3-deep ring, 66 KB, two blocks an SM
    "2-warpgroups": [
        ("constexpr int kStages = 2;      // depth of the K/V ring",
         "constexpr int kStages = 3;      // depth of the K/V ring\n"
         "constexpr int kWarpgroups = 2;  // per block, each kBlockM q rows sharing every K/V tile"),
        ("  return 1024 + kStages * kStageBytes + kTile + kStages * 8;",
         "  return 1024 + kStages * kStageBytes + kWarpgroups * kTile + kStages * 8;"),
        ("""__global__ void __launch_bounds__(128, kMinBlocks)
    flash_fwd_wgmma(const __grid_constant__ Maps maps, Args a) {
  extern __shared__ uint8_t smem[];
  const uint32_t base = aligned_base(smem);   // stage st: K at + 2 st kTile, V after it
  const uint32_t sq = base + kStages * kStageBytes;
  const uint32_t bars = sq + kTile;
  uint8_t* const q_tile = smem + (sq - smem_u32(smem));
  const int b = blockIdx.x / a.num_heads, h = blockIdx.x % a.num_heads;
  const int hk = h / a.group;   // this query head's kv head
  // causal: the heaviest q tiles (most kv tiles) first
  const int m0 = (a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kBlockM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = m0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8

  const int kv_start = kv_start_of<kBand>(a, m0, kBlockN);
  const int n_it = (kv_end_of(a, m0) - kv_start + kBlockN - 1) / kBlockN;
""",
         """__global__ void __launch_bounds__(128 * kWarpgroups, 5 / kWarpgroups)
    flash_fwd_wgmma(const __grid_constant__ Maps maps, Args a) {
  extern __shared__ uint8_t smem[];
  const uint32_t base = aligned_base(smem);   // stage st: K at + 2 st kTile, V after it
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t sq = base + kStages * kStageBytes + wg * kTile;   // this warpgroup's Q tile
  const uint32_t bars = base + kStages * kStageBytes + kWarpgroups * kTile;
  uint8_t* const q_tile = smem + (sq - smem_u32(smem));
  const int b = blockIdx.x / a.num_heads, h = blockIdx.x % a.num_heads;
  const int hk = h / a.group;   // this query head's kv head
  // causal: the heaviest q blocks (most kv tiles) first
  const int mb = (a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kBlockM * kWarpgroups;
  const int m0 = mb + wg * kBlockM;   // this warpgroup's q tile
  const int r0 = m0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8

  // the block's kv tiles: from the first warpgroup's band start to the
  // causal frontier of the last one holding q rows; each warpgroup skips
  // the tiles outside its own range
  const int last = min(mb + (kWarpgroups - 1) * kBlockM, (a.tq - 1) / kBlockM * kBlockM);
  const int kv_start = kv_start_of<kBand>(a, mb, kBlockN);
  const int n_it = (kv_end_of(a, last) - kv_start + kBlockN - 1) / kBlockN;
  const int my_start = kv_start_of<kBand>(a, m0, kBlockN);
  const int my_end = m0 < a.tq ? kv_end_of(a, m0) : 0;
"""),
        # the Q tile and out of a warpgroup: its own 64 rows
        ("  const int tid = threadIdx.x, r = tid >> 1, row = m0 + r;",
         "  const int tid = threadIdx.x, r = (tid & 127) >> 1, row = m0 + r;"),
        ("  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n"
         "  const int g = lane >> 2, t = lane & 3;\n  float inv[2];\n  finish_rows",
         "  const int tid = threadIdx.x, warp = (tid >> 5) & 3, lane = tid & 31;\n"
         "  const int g = lane >> 2, t = lane & 3;\n  float inv[2];\n  finish_rows"),
        ("  const int r = tid >> 1, row = m0 + r;\n  if (row < a.tq) {",
         "  const int r = (tid & 127) >> 1, row = m0 + r;\n  if (row < a.tq) {"),
        ("""    const uint32_t sk = base + st * kStageBytes, sv = sk + kTile;
    mbar_wait(bars + 8 * st, (it / kStages) & 1);

    // S = Q K^T for 64 rows x 64 keys
    float s[kBlockN / 8][4];
    wg_fence();
    product_rows<kHeadDim>(s, sq, sk);
    wg_commit();
    // every warp is past tile it - 1's products: refill its stage while
    // this tile's run
    __syncthreads();
    if (it > 0) issue(it + kStages - 1);
    wg_wait<0>();""",
         """    const uint32_t sk = base + st * kStageBytes, sv = sk + kTile;
    const bool mine = n0 >= my_start && n0 < my_end;   // uniform in the warpgroup
    mbar_wait(bars + 8 * st, (it / kStages) & 1);

    // S = Q K^T for 64 rows x 64 keys
    float s[kBlockN / 8][4];
    if (mine) {
      wg_fence();
      product_rows<kHeadDim>(s, sq, sk);
      wg_commit();
    }
    // every warp is past tile it - 1's products: refill its stage while
    // this tile's run
    __syncthreads();
    if (it > 0) issue(it + kStages - 1);
    if (!mine) continue;
    wg_wait<0>();"""),
        ("""  const unsigned tiles = (a.tq + kBlockM - 1) / kBlockM;
  kernel<<<dim3(batch * a.num_heads, tiles, kHeadDim / kSlice), 128, fwd_smem(), s>>>(maps, a);""",
         """  const unsigned blocks = (a.tq + kBlockM * kWarpgroups - 1) / (kBlockM * kWarpgroups);
  kernel<<<dim3(batch * a.num_heads, blocks, kHeadDim / kSlice), 128 * kWarpgroups, fwd_smem(),
           s>>>(maps, a);"""),
    ],
    # q tiles in launch order (lightest first under the causal mask)
    "light-first": [("(a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kBlockM",
                     "blockIdx.y * kBlockM")],
    # under rope, each staged K tile rotated in shared memory (then read by
    # wgmma) instead of the pre-pass's rotated copy in device memory
    "rope-in-smem": [
        ("  if (kRope) {\n    const long long threads", "  if (false) {\n    const long long threads"),
        ("    const uint32_t sk = base + st * kStageBytes, sv = sk + kTile;\n"
         "    mbar_wait(bars + 8 * st, (it / kStages) & 1);\n",
         "    const uint32_t sk = base + st * kStageBytes, sv = sk + kTile;\n"
         "    mbar_wait(bars + 8 * st, (it / kStages) & 1);\n"
         + ROT.replace("KS", "sk").replace("KN0", "n0"))],
    # ablations
    "no-exp": [("ex2(fmaf(s[nt][0], kLog2e, nl_a))", "fmaf(s[nt][0], kLog2e, nl_a)"),
               ("ex2(fmaf(s[nt][1], kLog2e, nl_a))", "fmaf(s[nt][1], kLog2e, nl_a)"),
               ("ex2(fmaf(s[nt][2], kLog2e, nl_b))", "fmaf(s[nt][2], kLog2e, nl_b)"),
               ("ex2(fmaf(s[nt][3], kLog2e, nl_b))", "fmaf(s[nt][3], kLog2e, nl_b)")],
    "no-pv": [("    product_cols<kSlice>(o, pa, sv);\n", "")],
    "no-s": [("    product_rows<kHeadDim>(s, sq, sk);\n", "    zero(s);\n")],
}


def _build_variant(name: str):
    """(name, ctypes function or None, ptxas register counts or nvcc's error)."""
    with open(SRC) as f:
        src = f.read()
    for old, new in VARIANTS.get(name, []):
        if old not in src:
            return name, None, f"edit does not apply: {old[:60]!r}"
        src = src.replace(old, new)
    path = os.path.join(OUT, f"flash_fwd_{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(OUT, f"libfwd_{name}.so")
    res = subprocess.run([_build.nvcc(), *_build.flags_for(D), "-I",
                          _build.CSRC_DIR, "-o", lib, path],
                         capture_output=True, text=True)
    log = res.stdout + res.stderr
    if res.returncode:
        return name, None, log[-2000:]
    fn = ctypes.CDLL(os.path.abspath(lib)).vitrs_flash_fwd
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [I] + [P] * 6 + [LL] * 8 + [I] * 9 + [ctypes.c_float, P, P, P]
    fn.restype = I
    regs = [line.split("Used ")[1].split(",")[0] for line in log.splitlines()
            if "Used" in line and "registers" in line]
    notes = [line.strip() for line in log.splitlines() if "wgmma" in line]
    return name, fn, "; ".join(regs + notes)


def _qkv(B, T, KH, seed, Tk=None):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, T, C, generator=g, device="cuda").bfloat16()
    k, v = (torch.randn(B, Tk or T, KH * D, generator=g, device="cuda").bfloat16()
            for _ in range(2))
    return q, k, v


# (B, T, KH, q_off, Tk, causal, W, rope): the checks' shapes
CHECKS = [(1, 128, 12, 0, 128, False, 0, False), (1, 128, 12, 0, 128, True, 0, False),
          (2, 65, 12, 0, 65, False, 0, False), (2, 1000, 4, 0, 1000, True, 0, False),
          (2, 1000, 1, 0, 1000, True, 300, True), (2, 200, 4, 1001, 1280, True, 0, False),
          (2, 700, 12, 0, 700, True, 65, True)]
# the timed shapes: K1-fwd, K3-fwd, K4 at the 8K prompt's last chunk, K1-fwd
# with rope + band at T=8192, K4 with the band at the serving shape
TIMED = [("K1-fwd", 8, 1024, 12, 0, 1024, 0, False),
         ("K3-fwd", 8, 1024, 4, 0, 1024, 0, False),
         ("K4", 8, 512, 4, 7168, 7936, 0, False),
         ("K1-fwd rope W=1024 T=8192", 2, 8192, 12, 0, 8192, 1024, True),
         ("K4 W=1024", 8, 512, 12, 7168, 7936, 1024, False),
         ("K1-fwd T=8192 W=0 rope", 2, 8192, 12, 0, 8192, 0, True)]


def _run(fn, q, k, v, KH, q_off, causal, W, rope):
    FA._kernel = lambda head_dim, fn=fn: fn
    return FA.launch_fwd("variant", q, k, v, NH, KH, causal, 0.125, q_off, W, rope)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("names", nargs="*", help=f"variants (default all): {sorted(VARIANTS)}")
    p.add_argument("--no-time", action="store_true", help="checks only")
    args = p.parse_args(argv)
    names = args.names or list(VARIANTS)
    if not torch.cuda.is_available():
        raise SystemExit("fwd_variants: needs a CUDA device")
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
    real = FA._kernel
    try:
        for B, T, KH, q_off, Tk, causal, W, rope in CHECKS:
            q, k, v = _qkv(B, T, KH, T + KH, Tk)
            if causal:
                k[:, q_off + T:] = float("nan")
                v[:, q_off + T:] = float("nan")
            out, lse = FA.flash_fwd_plain(q, k, v, NH, causal, 0.125, KH, q_off, W, rope)
            for name, fn in fns.items():
                got, glse = _run(fn, q, k, v, KH, q_off, causal, W, rope)
                torch.cuda.synchronize()
                d = (got.float() - out.float()).abs()
                dl = (glse - lse).abs()
                rows = d.amax(dim=(0, 2))
                bad = [i // 64 for i in range(T) if rows[i] > 0.05]
                print(f"[variants] check {name:12s} B={B} T={T} KH={KH} q_off={q_off} "
                      f"causal={int(causal)} W={W} rope={int(rope)}: out err "
                      f"{d.max().item():.3e}, lse err {dl.max().item():.3e}, q tiles "
                      f"off by > 0.05: {sorted(set(bad))}")
        if args.no_time:
            return
        # per shape, every variant in the order base, variants, variants
        # reversed, base, so that a drifting clock touches all of them alike
        order = list(fns) + list(fns)[::-1]
        for label, B, T, KH, q_off, Tk, W, rope in TIMED:
            q, k, v = _qkv(B, T, KH, 1, Tk)
            times = {}
            for name in order:
                call = lambda: _run(fns[name], q, k, v, KH, q_off, True, W, rope)
                for _ in range(3):
                    call()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(30):
                    call()
                end.record()
                torch.cuda.synchronize()
                times.setdefault(name, []).append(start.elapsed_time(end) / 30)
            for name, ms in times.items():
                print(f"[variants] {label:26s} {name:12s} "
                      + " / ".join(f"{t:.4f}" for t in ms) + " ms")
    finally:
        FA._kernel = real


if __name__ == "__main__":
    main()
