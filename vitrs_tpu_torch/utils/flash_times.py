"""Device ms of the flash kernels on the square training path: K1-fwd / K2
and K3-fwd / K3-bwd (4 kv heads) at B=8 T=1024 causal, and both with rope
and the band (W=1024) at B=2 T=8192, all at head dim 64; then K1-fwd / K2 at
B=8 T=1024 causal at head dims 32, 128 and 256 (GPT-2 124M's width: 24, 6
and 3 heads).  Each is the profiler's kernel time of one call
(utils/profiling.op_breakdown), from captures that caught every kernel of
their calls.  Prints the card's name and power limit, then one JSON line
{shape: {"fwd": [ms, ...], "bwd": [ms, ...]}}.

    python vitrs_tpu_torch/utils/flash_times.py [ROOT]

ROOT is the checkout whose package is timed (default: the one this file is
in), so that one call can time two checkouts in turns (parent, change,
change, parent) and compare them on one card.  It calls only the wrappers'
square-block arguments, which every version of the port takes.  Needs a
CUDA device and nvcc.
"""

import json
import os
import subprocess
import sys

NH, D = 12, 64
C = NH * D
# (name, B, T, kv_heads, window, rope)
SHAPES = (("K1-fwd/K2 B=8 T=1024", 8, 1024, NH, 0, False),
          ("K3 KH=4 B=8 T=1024", 8, 1024, 4, 0, False),
          ("K1-fwd/K2 rope W=1024 B=2 T=8192", 2, 8192, NH, 1024, True),
          ("K3 KH=4 rope W=1024 B=2 T=8192", 2, 8192, 4, 1024, True))
# (name, head dim): the other head dims' square rows, MHA at C = 768
HEAD_DIM_SHAPES = (("K1-fwd/K2 D=32 B=8 T=1024", 32), ("K1-fwd/K2 D=128 B=8 T=1024", 128),
                   ("K1-fwd/K2 D=256 B=8 T=1024", 256))
CAPTURES, ITERS = 3, 20


def _device_ms(fn, kernels):
    """One call's device ms from each of CAPTURES captures of ITERS calls
    that caught `kernels` kernels a call (a capture that missed some is
    taken again, up to 3 times)."""
    from vitrs_tpu_torch.utils import profiling
    got = []
    for _ in range(3 * CAPTURES):
        r = profiling.op_breakdown(fn, ITERS)
        if r["kernels"] == kernels * ITERS:
            got.append(r["busy_ms"])
            if len(got) == CAPTURES:
                break
    return got


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.abspath(argv[0] if argv else os.path.join(here, "..", ".."))
    sys.path.insert(0, root)
    import torch
    from vitrs_tpu_torch.ops import flash_attention as FA
    from vitrs_tpu_torch.ops import flash_attention_gqa as FG
    if not torch.cuda.is_available():
        raise SystemExit("flash_times: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(16)
    res = {"root": root}
    for name, B, T, kh, W, rope in SHAPES:
        q, do = (torch.randn(B, T, C, generator=gen, device="cuda").bfloat16()
                 for _ in range(2))
        k, v = (torch.randn(B, T, kh * D, generator=gen,
                            device="cuda").bfloat16() for _ in range(2))
        if kh == NH:
            def fwd():
                return FA.flash_fwd_cuda(q, k, v, NH, True, 0.125, W, rope)

            def bwd():
                return FA.flash_bwd_cuda(q, k, v, out, lse, do, NH, True,
                                         0.125, W, rope)
        else:
            def fwd():
                return FG.flash_gqa_fwd_cuda(q, k, v, NH, kh, True, 0.125, W,
                                             rope)

            def bwd():
                return FG.flash_gqa_bwd_cuda(q, k, v, out, lse, do, NH, kh,
                                             True, 0.125, W, rope)
        out, lse = fwd()
        res[name] = {"fwd": _device_ms(fwd, 2 if rope else 1),
                     "bwd": _device_ms(bwd, 3)}
        del q, do, k, v, out, lse
    for name, d in HEAD_DIM_SHAPES:
        nh, sm = C // d, d ** -0.5
        q, do, k, v = (torch.randn(8, 1024, C, generator=gen, device="cuda")
                       .bfloat16() for _ in range(4))
        out, lse = FA.flash_fwd_cuda(q, k, v, nh, True, sm)
        res[name] = {
            "fwd": _device_ms(lambda: FA.flash_fwd_cuda(q, k, v, nh, True, sm), 1),
            "bwd": _device_ms(lambda: FA.flash_bwd_cuda(q, k, v, out, lse, do, nh,
                                                        True, sm), 3)}
        del q, do, k, v, out, lse
    print(json.dumps(res))


if __name__ == "__main__":
    main()
