"""Kernel-name groups for the device breakdown: a frozen copy of `GROUPS`
in the port's `vitrs_tpu_torch/utils/profiling.py`.  The first pattern
that matches a kernel's name names its group; no match is "other".

`OWN` and `CUBLAS` are the patterns `eager_share` reads: a kernel matching
neither is an eager PyTorch kernel (elementwise, copy, cast, reduction,
index), as is a device copy or fill.
"""

from __future__ import annotations

import re

GROUPS = (
    ("flash_fwd (K1/K3-fwd/K4)", r"flash_fwd"),
    ("flash_bwd dK/dV", r"flash_bwd_dkv"),
    ("flash_bwd dQ", r"flash_bwd_dq"),
    ("flash_bwd pre-pass", r"flash_bwd_prep"),
    ("fused head + CE (K8)", r"head_ce"),
    ("fused CE (K5/K6)", r"ce_fwd|ce_bwd"),
    ("fused AdamW (K7)", r"adamw"),
    ("cuBLAS matmul", r"nvjet|gemm|cutlass|xmma|cublas"),
    ("index/gather/scatter/scan/sort",
     r"index|Index|gather|Gather|scatter|Scatter|scan|Scan|cumsum|sort|Sort"
     r"|topk|TopK"),
    ("eager reductions", r"reduce|Reduce"),
    ("eager elementwise, copies, casts",
     r"elementwise|Elementwise|vectorized|unrolled|Copy|copy|Functor|fill"),
)

# the port's hand-written kernels (csrc/*.cu)
OWN = r"flash_fwd|flash_bwd|head_ce|\bce_fwd|\bce_bwd|\badamw"
CUBLAS = r"nvjet|gemm|cutlass|xmma|cublas"


def group(name: str) -> str:
    for g, pattern in GROUPS:
        if re.search(pattern, name):
            return g
    return "other"
