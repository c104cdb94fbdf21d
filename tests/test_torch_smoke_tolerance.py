"""The bound chip_smoke.py holds the flash forwards to (`out_errors`, shared
with the card-only tests through tests/flash_tolerance.py), on the CPU at
K4's 8K shape: softmax rows over 7680 keys with scores of unit variance,
as the smoke's random q and k give, so the output's rms is about
sqrt(e / 7680) = 0.019.

  * the kernel's own rounding passes: p rounded to bf16 against another
    max (a relative error of up to 2^-9 before rounding) and the output
    rounded to bf16 on both sides;
  * faults that move the output by a few percent of its rms fail: a
    dropped 64-key tile, and a causal frontier moved by 4 keys;
  * fp32: other summation orders pass at 1e-5, an error of 1e-4 fails."""

import numpy as np
import pytest
import torch

from flash_tolerance import out_errors

B, S, N, D = 2, 64, 7680, 64


def _case(fault):
    rng = np.random.default_rng(0)
    s = torch.from_numpy(rng.standard_normal((B, S, N), dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((N, D), dtype=np.float32))
    v = v.bfloat16().float()
    p = torch.softmax(s, dim=-1)
    want = (p.bfloat16().float() @ v) / p.bfloat16().float().sum(-1, True)
    if fault == "rounding":
        eps = torch.from_numpy(rng.uniform(-2.0 ** -9, 2.0 ** -9, p.shape)
                               .astype(np.float32))
        pk = (p * (1 + eps)).bfloat16().float()
    elif fault == "dropped_tile":
        pk = p.clone()
        pk[..., 4096:4160] = 0.0
    else:                                   # frontier 4 keys short
        pk = p.clone()
        pk[..., -4:] = 0.0
    got = (pk @ v) / pk.sum(-1, keepdim=True)
    return got.bfloat16(), want.bfloat16()


@pytest.mark.parametrize("fault,caught", [("rounding", False),
                                          ("dropped_tile", True),
                                          ("frontier_4", True)])
def test_bf16_bound_passes_rounding_and_fails_faults(fault, caught):
    bad, err, rms = out_errors(*_case(fault))
    assert 0.015 < rms < 0.025
    assert (bad > 0) == caught, (fault, bad, err, rms)
    if caught:
        assert bad > 100


def test_fp32_bound():
    rng = np.random.default_rng(1)
    want = torch.from_numpy(rng.standard_normal((4, 100), dtype=np.float32))
    assert out_errors(want + 1e-6, want)[0] == 0
    assert out_errors(want + 1e-4, want)[0] == want.numel()
