"""PyTorch port, on the card: rope and the sliding-window band in K1-fwd,
K2, K3 and K4 (csrc/flash_fwd.cu, csrc/flash_bwd.cu), and K8 (csrc/
fused_head_ce.cu), against their plain PyTorch versions.

These need an NVIDIA GPU with sm_90a and nvcc: each test skips without a
CUDA device (decided inside the `cuda` fixture, never at import).  Run them
on the card with
    python -m pytest tests/test_torch_rope_window_cuda.py -q --noconftest
Tolerances as chip_smoke.py's kernels-rope-window and kernels-headce
phases: forward out as `out_errors` (tests/flash_tolerance.py), lse 1e-4
bf16 and 1e-5 fp32 relative to max(1, |lse|), grads 2e-2 abs + rel bf16 and
1e-4 fp32; K8 logits within one bf16 ulp + 1e-5, lse 1e-4, picked 1e-5.
The band-edge inputs (`band_edge_qk`) make a band moved by one key fail."""

import math

import pytest
import torch

from vitrs_tpu_torch.ops import flash_attention as FA
from vitrs_tpu_torch.ops import flash_attention_gqa as FG
from vitrs_tpu_torch.ops import flash_prefill as FP
from vitrs_tpu_torch.ops import fused_head_ce as FH

from flash_tolerance import assert_out_close, band_edge_qk

NH, D = 12, 64
C = NH * D
SCALE = 1.0 / math.sqrt(D)
LSE_TOL = {torch.bfloat16: 1e-4, torch.float32: 1e-5}
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("window", [1, 63, 64, 65, 300])
@pytest.mark.parametrize("T", [37, 700])
@pytest.mark.parametrize("KH", [12, 4, 1])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_band_and_rope_match_plain(cuda, dtype, KH, T, window, rope):
    g = torch.Generator(device=cuda).manual_seed(T + window + KH)
    q, k = band_edge_qk(2, T, T, NH, KH, window, rope=rope, device=cuda)
    v = torch.randn(2, T, KH * D, generator=g, device=cuda)
    do = torch.randn(2, T, C, generator=g, device=cuda)
    q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
    args = (NH, KH, True, SCALE, window, rope)
    if KH == NH:
        fwd = FA.flash_fwd_cuda(q, k, v, NH, True, SCALE, window, rope)
        bwd = FA.flash_bwd_cuda(q, k, v, *fwd, do, NH, True, SCALE, window,
                                rope)
    else:
        fwd = FG.flash_gqa_fwd_cuda(q, k, v, *args)
        bwd = FG.flash_gqa_bwd_cuda(q, k, v, *fwd, do, *args)
    ref = FG.flash_gqa_fwd_plain(q, k, v, *args)
    want = FG.flash_gqa_bwd_plain(q, k, v, *fwd, do, *args)
    torch.cuda.synchronize()
    assert_out_close(fwd[0], ref[0])
    lse_err = ((fwd[1] - ref[1]).abs() / ref[1].abs().clamp_min(1.0)).max()
    assert lse_err <= LSE_TOL[dtype]
    tol = BWD_TOL[dtype]
    for name, a, b in zip(("dq", "dk", "dv"), bwd, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol,
                                   msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.parametrize("sm_scale", [SCALE, 0.1])
@pytest.mark.parametrize("T,window", [(63, 1), (65, 64), (129, 65), (1000, 300)])
@pytest.mark.parametrize("KH", [12, 4, 1])
def test_bwd_rope_band_ragged_scale_deterministic(cuda, KH, T, window,
                                                  sm_scale):
    """bf16 K2/K3-bwd with rope and the band at ragged T, at sm_scale 1/8
    and 0.1 (the pre-pass writes rotated q and k, and then q^), against the
    plain version on band-edge inputs; two calls give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(T + window + KH)
    q, k = band_edge_qk(2, T, T, NH, KH, window, rope=True, device=cuda)
    v = torch.randn(2, T, KH * D, generator=g, device=cuda)
    do = torch.randn(2, T, C, generator=g, device=cuda)
    q, k, v, do = (t.bfloat16() for t in (q, k, v, do))
    args = (NH, KH, True, sm_scale, window, True)
    out, lse = FG.flash_gqa_fwd_plain(q, k, v, *args)
    if KH == NH:
        bwd = lambda: FA.flash_bwd_cuda(q, k, v, out, lse, do, NH, True,
                                        sm_scale, window, True)
    else:
        bwd = lambda: FG.flash_gqa_bwd_cuda(q, k, v, out, lse, do, *args)
    got, again = bwd(), bwd()
    want = FG.flash_gqa_bwd_plain(q, k, v, out, lse, do, *args)
    torch.cuda.synchronize()
    tol = BWD_TOL[torch.bfloat16]
    for name, a, b, c in zip(("dq", "dk", "dv"), got, again, want):
        assert torch.equal(a, b), name
        torch.testing.assert_close(a.float(), c.float(), rtol=tol, atol=tol,
                                   msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.parametrize("window", [1, 65, 1024])
@pytest.mark.parametrize("KH", [4, 12])
def test_prefill_band_matches_plain(cuda, KH, window):
    S, q_off, Tk = 512, 3584, 4352
    q, k = band_edge_qk(2, S, Tk, NH, KH, window, q_off=q_off, device=cuda)
    v = torch.randn(2, Tk, KH * D, device=cuda)
    q, k, v = (t.bfloat16() for t in (q, k, v))
    k[:, q_off + S:] = float("nan")
    v[:, q_off + S:] = float("nan")
    got = FP.flash_prefill_qkv(q, k, v, NH, KH, q_off, window=window)
    want = FP.flash_prefill_plain(q, k, v, NH, KH, q_off, SCALE, window)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert_out_close(got, want)


@pytest.mark.parametrize("R", [100, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_head_ce_matches_plain(cuda, dtype, R):
    V, Vp = 1000, 1024
    g = torch.Generator(device=cuda).manual_seed(R)
    x = torch.randn(R, 128, generator=g, device=cuda).to(dtype)
    w = (0.05 * torch.randn(Vp, 128, generator=g, device=cuda)).to(dtype)
    t = torch.randint(0, V, (R,), generator=g, device=cuda)
    before = FH.head_ce_fwd_cuda.launches
    logits, lse, picked = FH.head_ce_fwd(x, w, t, V)
    rl, rlse, rpick = FH.head_ce_fwd_plain(x, w, t, V)
    torch.cuda.synchronize()
    assert FH.head_ce_fwd_cuda.launches == before + 1
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    assert ((logits.float() - rl.float()).abs()
            <= ulp * rl.float().abs() + 1e-5).all()
    torch.testing.assert_close(lse, rlse, rtol=0, atol=1e-4)
    torch.testing.assert_close(picked, rpick, rtol=0, atol=1e-5)
