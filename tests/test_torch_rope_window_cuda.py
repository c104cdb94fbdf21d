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


@pytest.mark.parametrize("T", [1, 63, 64, 65, 127, 128, 129])
@pytest.mark.parametrize("KH", [12, 4])
def test_fwd_rope_band_ring_edges_and_repeatable(cuda, KH, T):
    """The bf16 forward with rope (k rotated by the pre-pass) and the band
    (W=65: the band's edge crosses every tile from T=65 on) at T around
    the 64-row tiles and the K/V ring, launched twice: the same bits, and
    within the bound of the plain version."""
    W = 65
    g = torch.Generator(device=cuda).manual_seed(3000 + T)
    q, k = band_edge_qk(2, T, T, NH, KH, W, rope=True, device=cuda)
    v = torch.randn(2, T, KH * D, generator=g, device=cuda)
    q, k, v = (t.bfloat16() for t in (q, k, v))
    args = (NH, KH, True, SCALE, W, True)
    got, again = (FG.flash_gqa_fwd_cuda(q, k, v, *args) if KH < NH else
                  FA.flash_fwd_cuda(q, k, v, NH, True, SCALE, W, True)
                  for _ in range(2))
    ref = FG.flash_gqa_fwd_plain(q, k, v, *args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    assert_out_close(got[0], ref[0])
    lse_err = ((got[1] - ref[1]).abs() / ref[1].abs().clamp_min(1.0)).max()
    assert lse_err <= LSE_TOL[torch.bfloat16]


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


# (R, C, Vp, real_vocab) around K8's tiles (bf16: 64 rows x 256 vocab
# columns, 64-wide k steps): ragged R, C 64 .. 1600 (96: a half k step;
# 1600: gpt2-1558m), every Vp but 1024 leaves a ragged last vocab tile
HEAD_CE_CASES = [(100, 128, 1024, 1000), (1024, 128, 1152, 1100),
                 (1, 768, 50304, 50257), (127, 768, 50304, 50257),
                 (129, 768, 50304, 50257), (8191, 768, 50304, 50257),
                 (256, 64, 1152, 1100), (129, 96, 1152, 1100),
                 (300, 1600, 50304, 50257), (200, 768, 128, 100)]


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("R,C,Vp,V", HEAD_CE_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_head_ce_matches_plain(cuda, dtype, R, C, Vp, V, strided):
    """K8 against its plain version; x and w column slices of wider rows
    (strided: bf16 reads them in place by TMA); targets on the last real
    column, in the pad columns and out of range pick NaN; two calls give
    the same bits.  w is scaled by sqrt(128 / C), so that a logit keeps
    the size (std about 0.57) the absolute picked bound was set for at
    every C: two fp32 sums of C products in other orders differ by about
    4e-6 of their size."""
    g = torch.Generator(device=cuda).manual_seed(R + C)
    pad = 64 * strided
    x = torch.randn(R, C + pad, generator=g, device=cuda).to(dtype)[:, :C]
    w_scale = 0.05 * math.sqrt(128 / C)
    w = (w_scale * torch.randn(Vp, C + pad, generator=g, device=cuda)).to(dtype)
    w = w[:, :C]
    t = torch.randint(0, V, (R,), generator=g, device=cuda)
    special = [V - 1, V, Vp + 5, -1][:R]
    t[:len(special)] = torch.tensor(special, device=cuda)
    before = FH.head_ce_fwd_cuda.launches
    logits, lse, picked = FH.head_ce_fwd(x, w, t, V)
    again = FH.head_ce_fwd(x, w, t, V)
    rl, rlse, rpick = FH.head_ce_fwd_plain(x, w, t.clamp(0, Vp - 1), V)
    torch.cuda.synchronize()
    assert FH.head_ce_fwd_cuda.launches == before + 2
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    assert ((logits.float() - rl.float()).abs()
            <= ulp * rl.float().abs() + 1e-5).all()
    torch.testing.assert_close(lse, rlse, rtol=0, atol=1e-4)
    real = (t >= 0) & (t < V)
    torch.testing.assert_close(picked[real], rpick[real], rtol=0, atol=1e-5)
    assert picked[~real].isnan().all()
    for a, b in zip((logits, lse, picked), again):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("what", ["x base", "x row stride", "w broadcast",
                                  "w columns strided"])
def test_head_ce_refuses_views_tma_cannot_map(cuda, what):
    """A bf16 x or w that TMA cannot map raises ValueError before any
    launch: there is no fallback."""
    R, C, Vp, V = 64, 768, 1024, 1000
    buf = torch.randn(R * C + 8, device=cuda).bfloat16()
    x = buf[:R * C].view(R, C)
    w = torch.randn(Vp, C, device=cuda).bfloat16()
    t = torch.randint(0, V, (R,), device=cuda)
    if what == "x base":
        x = buf[1:1 + R * C].view(R, C)
    elif what == "x row stride":
        x = torch.randn(R, C + 1, device=cuda).bfloat16()[:, :C]
    elif what == "w broadcast":
        w = w[:1].expand(Vp, C)
    else:
        w = torch.randn(C, Vp, device=cuda).bfloat16().t()
    before = FH.head_ce_fwd_cuda.launches
    with pytest.raises(ValueError, match="TMA"):
        FH.head_ce_fwd_cuda(x, w, t, V)
    assert FH.head_ce_fwd_cuda.launches == before
