"""PyTorch port, on the card: K3 (the GQA forward and backward of
csrc/flash_fwd.cu and csrc/flash_bwd.cu) and K4 (the continuation-prefill
forward of csrc/flash_fwd.cu) against their plain PyTorch versions, at
head dim 64 and, at GPT-2 124M's C = 768, at 32 (24 heads), 128 (6) and
256 (3), and the GQA paths counting their own launches.

These need an NVIDIA GPU with sm_90a and nvcc: each test skips without a
CUDA device (decided inside the `cuda` fixture, never at import).  Run them
on the card with
    python -m pytest tests/test_torch_flash_gqa_cuda.py -q --noconftest
Tolerances as K1/K2's (tests/test_torch_flash_cuda.py,
tests/test_torch_train_cuda.py): forward out as chip_smoke.py's
`out_errors` (tests/flash_tolerance.py: bf16 one ulp of the larger value
plus 2^-6 of the output's rms, fp32 1e-5), lse 1e-4 bf16 and 1e-5 fp32;
bf16 grads 2e-2 abs + rel (p and ds round to bf16 against running
statistics in the kernel and final ones in the plain version, 2^-8
relative each), fp32 grads 1e-4 (other summation orders, over up to
7680 keys and, for dk/dv, up to 12 query heads of a group)."""

import math

import numpy as np
import pytest
import torch

from vitrs_tpu_torch.ops import flash_attention as FA
from vitrs_tpu_torch.ops import flash_attention_gqa as FG
from vitrs_tpu_torch.ops import flash_prefill as FP

from flash_tolerance import assert_out_close

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


def _gqa(cuda, dtype, B, T, KH, seed, d=D):
    g = torch.Generator(device=cuda).manual_seed(seed)
    qkv = torch.randn(B, T, C + 2 * KH * d, generator=g, device=cuda)
    do = torch.randn(B, T, C, generator=g, device=cuda)
    return qkv.to(dtype), do.to(dtype)


# (head dim, kv heads) at C = 768: 64's as before, then GQA and MQA at the
# other head dims
GEOMS = [(64, 4), (64, 1), (64, 3), (32, 8), (32, 1), (128, 2), (128, 1),
         (256, 1)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [1, 37, 200, 1024])
@pytest.mark.parametrize("d,KH", GEOMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gqa_fwd_and_bwd_match_plain(cuda, dtype, d, KH, T, causal):
    nh, sm = C // d, 1.0 / math.sqrt(d)
    qkv, do = _gqa(cuda, dtype, 2, T, KH, T + KH, d)
    q, k, v = FG.split_gqa(qkv, nh, KH)
    b_fwd, b_bwd = FG.flash_gqa_fwd_cuda.launches, FG.flash_gqa_bwd_cuda.launches
    k1, k2 = FA.flash_fwd_cuda.launches, FA.flash_bwd_cuda.launches
    out, lse = FG.flash_gqa_fwd_cuda(q, k, v, nh, KH, causal, sm)
    ref, ref_lse = FG.flash_gqa_fwd_plain(q, k, v, nh, KH, causal, sm)
    got = FG.flash_gqa_bwd_cuda(q, k, v, out, lse, do, nh, KH, causal, sm)
    want = FG.flash_gqa_bwd_plain(q, k, v, out, lse, do, nh, KH, causal, sm)
    torch.cuda.synchronize()
    assert (FG.flash_gqa_fwd_cuda.launches, FG.flash_gqa_bwd_cuda.launches) \
        == (b_fwd + 1, b_bwd + 1)
    assert (FA.flash_fwd_cuda.launches, FA.flash_bwd_cuda.launches) == (k1, k2)
    assert_out_close(out, ref)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=LSE_TOL[dtype])
    tol = BWD_TOL[dtype]
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol,
                                   msg=name)
    assert got[1].shape == (2, T, KH * d)


@pytest.mark.parametrize("sm_scale", [SCALE, 0.1])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [63, 65, 127, 128, 129, 1000])
@pytest.mark.parametrize("KH", [4, 1, 3])
def test_gqa_bwd_ragged_scale_deterministic(cuda, KH, T, causal, sm_scale):
    """bf16 K3-bwd at ragged T around its 64-row tiles, at sm_scale 1/8 (s
    scaled in fp32) and 0.1 (q^ from the pre-pass), against its plain
    version; two calls give the same bits (no atomics)."""
    qkv, do = _gqa(cuda, torch.bfloat16, 2, T, KH, T + 7 * KH)
    q, k, v = FG.split_gqa(qkv, NH, KH)
    args = (NH, KH, causal, sm_scale)
    out, lse = FG.flash_gqa_fwd_cuda(q, k, v, *args)
    got = FG.flash_gqa_bwd_cuda(q, k, v, out, lse, do, *args)
    again = FG.flash_gqa_bwd_cuda(q, k, v, out, lse, do, *args)
    want = FG.flash_gqa_bwd_plain(q, k, v, out, lse, do, *args)
    torch.cuda.synchronize()
    tol = BWD_TOL[torch.bfloat16]
    for name, a, b, c in zip(("dq", "dk", "dv"), got, again, want):
        assert torch.equal(a, b), name
        torch.testing.assert_close(a.float(), c.float(), rtol=tol, atol=tol,
                                   msg=name)


@pytest.mark.parametrize("T", [63, 64, 65, 127, 128, 129])
@pytest.mark.parametrize("KH", [4, 1])
def test_gqa_fwd_ring_edges_and_repeatable(cuda, KH, T):
    """K3-fwd at T around the 64-row tiles and the K/V ring, causal (the
    frontier ends mid-tile) and full, launched twice: the same bits, and
    within the bound of the plain version."""
    qkv, _ = _gqa(cuda, torch.bfloat16, 2, T, KH, 2000 + T)
    q, k, v = FG.split_gqa(qkv, NH, KH)
    for causal in (True, False):
        args = (NH, KH, causal, SCALE)
        got, again = (FG.flash_gqa_fwd_cuda(q, k, v, *args) for _ in range(2))
        out, lse = FG.flash_gqa_fwd_plain(q, k, v, *args)
        torch.cuda.synchronize()
        assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
        assert_out_close(got[0], out)
        torch.testing.assert_close(got[1], lse, rtol=0, atol=LSE_TOL[torch.bfloat16])


def test_gqa_autograd_runs_k3_both_ways(cuda):
    qkv, do = _gqa(cuda, torch.bfloat16, 2, 100, 4, 0)
    qkv.requires_grad_(True)
    before = (FG.flash_gqa_fwd_cuda.launches, FG.flash_gqa_bwd_cuda.launches)
    FG.flash_gqa_qkv(qkv, NH, 4).backward(do)
    torch.cuda.synchronize()
    assert (FG.flash_gqa_fwd_cuda.launches,
            FG.flash_gqa_bwd_cuda.launches) == (before[0] + 1, before[1] + 1)
    assert qkv.grad.shape == qkv.shape and torch.isfinite(qkv.grad).all()


@pytest.mark.parametrize("S,q_off,Tk", [(512, 512, 1024), (200, 133, 512),
                                        (64, 7000, 7168), (512, 7168, 7936),
                                        (100, 1001, 1280), (1, 517, 768),
                                        (129, 7103, 7424)])
@pytest.mark.parametrize("d,KH", [(64, 4), (64, 12), (32, 8), (128, 2),
                                  (128, 6), (256, 1)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_prefill_matches_plain_and_never_reads_the_tail(cuda, dtype, d, KH,
                                                        S, q_off, Tk):
    nh = C // d
    g = torch.Generator(device=cuda).manual_seed(S + q_off + KH)
    q = torch.randn(2, S, C, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(2, Tk, KH * d, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    k[:, q_off + S:] = float("nan")
    v[:, q_off + S:] = float("nan")
    before = FP.flash_prefill_cuda.launches
    got = FP.flash_prefill_qkv(q, k, v, nh, KH, q_off)
    again = FP.flash_prefill_qkv(q, k, v, nh, KH, q_off)
    want = FP.flash_prefill_plain(q, k, v, nh, KH, q_off, 1.0 / math.sqrt(d))
    torch.cuda.synchronize()
    assert FP.flash_prefill_cuda.launches == before + 2
    assert torch.isfinite(got).all() and torch.equal(got, again)
    assert_out_close(got, want)


def test_chunked_generate_goes_through_k3_and_k4(cuda):
    """fp32 chunked generate on the card: the first chunk through K3-fwd,
    the continuation chunks through K4, the same greedy tokens as on the
    CPU (plain versions)."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.models import generate as G
    from vitrs_tpu_torch.models import model as M
    cfg = get_config("gpt-nano").replace(num_layers=2, num_heads=4,
                                         num_kv_heads=2, channels=256,
                                         max_seq_len=64)
    params = P.init_params(cfg, torch.Generator().manual_seed(0))
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 48)))
    outs = {}
    for dev in ("cuda", "cpu"):
        FG.flash_gqa_fwd_cuda.launches = FP.flash_prefill_cuda.launches = 0
        pp = M.prepare_params({k: t.to(dev) for k, t in params.items()}, cfg)
        outs[dev] = G.generate(pp, prompt.to(dev), cfg, max_new=8,
                               temperature=0.0, prefill_chunk=16).cpu()
        want = (2, 4) if dev == "cuda" else (0, 0)
        assert (FG.flash_gqa_fwd_cuda.launches,
                FP.flash_prefill_cuda.launches) == want
    torch.testing.assert_close(outs["cuda"], outs["cpu"], rtol=0, atol=0)
