"""PyTorch port, on the card: K1-fwd (csrc/flash_fwd.cu) against its plain
version at the serving shapes, at every head dim the kernels are built for
(32, 64, 128, 256 at GPT-2 124M's C = 768: 24, 12, 6, 3 heads), K2
(csrc/flash_bwd.cu) at the head dims beside it (bitwise repeatable), rope
and the band at 32 and 128, and the CUDA prefill counting its launches.

These need an NVIDIA GPU with sm_90a and nvcc: each test skips without a
CUDA device (decided inside the `cuda` fixture, never at import).  Run them
on the card with
    python -m pytest tests/test_torch_flash_cuda.py -q
Tolerances as in chip_smoke.py: out as its `out_errors`
(tests/flash_tolerance.py), lse 1e-4 bf16 and 1e-5 fp32; gradients as
tests/test_torch_flash_gqa_cuda.py's (2e-2 bf16, 1e-4 fp32)."""

import math

import numpy as np
import pytest
import torch

from vitrs_tpu_torch.ops import flash_attention as FA

from flash_tolerance import assert_out_close

LSE_TOL = {torch.bfloat16: 1e-4, torch.float32: 1e-5}
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
C = 768
HEADS = {32: 24, 64: 12, 128: 6, 256: 3}   # heads of each head dim at C = 768


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [1, 37, 64, 200, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
def test_kernel_matches_plain(cuda, D, dtype, T, causal):
    NH, sm = HEADS[D], 1.0 / math.sqrt(D)
    g = torch.Generator(device=cuda).manual_seed(T)
    qkv = torch.randn(2, T, 3 * C, generator=g, device=cuda).to(dtype)
    q, k, v = qkv.split(C, dim=-1)
    before = FA.flash_fwd_cuda.launches
    out, lse = FA.flash_fwd_cuda(q, k, v, NH, causal, sm)
    ref, ref_lse = FA.flash_fwd_plain(q, k, v, NH, causal, sm)
    torch.cuda.synchronize()
    assert FA.flash_fwd_cuda.launches == before + 1
    assert_out_close(out, ref)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=LSE_TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [1, 37, 65, 200, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
def test_bwd_matches_plain_and_repeats(cuda, D, dtype, T, causal):
    """K2 at each head dim (D = 128's 1/sqrt(128) and D = 32's take q^
    from the pre-pass, D = 256's 1/16 scales s in fp32; D >= 128 runs the
    two-warpgroup dK/dV block) against its plain version; two calls give
    the same bits (no atomics)."""
    NH, sm = HEADS[D], 1.0 / math.sqrt(D)
    g = torch.Generator(device=cuda).manual_seed(7 * T + D)
    qkv = torch.randn(2, T, 3 * C, generator=g, device=cuda).to(dtype)
    do = torch.randn(2, T, C, generator=g, device=cuda).to(dtype)
    q, k, v = qkv.split(C, dim=-1)
    out, lse = FA.flash_fwd_cuda(q, k, v, NH, causal, sm)
    before = FA.flash_bwd_cuda.launches
    got = FA.flash_bwd_cuda(q, k, v, out, lse, do, NH, causal, sm)
    again = FA.flash_bwd_cuda(q, k, v, out, lse, do, NH, causal, sm)
    want = FA.flash_bwd_plain(q, k, v, out, lse, do, NH, causal, sm)
    torch.cuda.synchronize()
    assert FA.flash_bwd_cuda.launches == before + 2
    tol = BWD_TOL[dtype]
    for name, a, b, c in zip(("dq", "dk", "dv"), got, again, want):
        assert torch.equal(a, b), name
        torch.testing.assert_close(a.float(), c.float(), rtol=tol, atol=tol,
                                   msg=name)


@pytest.mark.parametrize("T,window", [(200, 64), (1000, 65), (1000, 1)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [32, 128])
def test_rope_window_matches_plain(cuda, D, dtype, T, window):
    """Rope (pairs c, c + D/2 with the (T, D/2) table) and the band inside
    K1-fwd and K2 at the new head dims that rotate."""
    NH, sm = HEADS[D], 1.0 / math.sqrt(D)
    g = torch.Generator(device=cuda).manual_seed(T + window + D)
    qkv = torch.randn(2, T, 3 * C, generator=g, device=cuda).to(dtype)
    do = torch.randn(2, T, C, generator=g, device=cuda).to(dtype)
    q, k, v = qkv.split(C, dim=-1)
    args = (NH, True, sm, window, True)
    out, lse = FA.flash_fwd_cuda(q, k, v, *args)
    ref, ref_lse = FA.flash_fwd_plain(q, k, v, NH, True, sm, window=window,
                                      rope=True)
    got = FA.flash_bwd_cuda(q, k, v, out, lse, do, *args)
    want = FA.flash_bwd_plain(q, k, v, out, lse, do, NH, True, sm,
                              window=window, rope=True)
    torch.cuda.synchronize()
    assert_out_close(out, ref)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=LSE_TOL[dtype])
    tol = BWD_TOL[dtype]
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol,
                                   msg=name)


def test_kernel_refuses_other_head_dims(cuda):
    q = torch.zeros(1, 8, 256, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        FA.flash_fwd_cuda(q, q, q, 16, True, 0.25)      # D = 16
    with pytest.raises(ValueError, match="rope"):         # D = 256
        FA.flash_fwd_cuda(q, q, q, 1, True, 1 / 16, rope=True)
    out, lse = FA.flash_fwd_cuda(q, q, q, 1, True, 1 / 16)
    with pytest.raises(ValueError, match="power-of-two"):
        FA.flash_bwd_cuda(q, q, q, out, lse, q, 1, True, 0.1)
    with pytest.raises(TypeError):
        FA.flash_fwd_cuda(q.half(), q.half(), q.half(), 4, True, 0.125)


def test_engine_prefill_goes_through_the_kernel(cuda):
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.serving_gen import GenerationEngine
    cfg = get_config("gpt-nano").replace(num_layers=2, num_heads=2,
                                         channels=128, max_seq_len=64)
    params = P.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    outs = {}
    for dev in ("cuda", "cpu"):
        FA.flash_fwd_cuda.launches = 0
        eng = GenerationEngine({k: v.to(dev) for k, v in params.items()},
                               cfg, max_slots=2, max_len=64,
                               prompt_buckets=(16, 64))
        for n in (5, 40):
            eng.submit(rng.integers(0, cfg.vocab_size, n), max_new=6)
        outs[dev] = dict(eng.run())
        expect = cfg.num_layers * eng.prefill_dispatches if dev == "cuda" else 0
        assert FA.flash_fwd_cuda.launches == expect
        rng = np.random.default_rng(0)
    for rid in outs["cpu"]:
        np.testing.assert_array_equal(outs["cuda"][rid], outs["cpu"][rid])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 127, 128, 129])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_ring_edges_and_repeatable(cuda, dtype, T, causal):
    """T around the 64-row tiles and the K/V ring (the last tile partial,
    one tile, one row past it; causal frontiers that end mid-tile), each
    launch twice: the same bits, and within the bound of the plain
    version."""
    NH, C = 12, 768
    g = torch.Generator(device=cuda).manual_seed(1000 + T)
    qkv = torch.randn(2, T, 3 * C, generator=g, device=cuda).to(dtype)
    q, k, v = qkv.split(C, dim=-1)
    out, lse = FA.flash_fwd_cuda(q, k, v, NH, causal, 0.125)
    out2, lse2 = FA.flash_fwd_cuda(q, k, v, NH, causal, 0.125)
    ref, ref_lse = FA.flash_fwd_plain(q, k, v, NH, causal, 0.125)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert_out_close(out, ref)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=LSE_TOL[dtype])


def test_25_head_model_runs_the_kernel(cuda):
    """gpt2-1558m's head geometry (25 heads of 64) takes the kernel route
    on the card: one K1-fwd launch a layer, and logits within 1e-4 of the
    CPU's plain route (fp32, TF32 off)."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.models import model as M
    cfg = get_config("gpt-nano").replace(num_layers=2, num_heads=25,
                                         channels=1600, vocab_size=97,
                                         max_seq_len=64)
    params = P.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, 97, (2, 50)))
    logits = {}
    for dev in ("cuda", "cpu"):
        FA.flash_fwd_cuda.launches = 0
        pp = M.prepare_params({k: t.to(dev) for k, t in params.items()}, cfg)
        logits[dev] = M.gpt_forward(pp, toks.to(dev), cfg).cpu()
        assert FA.flash_fwd_cuda.launches == (cfg.num_layers if dev == "cuda"
                                              else 0)
    torch.testing.assert_close(logits["cuda"], logits["cpu"], rtol=1e-4,
                               atol=1e-4)
