"""PyTorch port, on the card: K1-fwd (csrc/flash_fwd.cu) against its plain
version at the serving shapes, and the CUDA prefill counting its launches.

These need an NVIDIA GPU with sm_90a and nvcc: each test skips without a
CUDA device (decided inside the `cuda` fixture, never at import).  Run them
on the card with
    python -m pytest tests/test_torch_flash_cuda.py -q
Tolerances as in chip_smoke.py: bf16 out 2e-2, lse 1e-3; fp32 1e-5."""

import numpy as np
import pytest
import torch

from vitrs_tpu_torch.ops import flash_attention as FA

TOL = {torch.bfloat16: (2e-2, 1e-3), torch.float32: (1e-5, 1e-5)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [1, 37, 64, 200, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_matches_plain(cuda, dtype, T, causal):
    NH, C = 12, 768
    g = torch.Generator(device=cuda).manual_seed(T)
    qkv = torch.randn(2, T, 3 * C, generator=g, device=cuda).to(dtype)
    q, k, v = qkv.split(C, dim=-1)
    before = FA.flash_fwd_cuda.launches
    out, lse = FA.flash_fwd_cuda(q, k, v, NH, causal, 0.125)
    ref, ref_lse = FA.flash_fwd_plain(q, k, v, NH, causal, 0.125)
    torch.cuda.synchronize()
    assert FA.flash_fwd_cuda.launches == before + 1
    out_tol, lse_tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=out_tol,
                               atol=out_tol)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=lse_tol)


def test_kernel_refuses_other_head_dims(cuda):
    q = torch.zeros(1, 8, 256, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_fwd_cuda(q, q, q, 8, True, 0.125)      # D = 32
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
