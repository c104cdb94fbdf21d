"""PyTorch port, on the card: the model families' kernel shapes and the
bit-exact mode.

  K1-fwd  csrc/flash_fwd.cu   non-causal at the shapes the families bring:
                              T=50 NH=12 (the MAE encoder on ViT-B/16: 1 +
                              49 kept patches), T=197 NH=8 (the MAE decoder,
                              512 wide), T=257 NH=16 (the CLIP-L/14 tower);
  K2      csrc/flash_bwd.cu   the same cases;
each against its plain version, in bf16 and fp32, twice with bitwise equal
results.  Then the bit-exact mode (ops/bitexact.py) on the card: the loss
and all 16 gradients == the port's scalar oracle (oracle/bitexact_ref.py)
at B=2, T=4, C=16, NH=2, V=11, L=2.

These need an NVIDIA GPU with sm_90a and nvcc: each test skips without a
CUDA device (decided inside the `cuda` fixture, never at import).  They
import no JAX.  Run them on the card with
    python -m pytest tests/test_torch_families_cuda.py -q --noconftest
Tolerances: K1-fwd out as chip_smoke.out_errors (tests/flash_tolerance.py),
lse 1e-4 bf16 / 1e-5 fp32; K2 2e-2 abs + rel bf16 / 1e-4 fp32
(tests/test_torch_vit_cuda.py's); the bit-exact mode ==.
"""

import numpy as np
import pytest
import torch

from flash_tolerance import assert_out_close
from vitrs_tpu_torch import params as P
from vitrs_tpu_torch.config import get_config
from vitrs_tpu_torch.ops import bitexact as BX
from vitrs_tpu_torch.ops import flash_attention as FA
from vitrs_tpu_torch.oracle import bitexact_ref as REF
from vitrs_tpu_torch.oracle import numpy_ref as ORACLE

D = 64
TOL = {torch.bfloat16: (1e-4, 2e-2), torch.float32: (1e-5, 1e-4)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,T,nh", [(8, 50, 12), (8, 197, 8), (4, 257, 16)],
                         ids=["mae-enc", "mae-dec", "clip-l14"])
def test_family_shapes_fwd_and_bwd_match_plain_and_repeat(cuda, B, T, nh,
                                                          dtype):
    C = nh * D
    g = torch.Generator(device=cuda).manual_seed(T + nh)
    qkv = torch.randn(B, T, 3 * C, generator=g, device=cuda).to(dtype)
    do = torch.randn(B, T, C, generator=g, device=cuda).to(dtype)
    q, k, v = qkv.split(C, dim=-1)
    (out, lse), (out2, lse2) = (FA.flash_fwd_cuda(q, k, v, nh, False, 0.125)
                                for _ in range(2))
    ref, ref_lse = FA.flash_fwd_plain(q, k, v, nh, False, 0.125)
    got, again = (FA.flash_bwd_cuda(q, k, v, out, lse, do, nh, False, 0.125)
                  for _ in range(2))
    want = FA.flash_bwd_plain(q, k, v, out, lse, do, nh, False, 0.125)
    torch.cuda.synchronize()
    lse_tol, tol = TOL[dtype]
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert_out_close(out, ref)
    assert (lse - ref_lse).abs().max().item() <= lse_tol
    for name, a, b, c in zip(("dq", "dk", "dv"), got, again, want):
        assert torch.equal(a, b), name
        torch.testing.assert_close(a.float(), c.float(), rtol=tol, atol=tol,
                                   msg=name)


@pytest.mark.parametrize("seed", [0, 7])
def test_bitexact_mode_on_the_card_is_bitwise_the_oracle(cuda, seed):
    cfg = get_config("gpt-nano").replace(max_seq_len=4, vocab_size=11,
                                         num_layers=2, num_heads=2,
                                         channels=16)
    params = ORACLE.init_parameters(P.param_shapes(cfg), seed=seed)
    rng = np.random.default_rng(seed + 1)
    inputs = rng.integers(0, 11, (2, 4)).astype(np.int32)
    targets = rng.integers(0, 11, (2, 4)).astype(np.int32)
    loss_ref, acts = REF.model_forward(params, inputs, targets, 2)
    g_ref = REF.model_backward(params, acts, inputs, targets, 2)
    loss, g = BX.loss_and_grads(params, inputs, targets, 2, device=cuda)
    assert loss.is_cuda

    def bits(a):
        if isinstance(a, torch.Tensor):
            a = a.cpu().numpy()
        return np.asarray(a, np.float32).view(np.uint32)

    assert bits(loss) == bits(loss_ref)
    for k in g_ref:
        assert (bits(g[k]) == bits(g_ref[k])).all(), k
