"""PyTorch port: K1-fwd's plain version against the JAX Pallas kernels.

On the CPU `flash_attention_fwd` runs `flash_fwd_plain`, the function the
CUDA kernel (csrc/flash_fwd.cu) is held against on the card.  Here it is held
against the Pallas forward in interpret mode — `flash_attention_qkv` for out
and the driver `_fwd` for lse — at rtol/atol 2e-5, the JAX suite's own flash
tolerance.  T=64 runs the single-tile Pallas kernel; T=256 and the ragged
T=200 with 128-wide blocks run the multi-tile one."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitrs_tpu.ops import basic as JB
from vitrs_tpu.ops import flash_attention as JFA
from vitrs_tpu_torch.ops import attention as TA
from vitrs_tpu_torch.ops import flash_attention as TFA

TOL = dict(rtol=2e-5, atol=2e-5)
B, NH, D = 2, 2, 64
C = NH * D
# (T, block): block None = the JAX defaults (one tile at T=64)
CASES = [(64, None), (256, 128), (200, 128)]


def _qkv(T, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, T, 3 * C), dtype=np.float32)


def _blocks(block):
    return {} if block is None else dict(block_q=block, block_k=block)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T,block", CASES)
def test_out_matches_pallas(T, block, causal):
    qkv = _qkv(T, T)
    want = JFA.flash_attention_qkv(jnp.asarray(qkv), NH, causal=causal,
                                   interpret=True, **_blocks(block))
    got = TFA.flash_attention_qkv(torch.from_numpy(qkv), NH, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T,block", CASES)
def test_lse_matches_pallas(T, block, causal):
    qkv = _qkv(T, T + 1)
    bq = bk = block or JFA.DEFAULT_BLOCK_Q
    x, bq, bk = JFA.prep_blocks(jnp.asarray(qkv), bq, bk)
    out, lse = JFA._fwd(x, NH, 1.0 / math.sqrt(D), causal, T, bq, bk,
                        interpret=True)
    got_out, got_lse = TFA.flash_attention_fwd(torch.from_numpy(qkv), NH,
                                               causal=causal)
    assert got_lse.shape == (B, NH, T) and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse)[:, :, :T, 0],
                               **TOL)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(out)[:, :T], **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_dense_attention(causal):
    qkv = torch.from_numpy(_qkv(77, 5))
    got = TFA.flash_attention_qkv(qkv, NH, causal=causal)
    want, _ = JB.attention_dense(jnp.asarray(qkv.numpy()), NH, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plain_rounds_like_the_kernels_in_bf16():
    """bf16: q pre-scaled and rounded, p rounded for P.V, out in bf16 —
    within bf16 rounding of the fp32 result, and in bf16."""
    qkv = torch.from_numpy(_qkv(64, 6))
    out = TFA.flash_attention_qkv(qkv.to(torch.bfloat16), NH)
    ref = TFA.flash_attention_qkv(qkv, NH)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(),
                               rtol=3e-2, atol=3e-2)


def test_cpu_dispatch_does_not_launch_the_kernel():
    before = TFA.flash_fwd_cuda.launches
    out = TA.attention(torch.from_numpy(_qkv(64, 7)), NH, causal=True)
    assert out.shape == (B, 64, C)
    assert TFA.flash_fwd_cuda.launches == before == 0


def test_cuda_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 8, C)
    with pytest.raises(ValueError, match="CUDA"):
        TFA.flash_fwd_cuda(q, q, q, NH, True, 0.125)
    assert TFA.flash_fwd_cuda.launches == 0


@pytest.mark.parametrize("nh,d,flash", [(12, 64, True), (2, 64, True),
                                        (2, 8, False), (25, 64, False),
                                        (4, 32, True)])
def test_routing_follows_jax_supports(nh, d, flash):
    assert TA.supports(nh, d) == JFA.supports(nh, d) == flash


def test_dense_route_for_unsupported_geometry():
    """gpt-nano's D=8 goes to dense attention, as in the JAX package."""
    qkv = np.random.default_rng(8).standard_normal((2, 11, 48),
                                                   dtype=np.float32)
    got = TA.attention(torch.from_numpy(qkv), 2, causal=True)
    want, _ = JB.attention_dense(jnp.asarray(qkv), 2, causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
