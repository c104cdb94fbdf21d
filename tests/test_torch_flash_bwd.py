"""PyTorch port: K2's plain version (`flash_bwd_plain`) against the Pallas
backward kernels in interpret mode, and the port's differentiable flash
attention against dense attention.

Both backwards get the same qkv, do and the Pallas forward's out and lse,
so that only the backward is compared.  Cases, as the JAX suite runs them
(tests/test_flash_multitile.py):
  T=64, default blocks      the single-tile kernel (`_bwd_single_kernel`);
  T=256, 128-wide blocks    the combined kernel (`_bwd_combined_kernel`),
                            and the dKV/dQ pair (`_bwd_dkv_kernel` +
                            `_bwd_dq_kernel`) with COMBINED_BWD_VMEM_LIMIT
                            set to 0 through monkeypatch;
  T=200, 128-wide blocks    the ragged end (T padded to 256 in the JAX
                            kernels, masked against seq_len in the port).
Tolerance rtol/atol 2e-5: fp32 throughout, the same rounding points, only
the summation order differs (the JAX suite holds its flash forward to
2e-5)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitrs_tpu.ops import flash_attention as JFA
from vitrs_tpu_torch.ops import basic as TB
from vitrs_tpu_torch.ops import flash_attention as TFA

TOL = dict(rtol=2e-5, atol=2e-5)
B, NH, D = 2, 2, 64
C = NH * D
SCALE = 1.0 / math.sqrt(D)
# (T, block, pair): block None = the JAX defaults (one tile at T=64)
CASES = [(64, None, False), (256, 128, False), (256, 128, True),
         (200, 128, False)]


def _inputs(T, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, 3 * C), dtype=np.float32),
            rng.standard_normal((B, T, C), dtype=np.float32))


def _pallas_bwd(qkv, do, T, block, causal):
    """(out, compact lse, dq, dk, dv) from the Pallas kernels, interpreted."""
    bq = bk = block or JFA.DEFAULT_BLOCK_Q
    x, bq, bk = JFA.prep_blocks(jnp.asarray(qkv), bq, bk)
    out, lse = JFA._fwd(x, NH, SCALE, causal, T, bq, bk, interpret=True)
    pad = x.shape[1] - T
    do_k = jnp.pad(jnp.asarray(do), ((0, 0), (0, pad), (0, 0)))
    grads = JFA._bwd_parts(x, NH, out, lse, do_k, SCALE, causal, T, bq, bk,
                           True)
    return [np.array(a)[:, :T] for a in (out, *grads)], \
        np.array(lse)[:, :, :T, 0]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T,block,pair", CASES)
def test_plain_bwd_matches_pallas(T, block, pair, causal, monkeypatch):
    if pair:
        monkeypatch.setattr(JFA, "COMBINED_BWD_VMEM_LIMIT", 0)
    qkv, do = _inputs(T, T + int(pair))
    (out, *want), lse = _pallas_bwd(qkv, do, T, block, causal)
    q, k, v = torch.from_numpy(qkv).split(C, dim=-1)
    got = TFA.flash_bwd_plain(q, k, v, torch.from_numpy(out),
                              torch.from_numpy(lse), torch.from_numpy(do),
                              NH, causal, SCALE)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == (B, T, C) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [1, 37, 130])
def test_autograd_matches_dense(T, causal):
    """The port's flash attention differentiates like dense attention
    (torch autograd through ops/basic.attention_dense), including T=1."""
    qkv, do = _inputs(T, 7)
    x1 = torch.from_numpy(qkv).requires_grad_(True)
    x2 = torch.from_numpy(qkv).requires_grad_(True)
    TFA.flash_attention_qkv(x1, NH, causal=causal).backward(
        torch.from_numpy(do))
    TB.attention_dense(x2, NH, causal=causal)[0].backward(
        torch.from_numpy(do))
    np.testing.assert_allclose(x1.grad.numpy(), x2.grad.numpy(), **TOL)


def test_bwd_rounds_at_the_kernel_points_in_bf16():
    """In bf16 the plain version returns bf16 grads that agree with its own
    fp32 run to bf16 accuracy (the CUDA kernel is held to it on the card)."""
    qkv, do = _inputs(64, 3)
    outs = {}
    for dt in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(qkv).to(dt)
        out, lse = TFA.flash_attention_fwd(x, NH, causal=True)
        q, k, v = x.split(C, dim=-1)
        outs[dt] = TFA.flash_bwd_plain(q, k, v, out, lse,
                                       torch.from_numpy(do).to(dt), NH, True,
                                       SCALE)
    for a, b in zip(outs[torch.bfloat16], outs[torch.float32]):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), b.numpy(), rtol=5e-2,
                                   atol=5e-2)
