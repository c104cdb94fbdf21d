"""PyTorch port: the property K2's and K3-bwd's bf16 kernels rely on when
they scale the scores in fp32 instead of forming q^ = round(q * sm_scale).

At D = 64, sm_scale = 1/8 = 2^-3.  Scaling by a power of two changes only
the exponent, so it is exact in bf16 and fp32 (barring values below 2^-123),
and every fp32 product and partial sum of q^ . k^T is then the matching one
of q . k^T times 2^-3: the two routes give the same bits.  Checked here:
  * bf16 round(q * 2^-k) == q * 2^-k on seeded inputs (and 0.1, not a power
    of two, does round, so the check is not vacuous);
  * `flash_bwd_plain` with s scaled in fp32 equals its q^ route bit for bit
    at sm_scale 1/8 (MHA, GQA, rope, window; bf16 and fp32), and the fp32
    route matches the Pallas backward in interpret mode within the 2e-5 of
    tests/test_torch_flash_bwd.py (fp32 throughout, only the summation order
    differs)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitrs_tpu.ops import flash_attention as JFA
from vitrs_tpu_torch.ops import flash_attention as TFA

B, NH, D = 2, 2, 64
C = NH * D
SCALE = 1.0 / math.sqrt(D)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("scale", [2.0 ** -3, 2.0 ** -1, 2.0 ** -7])
def test_power_of_two_scaling_is_exact_in_bf16(seed, scale):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(1 << 16, dtype=np.float32)
                         * 10.0 ** rng.integers(-6, 6, 1 << 16)).bfloat16()
    exact = x.float() * scale
    assert torch.equal(exact.bfloat16().float(), exact)


def test_other_scales_round_in_bf16():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal(1 << 16, dtype=np.float32)).bfloat16()
    exact = x.float() * 0.1
    assert not torch.equal(exact.bfloat16().float(), exact)


@pytest.mark.parametrize("sm_scale,want", [(0.125, True), (0.5, True), (1.0, True),
                                           (2.0 ** -10, True), (0.1, False),
                                           (1 / math.sqrt(48), False), (0.0, False),
                                           (-0.125, False)])
def test_scale_in_fp32(sm_scale, want):
    assert TFA.scale_in_fp32(sm_scale) is want


def _qkv(T, KH, dtype, seed):
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((B, T, C), dtype=np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, T, KH * D), dtype=np.float32))
            for _ in range(2))
    return [t.to(dtype) for t in (q, k, v, do)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("KH,causal,window,rope", [
    (NH, True, 0, False), (NH, False, 0, False), (1, True, 0, False),
    (1, False, 0, True), (NH, True, 5, True), (1, True, 5, False)])
def test_fp32_scale_equals_qhat_route_bitwise(dtype, KH, causal, window, rope):
    q, k, v, do = _qkv(37, KH, dtype, KH + window)
    out, lse = TFA.flash_fwd_plain(q, k, v, NH, causal, SCALE, kv_heads=KH,
                                   window=window, rope=rope)
    args = (q, k, v, out, lse, do, NH, causal, SCALE)
    kw = dict(kv_heads=KH, window=window, rope=rope)
    fp32 = TFA.flash_bwd_plain(*args, **kw, fp32_scale=True)
    qhat = TFA.flash_bwd_plain(*args, **kw, fp32_scale=False)
    default = TFA.flash_bwd_plain(*args, **kw)
    for name, a, b, c in zip(("dq", "dk", "dv"), fp32, qhat, default):
        assert torch.equal(a, b), name
        assert torch.equal(a, c), name


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T,block", [(64, None), (200, 128)])
def test_fp32_scale_route_matches_pallas(T, block, causal):
    rng = np.random.default_rng(T)
    qkv = rng.standard_normal((B, T, 3 * C), dtype=np.float32)
    do = rng.standard_normal((B, T, C), dtype=np.float32)
    bq = bk = block or JFA.DEFAULT_BLOCK_Q
    x, bq, bk = JFA.prep_blocks(jnp.asarray(qkv), bq, bk)
    out, lse = JFA._fwd(x, NH, SCALE, causal, T, bq, bk, interpret=True)
    pad = x.shape[1] - T
    do_k = jnp.pad(jnp.asarray(do), ((0, 0), (0, pad), (0, 0)))
    want = JFA._bwd_parts(x, NH, out, lse, do_k, SCALE, causal, T, bq, bk, True)
    q, k, v = torch.from_numpy(qkv).split(C, dim=-1)
    got = TFA.flash_bwd_plain(q, k, v, torch.from_numpy(np.array(out)[:, :T]),
                              torch.from_numpy(np.array(lse)[:, :, :T, 0]),
                              torch.from_numpy(do), NH, causal, SCALE,
                              fp32_scale=True)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.array(w)[:, :T], rtol=2e-5,
                                   atol=2e-5, err_msg=name)
