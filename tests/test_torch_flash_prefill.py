"""PyTorch port: K4's plain version (ops/flash_prefill.py) against the JAX
package's `flash_prefill_qkv` in interpret mode on the CPU, fp32, D=64, and
the wrapper's contract.

  * (NH, KH) in {(4, 4), (4, 2), (8, 4)} and chunks (S, q_offset) of
    (64, 0), (128, 128), (200, 133) (a ragged S at an offset that is no
    tile boundary) and (256, 256) against a 512-slot cache, whose tail
    beyond the chunk's frontier is poisoned with 1e9 (tests/
    test_flash_prefill.py's convention);
  * a NaN-filled tail leaves the output finite and unchanged;
  * ValueError where the JAX function asserts (q_offset < 0, a cache length
    that is not a multiple of 256, an untileable geometry, a chunk that
    does not fit, a negative window);
  * `supports_prefill` against the JAX rule: every geometry it takes,
    and MQA at head_dim 64 besides.

Tolerance 1e-5: fp32 throughout, the same rounding points, the summation
order differs (the JAX suite holds the kernel to its dense form at 2e-5)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitrs_tpu.ops import flash_prefill as JP
from vitrs_tpu_torch.ops import attention as TA
from vitrs_tpu_torch.ops import flash_attention as TFA
from vitrs_tpu_torch.ops import flash_prefill as TP

D, TK = 64, 512


def _inputs(nh, kh, s, q_off, seed, tail=1e9):
    rng = np.random.default_rng(seed)
    B = 2
    q = rng.standard_normal((B, s, nh * D), dtype=np.float32)
    k = rng.standard_normal((B, TK, kh * D), dtype=np.float32)
    v = rng.standard_normal((B, TK, kh * D), dtype=np.float32)
    k[:, q_off + s:] = tail
    v[:, q_off + s:] = tail
    return q, k, v


@pytest.mark.parametrize("s,q_off", [(64, 0), (128, 128), (200, 133),
                                     (256, 256)])
@pytest.mark.parametrize("nh,kh", [(4, 4), (4, 2), (8, 4)])
def test_plain_matches_pallas(nh, kh, s, q_off):
    assert JP.supports_prefill(nh, kh, D)
    assert TP.supports_prefill(nh, kh, D)
    q, k, v = _inputs(nh, kh, s, q_off, seed=nh * 100 + kh * 10 + s + q_off)
    want = JP.flash_prefill_qkv(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), nh, kh, q_off, interpret=True)
    got = TP.flash_prefill_qkv(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), nh, kh, q_off)
    assert got.shape == (2, s, nh * D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_nan_tail_is_never_read():
    q, k, v = _inputs(4, 2, 100, 156, seed=1, tail=np.nan)
    got = TP.flash_prefill_qkv(*map(torch.from_numpy, (q, k, v)), 4, 2, 156)
    assert torch.isfinite(got).all()
    clean = [torch.from_numpy(a.copy()) for a in (q, k, v)]
    for t in clean[1:]:
        t[:, 256:] = 0.0
    np.testing.assert_array_equal(
        got.numpy(), TP.flash_prefill_qkv(*clean, 4, 2, 156).numpy())


def test_contract_raises_value_error():
    q, k, v = (torch.from_numpy(a) for a in _inputs(4, 2, 64, 0, seed=2))
    with pytest.raises(ValueError, match="q_offset"):
        TP.flash_prefill_qkv(q, k, v, 4, 2, -1)
    with pytest.raises(ValueError, match="q_offset"):
        TP.flash_prefill_qkv(q, k, v, 4, 2, 1.0)
    with pytest.raises(ValueError, match="multiple of 256"):
        TP.flash_prefill_qkv(q, k[:, :500], v[:, :500], 4, 2, 0)
    with pytest.raises(ValueError, match="does not fit"):
        TP.flash_prefill_qkv(q, k, v, 4, 2, 480)
    with pytest.raises(ValueError, match="geometry"):      # head_dim 48
        TP.flash_prefill_qkv(q[..., :4 * 48], k[..., :2 * 48],
                             v[..., :2 * 48], 4, 2, 0)
    with pytest.raises(ValueError, match="geometry"):      # k/v width
        TP.flash_prefill_qkv(q, k, v, 4, 1, 0)
    with pytest.raises(ValueError, match="window"):
        TP.flash_prefill_qkv(q, k, v, 4, 2, 0, window=-1)
    with pytest.raises(ValueError, match="CUDA"):
        TP.flash_prefill_cuda(q, k, v, 4, 2, 0, 1.0 / math.sqrt(D))


def test_supports_prefill_pinned_to_jax():
    """At every head dim of HEAD_DIMS (D = 8 and 16 included), K4 takes
    every geometry the JAX kernel takes, and also those the JAX kernel's
    128-lane kv blocks refuse (MQA at 64, D = 256) where the port's other
    flash kernels run: the geometries of a fresh-prompt prefill.  A head
    dim no kernel tiles (48) goes to dense cache attention in both."""
    extra = set()
    for nh in (1, 2, 3, 4, 6, 8, 12, 16, 20, 25):
        for kh in range(1, nh + 1):
            if nh % kh:
                continue
            for hd in (8, 16, 32, 48, 64, 128, 256):
                port = TP.supports_prefill(nh, kh, hd)
                assert port == TA.supports(nh, hd, kh) == (
                    hd in TFA.HEAD_DIMS), (nh, kh, hd)
                if JP.supports_prefill(nh, kh, hd):
                    assert port, (nh, kh, hd)
                elif port:
                    extra.add((nh, kh, hd))
    assert {(4, 1, 64), (12, 1, 64)} <= extra
    assert TP.PREFILL_BLOCK == JP.PREFILL_BLOCK
