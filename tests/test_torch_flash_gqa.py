"""PyTorch port: K3's plain versions (ops/flash_attention_gqa.py) against
the JAX package on the CPU, fp32, D=64.

  * the plain forward against the Pallas GQA forward `_fwd` in interpret
    mode (the cases of tests/test_flash_gqa.py): one tile (T=96, 512-wide
    blocks, `_fwd_single`'s shape) and several (T=256, 64-wide blocks), at
    (NH, KH) in {(4, 2), (4, 1), (8, 4)}, causal and full;
  * the plain backward against jax.vjp of dense attention over the
    expanded K/V (ops/attention.expand_packed), the oracle the JAX suite
    holds its GQA kernels to (the interpret-mode GQA backward is too slow
    for the quick tier);
  * the differentiable `flash_gqa_qkv` against torch autograd through the
    port's own expanded dense route, and `attention_gqa`'s routing;
  * K3's geometries pinned to those the JAX package runs on a flash
    kernel, and `split_gqa` to the JAX package's.

Tolerances: forward 1e-5 (fp32 throughout, one rounding point, the
summation order differs); backward against the dense oracle 2e-5 (the
oracle's softmax backward and the flash form's di = rowsum(out * do) are
the same function in another fp32 order).  The JAX module pads a kv width
below 128 lanes with phantom lanes; the port does not, so only the real
lanes are compared."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitrs_tpu.ops import attention as JA
from vitrs_tpu.ops import basic as JB
from vitrs_tpu.ops import flash_attention_gqa as JFG
from vitrs_tpu_torch.ops import attention as TA
from vitrs_tpu_torch.ops import flash_attention as TFA
from vitrs_tpu_torch.ops import basic as TB
from vitrs_tpu_torch.ops import flash_attention_gqa as TFG

D = 64
SCALE = 1.0 / math.sqrt(D)
GEOMS = [(4, 2), (4, 1), (8, 4)]


def _small(B, T, H, KVH, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, T, (H + 2 * KVH) * D), dtype=np.float32)


def _padded(small, H, KVH):
    """The JAX kernels' layout: k/v thirds zero-padded to kvd_padded."""
    C, kvd = H * D, KVH * D
    kp = JFG.kvd_padded(KVH, D)
    if kp == kvd:
        return jnp.asarray(small)
    z = np.zeros(small.shape[:2] + (kp - kvd,), np.float32)
    q, k, v = small[..., :C], small[..., C:C + kvd], small[..., C + kvd:]
    return jnp.asarray(np.concatenate([q, k, z, v, z], axis=-1))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T,block", [(96, 512), (256, 64)],
                         ids=["one_tile", "multi_tile"])
@pytest.mark.parametrize("H,KVH", GEOMS)
def test_plain_fwd_matches_pallas(H, KVH, T, block, causal):
    B = 2 if block == 512 else 1
    small = _small(B, T, H, KVH, seed=H * 10 + KVH + T)
    out, lse = JFG._fwd(_padded(small, H, KVH), H, KVH, D, SCALE, causal, T,
                        block, block, interpret=True)
    q, k, v = TFG.split_gqa(torch.from_numpy(small), H, KVH)
    got, got_lse = TFG.flash_gqa_fwd_plain(q, k, v, H, KVH, causal, SCALE)
    assert got.shape == (B, T, H * D) and got_lse.shape == (B, H, T)
    np.testing.assert_allclose(got.numpy(), np.asarray(out)[:, :T],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_lse.numpy(),
                               np.asarray(lse)[:, :, :T, 0],
                               rtol=1e-5, atol=1e-5)


def _dense_grads(small, do, H, KVH, causal):
    def f(s):
        out, _ = JB.attention_dense(JA.expand_packed(s, H, KVH), H,
                                    causal=causal)
        return jnp.vdot(out, jnp.asarray(do))
    return np.asarray(jax.jit(jax.grad(f))(jnp.asarray(small)))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [64, 200])
@pytest.mark.parametrize("H,KVH", GEOMS)
def test_plain_bwd_matches_dense_vjp(H, KVH, T, causal):
    B, C = 2, H * D
    small = _small(B, T, H, KVH, seed=T + H + KVH)
    do = np.random.default_rng(T).standard_normal((B, T, C), dtype=np.float32)
    q, k, v = TFG.split_gqa(torch.from_numpy(small), H, KVH)
    out, lse = TFG.flash_gqa_fwd_plain(q, k, v, H, KVH, causal, SCALE)
    dq, dk, dv = TFG.flash_gqa_bwd_plain(q, k, v, out, lse,
                                         torch.from_numpy(do), H, KVH,
                                         causal, SCALE)
    assert dk.shape == dv.shape == (B, T, KVH * D)
    want = _dense_grads(small, do, H, KVH, causal)
    got = torch.cat([dq, dk, dv], dim=-1).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KVH", GEOMS)
def test_autograd_matches_expanded_dense(H, KVH, causal):
    """flash_gqa_qkv differentiates like torch autograd through the dense
    attention over repeat_interleave'd K/V, whose transpose is the group
    sum."""
    small = _small(2, 37, H, KVH, seed=5)
    do = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 37, H * D), dtype=np.float32))
    x1 = torch.from_numpy(small).requires_grad_(True)
    x2 = torch.from_numpy(small).requires_grad_(True)
    TFG.flash_gqa_qkv(x1, H, KVH, causal=causal).backward(do)
    TB.attention_dense(TA.expand_packed(x2, H, KVH), H,
                       causal=causal)[0].backward(do)
    np.testing.assert_allclose(x1.grad.numpy(), x2.grad.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_attention_gqa_routes_like_jax(monkeypatch):
    """A flash geometry goes to K3's route (D=64, and D=8, which the JAX
    package tiles with phantom heads), a head dim no kernel tiles (D=48) to
    dense attention over the expansion, MHA to the MHA route; each agrees
    with the JAX function (its dense route on the CPU)."""
    calls = []
    plain = TFG.flash_gqa_fwd_plain
    monkeypatch.setattr(TFG, "flash_gqa_fwd_plain",
                        lambda *a: calls.append(a[3:5]) or plain(*a))
    rng = np.random.default_rng(9)
    for H, KVH, hd, k3 in ((4, 2, 64, True), (4, 1, 8, True),
                           (4, 1, 48, False), (4, 4, 64, False)):
        x = rng.standard_normal((2, 19, (H + 2 * KVH) * hd), dtype=np.float32)
        calls.clear()
        got = TA.attention_gqa(torch.from_numpy(x), H, KVH)
        assert calls == ([(H, KVH)] if k3 else [])
        want = JA.attention_gqa(jnp.asarray(x), H, KVH, use_flash=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_supports_gqa_and_split_pinned_to_jax():
    """The port carries no `supports_gqa` (a rule about 128-lane kv
    blocks): at every head dim of HEAD_DIMS its K3 takes a GQA geometry
    whenever the JAX package sends it to a flash kernel, natively (JAX
    `supports_gqa`) or through its expanded-weight MHA route with phantom
    heads (`padded_num_heads`); a head dim no kernel tiles (48) goes to
    dense attention in both."""
    from vitrs_tpu.ops import flash_attention as JFA
    extra = set()
    for H in (1, 2, 3, 4, 5, 6, 8, 12, 16, 25):
        for KVH in range(1, H):
            if H % KVH:
                continue
            for hd in (8, 32, 48, 64, 128, 256):
                k3 = TA.supports(H, hd, KVH)
                assert k3 == (hd in TFA.HEAD_DIMS), (H, KVH, hd)
                assert (JFA.padded_num_heads(H, hd) is not None) == k3
                if JFG.supports_gqa(H, KVH, hd):
                    assert k3, (H, KVH, hd)
                elif k3:
                    extra.add((H, KVH, hd))
    # an odd kv head count at D=64: K3 here, expanded MHA in the JAX package
    assert {(6, 3, 64), (12, 3, 64)} <= extra
    x = np.arange(2 * 3 * 8 * 20, dtype=np.float32).reshape(2, 3, 160)
    for a, b in zip(TFG.split_gqa(torch.from_numpy(x), 4, 3),
                    JA.split_gqa(jnp.asarray(x), 4, 3)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_cuda_wrappers_refuse_cpu_tensors():
    """On a CPU tensor the kernel wrappers raise instead of running the
    plain version: the op's dispatch (`_build.kernel_op`) is the only place
    that chooses."""
    q = torch.zeros(1, 8, 4 * D)
    k = torch.zeros(1, 8, 2 * D)
    with pytest.raises(ValueError, match="CUDA"):
        TFG.flash_gqa_fwd_cuda(q, k, k, 4, 2, True, SCALE)
    lse = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        TFG.flash_gqa_bwd_cuda(q, k, k, q, lse, q, 4, 2, True, SCALE)
