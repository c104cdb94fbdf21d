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

from vitrs_tpu.ops import attention as JA
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
                                        (2, 8, True), (25, 64, True),
                                        (4, 32, True), (3, 64, True),
                                        (1, 64, True), (2, 128, True),
                                        (3, 256, True), (2, 384, True)])
def test_routing_follows_jax_supports(nh, d, flash):
    """The port routes by its kernels' rule (every divisor of 128 and every
    multiple of 128 up to 1024 as head dim, any head count).  That is the
    JAX package's rule too, which runs head counts its blocks cannot tile
    on flash with phantom heads (`padded_num_heads`: gpt-nano's 2 heads of
    8 as 16)."""
    assert TA.supports(nh, d) == flash
    assert (JFA.padded_num_heads(nh, d) is not None) == flash


def test_dense_route_for_unsupported_geometry(monkeypatch):
    """Rope at D = 256 goes to dense attention with an explicit rotation,
    as in the JAX package (whose kernels' rope table asserts there): no
    flash plain version runs, and the result is the JAX function's."""
    calls = _counting(monkeypatch, TFA, "flash_fwd_plain")
    qkv = np.random.default_rng(8).standard_normal((2, 11, 3 * 256),
                                                   dtype=np.float32)
    assert not TA.supports(1, 256, rope=True)
    got = TA.attention(torch.from_numpy(qkv), 1, causal=True, rope=True)
    want = JA.attention(jnp.asarray(qkv), 1, causal=True, rope=True)
    assert calls == []
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _counting(monkeypatch, module, name):
    """Wrap module.name so that each call is counted in the returned list."""
    calls = []
    fn = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **k: calls.append(a[3]) or fn(*a, **k))
    return calls


def test_25_heads_take_the_kernel_route(monkeypatch):
    """gpt2-1558m's geometry (25 heads of 64): the plain K1-fwd on the CPU
    (the kernel on the card), no padding, equal to the JAX function."""
    calls = _counting(monkeypatch, TFA, "flash_fwd_plain")
    qkv = np.random.default_rng(10).standard_normal((1, 9, 3 * 25 * D),
                                                    dtype=np.float32)
    got = TA.attention(torch.from_numpy(qkv), 25, causal=True)
    want, _ = JB.attention_dense(jnp.asarray(qkv), 25, causal=True)
    assert calls == [25]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kv_heads", [0, 1])
def test_odd_head_model_forward_goes_through_plain_kernels(monkeypatch,
                                                           kv_heads):
    """A 3-head model (D = 64; MHA, and MQA through K3): every layer's
    attention runs the plain version of K1-fwd or K3-fwd, where the JAX
    package pads to 4 heads on flash; the logits equal the JAX model's."""
    from vitrs_tpu.models import model as JM
    from vitrs_tpu_torch.models import model as TM
    from vitrs_tpu_torch.ops import flash_attention_gqa as TFG
    from test_torch_helpers import both_params, small_cfgs
    jcfg, tcfg = small_cfgs(num_heads=3, channels=3 * D,
                            num_kv_heads=kv_heads)
    mha = _counting(monkeypatch, TFA, "flash_fwd_plain")
    gqa = _counting(monkeypatch, TFG, "flash_gqa_fwd_plain")
    jp, tp = both_params(jcfg, tcfg, seed=11)
    toks = np.random.default_rng(11).integers(0, tcfg.vocab_size, (2, 40))
    got = TM.gpt_forward(TM.prepare_params(tp, tcfg), torch.as_tensor(toks),
                         tcfg)
    want = JM.gpt_forward(jp, jnp.asarray(toks), jcfg)
    L = tcfg.num_layers
    assert (mha, gqa) == (([3] * L, []) if kv_heads == 0 else ([], [3] * L))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_tma_rule_takes_every_view_the_port_passes():
    """`tma_mappable`, the rule `launch_fwd` and `launch_bwd` hold every
    tensor to before a launch: q, k and v of a packed MHA or GQA qkv, a
    layer's kv cache and its slices along T pass (bf16 and fp32); a view
    at an odd offset, or out of a row of odd width, does not."""
    for dtype in (torch.bfloat16, torch.float32):
        qkv = torch.zeros(2, 37, 3 * 25 * D, dtype=dtype)
        assert all(TFA.tma_mappable(t) for t in qkv.split(25 * D, dim=-1))
        gqa = torch.zeros(2, 37, (12 + 2 * 4) * D, dtype=dtype)
        from vitrs_tpu_torch.ops.flash_attention_gqa import split_gqa
        assert all(TFA.tma_mappable(t) for t in split_gqa(gqa, 12, 4))
        cache = torch.zeros(3, 2, 512, 4 * D, dtype=dtype)[1]
        assert TFA.tma_mappable(cache) and TFA.tma_mappable(cache[:, 64:300])
        assert not TFA.tma_mappable(qkv[..., 1:1 + D])           # base
        odd = torch.zeros(2, 37, 3 * D + 1, dtype=dtype)
        assert not TFA.tma_mappable(odd[..., :D])                # row stride
        flat = torch.zeros(2 * (37 * 3 * D + 1), dtype=dtype)
        assert not TFA.tma_mappable(                             # batch stride
            flat.as_strided((2, 37, D), (37 * 3 * D + 1, 3 * D, 1)))
        assert not TFA.tma_mappable(qkv.view(2, 37, 3 * 25, D)[..., 0])
