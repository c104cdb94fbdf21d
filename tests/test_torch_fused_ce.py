"""PyTorch port: K5 and K6's plain versions (ops/fused_ce.py) against the
Pallas CE kernels in interpret mode, and the fused CE's routing and
autograd.

R=64 rows, V=16500 real columns padded to Vp=16512 (the smallest vocab
the fused route takes is 16384).  Tolerances:
  lse, picked  rtol/atol 2e-6 (the JAX suite's forward tolerance for its
               own kernel): fp32 logsumexp in another summation order;
  dlogits      rtol 1e-5, atol 1e-7 (the JAX suite's backward tolerance):
               the same fp32 formula, exp in another library."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitrs_tpu.ops import fused_ce as JCE
from vitrs_tpu_torch.ops import basic as TB
from vitrs_tpu_torch.ops import fused_ce as TCE

R, V = 64, 16500
VP = TCE.pad_vocab(V)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    logits = (4.0 * rng.standard_normal((R, VP))).astype(np.float32)
    targets = rng.integers(0, V, (R,))
    g = rng.standard_normal(R).astype(np.float32) / R
    return logits, targets, g


def test_pad_vocab_and_routing_match_the_jax_rule():
    assert VP == 16512 and TCE.pad_vocab(50257) == 50304
    for rows, vocab in ((R, VP), (R, VP - 1), (R + 1, VP), (R, 1000),
                        (8192, 50304), (32, 16384), (32, 16256)):
        assert TCE.supports(rows, vocab) == JCE.supports(rows, vocab)


def test_fwd_plain_matches_pallas(data):
    logits, targets, _ = data
    lse, picked = JCE._ce_fwd(jnp.asarray(logits), jnp.asarray(targets), V,
                              interpret=True)
    got_lse, got_picked = TCE.ce_fwd_plain(torch.from_numpy(logits),
                                           torch.from_numpy(targets), V)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse), rtol=2e-6,
                               atol=2e-6)
    np.testing.assert_allclose(got_picked.numpy(), np.asarray(picked),
                               rtol=2e-6, atol=2e-6)


def test_bwd_plain_matches_pallas(data):
    logits, targets, g = data
    lse, _ = JCE._ce_fwd(jnp.asarray(logits), jnp.asarray(targets), V,
                         interpret=True)
    want = JCE._ce_bwd_dlogits(jnp.asarray(logits), jnp.asarray(targets), lse,
                               jnp.asarray(g), V, interpret=True)
    got = TCE.ce_bwd_plain(torch.from_numpy(logits), torch.from_numpy(targets),
                           torch.from_numpy(np.array(lse)),
                           torch.from_numpy(g), V)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)
    assert (got[:, V:] == 0).all(), "pad columns get exactly 0"


def test_bwd_plain_keeps_bf16(data):
    logits, targets, g = data
    x = torch.from_numpy(logits).to(torch.bfloat16)
    lse, _ = TCE.ce_fwd_plain(x, torch.from_numpy(targets), V)
    d = TCE.ce_bwd_plain(x, torch.from_numpy(targets), lse,
                         torch.from_numpy(g), V)
    assert d.dtype == torch.bfloat16 and d.shape == (R, VP)


@pytest.mark.parametrize("rows", [R, R + 1])
def test_mean_and_grad_match_dense(data, rows):
    """cross_entropy_mean (fused route at R=64, the dense fallback at 65)
    equals mean CE over the real columns, and so does its gradient."""
    logits, targets, _ = data
    x = np.concatenate([logits, logits[:1]])[:rows]
    t = np.concatenate([targets, targets[:1]])[:rows]
    a = torch.from_numpy(x).requires_grad_(True)
    b = torch.from_numpy(x).requires_grad_(True)
    la = TCE.cross_entropy_mean(a, torch.from_numpy(t), real_vocab=V)
    lb = TB.cross_entropy_from_logits(b[:, :V], torch.from_numpy(t)).mean()
    la.backward()
    lb.backward()
    np.testing.assert_allclose(la.item(), lb.item(), rtol=1e-6)
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=1e-5,
                               atol=1e-8)


def test_mean_matches_jax(data):
    logits, targets, _ = data
    want = JCE.cross_entropy_mean(jnp.asarray(logits), jnp.asarray(targets),
                                  real_vocab=V, interpret=True)
    got = TCE.cross_entropy_mean(torch.from_numpy(logits),
                                 torch.from_numpy(targets), real_vocab=V)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_cuda_wrappers_refuse_cpu_tensors(data):
    logits, targets, g = data
    x, t = torch.from_numpy(logits), torch.from_numpy(targets)
    with pytest.raises(ValueError, match="CUDA"):
        TCE.ce_fwd_cuda(x, t, V)
    with pytest.raises(ValueError, match="CUDA"):
        TCE.ce_bwd_cuda(x, t, torch.zeros(R), torch.from_numpy(g), V)
