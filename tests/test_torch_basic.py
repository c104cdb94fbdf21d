"""PyTorch port: ops/basic.py against vitrs_tpu.ops.basic, fp32,
rtol/atol 1e-5 (both sides compute in fp32; only the summation order of
the reductions and matmuls differs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitrs_tpu.ops import basic as JB
from vitrs_tpu_torch.ops import basic as TB

TOL = dict(rtol=1e-5, atol=1e-5)


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("shape", [(3, 16), (2, 5, 128), (1, 7, 768)])
def test_layernorm(shape):
    x = _x(shape, 0, 3.0) + 1.5
    w, b = _x(shape[-1:], 1), _x(shape[-1:], 2)
    got = TB.layernorm(*(torch.from_numpy(a) for a in (x, w, b)))
    want = JB.layernorm(*(jnp.asarray(a) for a in (x, w, b)))
    for g, ww in zip(got, want):
        _close(g, ww)


@pytest.mark.parametrize("fn", ["gelu", "gelu_erf"])
@pytest.mark.parametrize("shape", [(64,), (2, 9, 512)])
def test_gelu(fn, shape):
    x = _x(shape, 3, 3.0)
    _close(getattr(TB, fn)(torch.from_numpy(x)),
           getattr(JB, fn)(jnp.asarray(x)))


def test_gelu_keeps_bf16():
    x = torch.from_numpy(_x((32,), 4)).to(torch.bfloat16)
    assert TB.gelu(x).dtype == torch.bfloat16
    assert TB.gelu_erf(x).dtype == torch.bfloat16


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("shape", [((4, 32), 48), ((2, 3, 128), 384)])
def test_linear(bias, shape):
    xs, oc = shape
    x, w = _x(xs, 5), _x((oc, xs[-1]), 6, 0.1)
    b = _x((oc,), 7) if bias else None
    got = TB.linear(torch.from_numpy(x), torch.from_numpy(w),
                    None if b is None else torch.from_numpy(b))
    want = JB.linear(jnp.asarray(x), jnp.asarray(w),
                     None if b is None else jnp.asarray(b))
    _close(got, want)


def test_linear_refuses_a_per_call_cast():
    x = torch.zeros(2, 8, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="prepare_params"):
        TB.linear(x, torch.zeros(4, 8))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("geom", [(2, 9, 16, 2), (1, 33, 128, 2),
                                  (2, 17, 96, 3)])
def test_attention_dense(causal, geom):
    B, T, C, NH = geom
    qkv = _x((B, T, 3 * C), 8)
    out, att = TB.attention_dense(torch.from_numpy(qkv), NH, causal=causal)
    jout, jatt = JB.attention_dense(jnp.asarray(qkv), NH, causal=causal)
    _close(out, jout)
    _close(att, jatt)


def _vjp_jax(fn, args, dout):
    import jax
    _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    return vjp(jnp.asarray(dout))


def _vjp_torch(fn, args, dout):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    fn(*ts).backward(torch.from_numpy(dout))
    return [t.grad for t in ts]


@pytest.mark.parametrize("shape", [(3, 16), (2, 5, 128)])
def test_layernorm_cv_backward(shape):
    """The hand-written LN backward from (mean, rstd) against the JAX
    custom VJP: dx, dw and db (reduced over every leading axis)."""
    x = _x(shape, 10, 3.0) + 1.5
    w, b = _x(shape[-1:], 11), _x(shape[-1:], 12)
    dout = _x(shape, 13)
    for g, w_ in zip(_vjp_torch(TB.layernorm_cv, (x, w, b), dout),
                     _vjp_jax(JB.layernorm_cv, (x, w, b), dout)):
        _close(g, w_)


@pytest.mark.parametrize("fn", ["gelu_cv", "gelu_erf_cv"])
def test_gelu_cv_backward(fn):
    x, dout = _x((2, 9, 512), 14, 3.0), _x((2, 9, 512), 15)
    _close(_vjp_torch(getattr(TB, fn), (x,), dout)[0],
           _vjp_jax(getattr(JB, fn), (x,), dout)[0])


@pytest.mark.parametrize("smoothing", [None, 0.1])
def test_cross_entropy_forms(smoothing):
    logits = _x((4, 7, 33), 16, 3.0)
    t = np.random.default_rng(17).integers(0, 33, (4, 7))
    if smoothing is None:
        got = TB.cross_entropy_from_logits(torch.from_numpy(logits),
                                           torch.from_numpy(t))
        want = JB.cross_entropy_from_logits(jnp.asarray(logits),
                                            jnp.asarray(t))
    else:
        got = TB.cross_entropy_smoothed(torch.from_numpy(logits),
                                        torch.from_numpy(t), smoothing)
        want = JB.cross_entropy_smoothed(jnp.asarray(logits), jnp.asarray(t),
                                         smoothing)
    _close(got, want)
