"""Shared f32 transcendentals for the bit-exact parity mode — the port of
`vitrs_tpu/bitmath.py`.

Bit-for-bit parity between the scalar NumPy oracle (oracle/bitexact_ref.py)
and the torch eager path (ops/bitexact.py) needs both sides to run the
identical sequence of IEEE-754 f32 operations.  Library exp/tanh differ
between libm, PyTorch's CPU kernels and CUDA's, so the bit-exact mode
computes them from f32 add/mul/div/floor and a power-of-two scaling, each
of which is correctly rounded on every backend.

Each function takes the array namespace `xp`: `numpy` (the oracle's side,
the same operations as the JAX package's module) or `TORCH` below (the
port's side, on the tensors' own device).  `TORCH.ldexp` builds 2^k from
the exponent bits instead of calling `torch.ldexp`, which multiplies by
`pow(2, k)`: a power whose rounding is the library's affair.  For k in
[-126, 127] the bits give 2^k exactly, so p * 2^k is one correctly rounded
product, which is what `np.ldexp` returns (subnormal results included).
exp32's clamp keeps its k within [-116, 116].
"""

from __future__ import annotations

import numpy as np
import torch

F = np.float32
LOG2E = F(1.4426950408889634)
LN2_HI = F(0.693359375)              # 355/512, exact in f32
LN2_LO = F(-2.12194440e-4)           # ln2 - LN2_HI (Cody-Waite split)
# Taylor coefficients of e^r, applied Horner-style (1/720 ... 1)
_EXP_COEFFS = (F(1.0 / 120), F(1.0 / 24), F(1.0 / 6), F(0.5), F(1.0), F(1.0))
_CLAMP = F(80.0)                     # exp argument clamp (saturation guard)


class TORCH:
    """The namespace of torch operations that `exp32`, `tanh32` and
    `cosh32` call, with numpy's signatures.  Scalars enter as Python
    floats, which hold every f32 constant exactly, on the tensor's right:
    an np.float32 on the left of a tensor would take numpy's operator."""

    @staticmethod
    def minimum(x, s):
        return torch.clamp_max(x, float(s))

    @staticmethod
    def maximum(x, s):
        return torch.clamp_min(x, float(s))

    floor = staticmethod(torch.floor)
    abs = staticmethod(torch.abs)
    where = staticmethod(torch.where)

    @staticmethod
    def ldexp(p, k):
        """p * 2^k for an f32 tensor p and integer-valued k in [-126, 127],
        2^k built from its exponent bits."""
        bits = (k.to(torch.int32) + 127) << 23
        return p * bits.view(torch.float32)

    @staticmethod
    def reciprocal(x):
        """1 / x as a true division."""
        return torch.div(torch.ones_like(x), x)


def _c(v, xp):
    """A constant as the namespace takes it: np.float32 for numpy (as the
    JAX package's module has it, so numpy scalars stay f32), a Python float
    on the tensor's right for torch."""
    return v if xp is np else float(v)


def _ldexp(p, k, xp):
    if xp is np:
        return np.ldexp(p, k.astype(np.int32))
    return xp.ldexp(p, k)


def exp32(x, xp):
    """e^x in f32: Cody-Waite reduction x = k*ln2 + r, degree-6 Horner."""
    x = xp.minimum(xp.maximum(x, -_CLAMP), _CLAMP)
    k = xp.floor(x * _c(LOG2E, xp) + _c(F(0.5), xp))
    r = (x - k * _c(LN2_HI, xp)) - k * _c(LN2_LO, xp)
    p = F(1.0 / 720) if xp is np else torch.full_like(r, float(F(1.0 / 720)))
    for c in _EXP_COEFFS:
        p = p * r + _c(c, xp)
    return _ldexp(p, k, xp)


def tanh32(x, xp):
    """tanh via exp32: sign(x) * (e^{2|x|} - 1) / (e^{2|x|} + 1)."""
    a = xp.abs(x)
    e = exp32(a + a, xp)
    one = _c(F(1.0), xp)
    t = (e - one) / (e + one)
    return xp.where(x < _c(F(0.0), xp), -t, t)


def cosh32(x, xp):
    """cosh via exp32: (e^{|x|} + 1/e^{|x|}) * 0.5."""
    e = exp32(xp.abs(x), xp)
    inv = F(1.0) / e if xp is np else xp.reciprocal(e)
    return (e + inv) * _c(F(0.5), xp)
