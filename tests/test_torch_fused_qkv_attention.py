"""PyTorch port: the fused qkv-attention op's projection backward against
the JAX package's `qkv_projection_bwd`, on the CPU, from the same numpy
operands.

The weight gradient is the fp32 product of the compute-dtype operands
(the JAX op's `preferred_element_type=float32`), so it is held at
rtol 1e-5 of its largest value in bf16 as in fp32: a product rounded to
bf16 (2^-9 relative) fails that.  dln1 comes back in the operands' dtype:
fp32 at 1e-5; bf16 within 2e-2 of its largest value (three bf16 matmuls
summed in bf16, in another order).  dqkvb: fp32 sums, 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitrs_tpu.ops import fused_qkv_attention as JQ
from vitrs_tpu_torch.ops import fused_qkv_attention as TQ

B, T, C = 2, 64, 128


def _close(got, want, rtol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rtol, f"max error {err:.3e} of the largest value"
    return err


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_qkv_projection_bwd_matches_jax(dtype):
    rng = np.random.default_rng(0)
    dq, dk, dv, ln1 = (rng.standard_normal((B, T, C)).astype(np.float32)
                       for _ in range(4))
    qkvw = (0.05 * rng.standard_normal((3 * C, C))).astype(np.float32)
    tdt = getattr(torch, dtype)
    parts = [torch.from_numpy(a).to(tdt) for a in (dq, dk, dv, ln1)]
    dln1, dqkvw, dqkvb = TQ.qkv_projection_bwd(
        *parts, torch.from_numpy(qkvw).to(tdt))
    assert dqkvw.dtype == dqkvb.dtype == torch.float32
    assert dln1.dtype == tdt
    jparts = [jnp.asarray(t.float().numpy()).astype(dtype) for t in parts]
    jdln1, jdqkvw, jdqkvb = JQ.qkv_projection_bwd(*jparts, jnp.asarray(qkvw))
    _close(dln1.float(), jdln1.astype(jnp.float32),
           2e-2 if dtype == "bfloat16" else 1e-5)
    _close(dqkvw, jdqkvw, 1e-5)
    _close(dqkvb, jdqkvb, 1e-5)
    if dtype == "bfloat16":
        # the test can tell: the same product rounded to bf16 is off by more
        rounded = dqkvw.to(torch.bfloat16).float()
        with pytest.raises(AssertionError):
            _close(rounded, jdqkvw, 1e-5)


def test_matmul_fp32_widens_half_operands_on_the_cpu():
    rng = np.random.default_rng(1)
    a, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(torch.bfloat16) for s in ((64, 96), (96, 32)))
    got = TQ.matmul_fp32(a, b)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, a.double().matmul(b.double()).float(),
                               rtol=1e-5, atol=1e-5)
