"""PyTorch port: the bit-exact mode (ops/bitexact.py) and its oracle, on
the CPU.  The gate is ==, not allclose:

  * the port's bitmath (`TORCH`: exp32, tanh32, cosh32, ldexp) bitwise
    equal to the JAX package's numpy bitmath on a sweep that includes the
    exp clamp (|x| around 80), subnormal inputs and subnormal ldexp
    results;
  * the port's copy of oracle/bitexact_ref.py bitwise equal to the
    original;
  * the loss and all 16 gradients of the torch eager mode bitwise equal to
    the port's oracle copy at the JAX test's size (B=2, T=4, C=16, NH=2,
    V=11, L=2), and to the JAX package's ops/bitexact at a smaller one;
  * the mode agrees with the port's production quirk path (rtol 2e-5).
The same mode on the card: tests/test_torch_families_cuda.py and
chip_smoke.py's bitexact phase.
"""

import numpy as np
import pytest
import torch

from vitrs_tpu import bitmath as JBM
from vitrs_tpu.ops import bitexact as JBX
from vitrs_tpu.oracle import bitexact_ref as JREF
from vitrs_tpu_torch import bitmath as TBM
from vitrs_tpu_torch import params as TP
from vitrs_tpu_torch.models import model as TM
from vitrs_tpu_torch.ops import bitexact as TBX
from vitrs_tpu_torch.oracle import bitexact_ref as TREF
from vitrs_tpu_torch.oracle import numpy_ref as TO

from test_torch_helpers import torch_config
from test_torch_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, T, C, NH, V, L = 2, 4, 16, 2, 11, 2


def _setup(seed=0):
    cfg = torch_config("gpt-nano").replace(max_seq_len=T, vocab_size=V,
                                           num_layers=L, num_heads=NH,
                                           channels=C)
    params = TO.init_parameters(TP.param_shapes(cfg), seed=seed)
    rng = np.random.default_rng(seed + 1)
    inputs = rng.integers(0, V, (B, T)).astype(np.int32)
    targets = rng.integers(0, V, (B, T)).astype(np.int32)
    return cfg, params, inputs, targets


def _bits(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32).view(np.uint32)


def _sweep():
    rng = np.random.default_rng(0)
    edges = np.array([-81, -80.5, -80, -79.99, 79.99, 80, 80.5, 81, -87.4,
                      88.8, -1e30, 1e30, 0.0, -0.0, 1e-45, -1e-45, 1e-40,
                      -1e-40, 1.1754944e-38, -1.1754942e-38, 0.5, -0.5,
                      np.log(2.0), 20.0, -20.0], np.float32)
    return np.concatenate([edges, np.linspace(-90, 90, 4001, dtype=np.float32),
                           (rng.standard_normal(4000) * 30).astype(np.float32)])


@pytest.mark.parametrize("fn", ["exp32", "tanh32", "cosh32"])
def test_bitmath_torch_form_is_bitwise_numpys(fn):
    x = _sweep()
    want = getattr(JBM, fn)(x, np)
    np.testing.assert_array_equal(_bits(getattr(TBM, fn)(x, np)), _bits(want))
    got = getattr(TBM, fn)(torch.from_numpy(x), TBM.TORCH)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_ldexp_from_exponent_bits_is_bitwise_np_ldexp():
    rng = np.random.default_rng(1)
    p = np.concatenate([rng.random(3000).astype(np.float32) * 2,
                        np.array([1.0, 1.9999999, 0.5, 0.75, 1.5], np.float32)])
    k = np.concatenate([rng.integers(-126, 128, 3000),
                        np.array([-126, 127, -126, -126, -126])])
    want = np.ldexp(p, k.astype(np.int32))
    assert (np.abs(want) < np.finfo(np.float32).tiny).sum() > 5   # subnormal
    got = TBM.TORCH.ldexp(torch.from_numpy(p),
                          torch.from_numpy(k.astype(np.float32)))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_oracle_copy_is_bitwise_the_original():
    _, params, inputs, targets = _setup(3)
    lj, aj = JREF.model_forward(params, inputs, targets, NH)
    lt, at = TREF.model_forward(params, inputs, targets, NH)
    assert _bits(lj) == _bits(lt)
    gj = JREF.model_backward(params, aj, inputs, targets, NH)
    gt = TREF.model_backward(params, at, inputs, targets, NH)
    for k in gj:
        np.testing.assert_array_equal(_bits(gj[k]), _bits(gt[k]), err_msg=k)


def test_loss_bitwise_equal():
    _, params, inputs, targets = _setup()
    loss_ref, _ = TREF.model_forward(params, inputs, targets, NH)
    loss, _ = TBX.model_forward(params, inputs, targets, NH, device="cpu")
    assert _bits(loss_ref) == _bits(loss), f"{loss_ref!r} != {float(loss)!r}"


@pytest.mark.parametrize("seed", [0, 7])
def test_all_16_grads_bitwise_equal_to_the_oracle(seed):
    _, params, inputs, targets = _setup(seed)
    loss_ref, acts = TREF.model_forward(params, inputs, targets, NH)
    g_ref = TREF.model_backward(params, acts, inputs, targets, NH)
    loss, g = TBX.loss_and_grads(params, inputs, targets, NH, device="cpu")
    assert _bits(loss_ref) == _bits(loss)
    assert set(g) == set(g_ref) == set(TP.CANONICAL_16)
    _assert_bitwise(g, g_ref, "oracle")


def _assert_bitwise(got, want, who):
    for k in want:
        a, b = _bits(want[k]), _bits(got[k])
        n_diff = int((a != b).sum())
        assert n_diff == 0, (
            f"{k} vs {who}: {n_diff}/{a.size} elements differ (max ulp "
            f"{np.abs(a.astype(np.int64) - b.astype(np.int64)).max()})")


def _small():
    """B=1, T=3, C=8, V=5, L=1: JAX compiles each eager op of its mode on
    first use (about 5 s for the forward and 4 s for the backward, at any
    of these sizes; the JAX package's own tests hold its bits to the same
    oracle at the size above)."""
    cfg = torch_config("gpt-nano").replace(max_seq_len=3, vocab_size=5,
                                           num_layers=1, num_heads=2,
                                           channels=8)
    params = TO.init_parameters(TP.param_shapes(cfg), seed=4)
    rng = np.random.default_rng(5)
    inputs, targets = (rng.integers(0, 5, (1, 3)) for _ in range(2))
    return params, inputs, targets


def test_loss_and_probs_bitwise_equal_to_jax_ops_bitexact():
    params, inputs, targets = _small()
    loss_jax, acts_jax = JBX.model_forward(params, inputs, targets, 2)
    loss, acts = TBX.model_forward(params, inputs, targets, 2, device="cpu")
    assert _bits(loss_jax) == _bits(loss)
    np.testing.assert_array_equal(_bits(acts["probs"]),
                                  _bits(acts_jax["probs"]))


def test_grads_bitwise_equal_to_jax_ops_bitexact():
    params, inputs, targets = _small()
    _, g_jax = JBX.loss_and_grads(params, inputs, targets, 2)
    _, g = TBX.loss_and_grads(params, inputs, targets, 2, device="cpu")
    _assert_bitwise(g, g_jax, "jax")


def test_inference_sentinel():
    _, params, inputs, _ = _setup()
    loss, acts = TBX.model_forward(params, inputs, None, NH, device="cpu")
    assert float(loss) == -1.0 and acts["probs"].shape == (B, T, V)


def test_bitexact_mode_agrees_with_the_production_quirk_path():
    cfg, params, inputs, targets = _setup()
    cfg = cfg.replace(quirks=True, use_flash=False, dtype="float32")
    loss_bits, _ = TBX.model_forward(params, inputs, targets, NH,
                                     device="cpu")
    p = TP.from_numpy(params, cfg, "cpu")
    loss = TM.loss_fn(p, torch.as_tensor(inputs).long(),
                      torch.as_tensor(targets).long(), cfg)
    np.testing.assert_allclose(float(loss_bits), float(loss), rtol=2e-5)
