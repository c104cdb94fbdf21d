"""PyTorch port: int8 post-training quantization (ops/quant.py,
models/quantized.py, the int8 path of params.from_numpy and
model.prepare_params) against the JAX package on the CPU.

Tolerances: int8 leaves equal JAX's, with a difference of one allowed only
at an exact rounding tie (w / scale within an fp32 ulp of k + 1/2, counted
and bounded at 0.1% of the entries); scales rtol 1e-6; the linears and
the quantized forwards in fp32 at the port's TOL (rtol = atol = 1e-4).
The int8 x int8 product is exact, so the padded product must equal the
unpadded one bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitrs_tpu.config import get_config as jax_config
from vitrs_tpu.models import quantized as JQ
from vitrs_tpu.ops import quant as JQT
from vitrs_tpu_torch import params as TP
from vitrs_tpu_torch.config import get_config as torch_config
from vitrs_tpu_torch.models import model as TM
from vitrs_tpu_torch.models import quantized as TQ
from vitrs_tpu_torch.ops import quant as TQT

from test_torch_helpers import both_params, np_params, small_cfgs

TOL = dict(rtol=1e-4, atol=1e-4)
JCFG, TCFG = small_cfgs()
VIT = dict(num_layers=2, channels=128, num_heads=2)
JVCFG = jax_config("vit-tiny-4-cifar10").replace(**VIT)
TVCFG = torch_config("vit-tiny-4-cifar10").replace(**VIT)


def _rng(seed):
    return np.random.default_rng(seed)


def _assert_int8_equal(got, want, w, scale):
    """got == want but for +-1 at exact rounding ties of w / scale."""
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    diff = got != want
    assert (np.abs(got - want) <= 1).all()
    if diff.any():
        r = (np.asarray(w, np.float32)
             / np.asarray(scale, np.float32)[..., None])[diff]
        frac = np.abs(np.abs(r) - np.floor(np.abs(r)) - 0.5)
        assert (frac <= 4 * np.spacing(np.abs(r).astype(np.float32))).all()
    assert diff.sum() <= 1e-3 * diff.size, diff.sum()


@pytest.mark.parametrize("shape,zero_rows", [((8, 16, 32), False),
                                             ((2, 96, 64), True),
                                             ((97, 128), False)])
def test_quantize_weight_matches_jax(shape, zero_rows):
    w = _rng(0).normal(size=shape).astype(np.float32)
    if zero_rows:
        w[0, :3] = 0.0
    wq, scale = TQT.quantize_weight(torch.from_numpy(w))
    jwq, jscale = JQT.quantize_weight(jnp.asarray(w))
    assert wq.dtype == torch.int8 and tuple(scale.shape) == shape[:-1]
    np.testing.assert_allclose(scale.numpy(), np.asarray(jscale), rtol=1e-6)
    _assert_int8_equal(wq.numpy(), jwq, w, scale.numpy())
    if zero_rows:
        assert (scale[0, :3] == 1.0).all() and (wq[0, :3] == 0).all()


@pytest.mark.parametrize("mode", ["gpt", "vit"])
def test_quantize_params_matches_jax(mode):
    jcfg, tcfg = (JCFG, TCFG) if mode == "gpt" else (JVCFG, TVCFG)
    jp, tp = both_params(jcfg, tcfg, seed=1)
    jq = JQT.quantize_params(jp, mode=mode)
    tq = TQT.quantize_params(tp, mode=mode)
    assert set(tq) == set(jq)
    keys = TQT._QUANT_KEYS_GPT if mode == "gpt" else TQT._QUANT_KEYS_VIT
    assert keys == (JQT._QUANT_KEYS_GPT if mode == "gpt"
                    else JQT._QUANT_KEYS_VIT)
    for k, v in tq.items():
        if k in keys:
            assert v.dtype == torch.int8
            _assert_int8_equal(v.numpy(), jq[k], tp[k].numpy(),
                               tq[k + "_scale"].numpy())
        elif k.endswith("_scale"):
            np.testing.assert_allclose(v.numpy(), np.asarray(jq[k]),
                                       rtol=1e-6)
        else:
            assert v is tp[k]          # passed through
    deq = TQT.dequantize_params(tq)
    jdeq = JQT.dequantize_params(jq)
    assert set(deq) == set(tp)
    for k in keys:
        np.testing.assert_allclose(deq[k].numpy(), np.asarray(jdeq[k]),
                                   rtol=1e-6, atol=1e-7)


def test_linear_w8_matches_jax():
    rng = _rng(2)
    x = rng.normal(size=(3, 6, 32)).astype(np.float32)
    w = rng.normal(size=(16, 32)).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32)
    wq, s = TQT.quantize_weight(torch.from_numpy(w))
    got = TQT.linear_w8(torch.from_numpy(x), wq, s, torch.from_numpy(b))
    want = JQT.linear_w8(jnp.asarray(x), jnp.asarray(wq.numpy()),
                         jnp.asarray(s.numpy()), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# (rows, K, N): every padding the CUDA product needs (rows <= 16, K and N
# not multiples of 8, the GPT head's N = 50257 shape class), and none
@pytest.mark.parametrize("M,K,N", [(5, 30, 13), (1, 64, 97), (16, 8, 8),
                                   (64, 128, 96)])
def test_linear_w8a8_matches_jax(M, K, N):
    rng = _rng(3)
    x = rng.normal(size=(M, K)).astype(np.float32)
    x[0] = 0.0                          # an all-zero row: scale 1
    w = rng.normal(size=(N, K)).astype(np.float32)
    b = rng.normal(size=(N,)).astype(np.float32)
    wq, s = TQT.quantize_weight(torch.from_numpy(w))
    got = TQT.linear_w8a8(torch.from_numpy(x), wq, s, torch.from_numpy(b))
    want = JQT.linear_w8a8(jnp.asarray(x), jnp.asarray(wq.numpy()),
                           jnp.asarray(s.numpy()), jnp.asarray(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("M,K,N", [(3, 20, 50), (17, 24, 7), (40, 64, 64)])
def test_int8_matmul_padded_equals_unpadded(M, K, N):
    """On the CPU `torch._int_mm` takes any shape: the padded product the
    port runs everywhere equals the unpadded one, and the int32 sums."""
    gen = torch.Generator().manual_seed(M)
    xq = torch.randint(-127, 128, (M, K), generator=gen, dtype=torch.int8)
    wq = torch.randint(-127, 128, (N, K), generator=gen, dtype=torch.int8)
    got = TQT.int8_matmul(xq, wq)
    assert got.dtype == torch.int32 and tuple(got.shape) == (M, N)
    assert torch.equal(got, torch._int_mm(xq, wq.t().contiguous()))
    assert torch.equal(got, xq.int() @ wq.int().t())


@pytest.mark.parametrize("w8a8", [False, True], ids=["w8", "w8a8"])
def test_vit_forward_q_matches_jax(w8a8):
    jp, tp = both_params(JVCFG, TVCFG, seed=4)
    jq = JQT.quantize_params(jp, mode="vit")
    tq = TP.from_numpy({k: np.asarray(v) for k, v in jq.items()}, TVCFG,
                       "cpu", torch.float32)
    x = _rng(5).standard_normal((3, 32, 32, 3), dtype=np.float32)
    want = np.asarray(JQ.vit_forward_q(jq, jnp.asarray(x), JVCFG,
                                       w8a8=w8a8))
    for q in (tq, TM.prepare_params(tq, TVCFG)):
        got = TQ.vit_forward_q(q, torch.from_numpy(x), TVCFG, w8a8=w8a8)
        assert got.dtype == torch.float32 and tuple(got.shape) == (3, 10)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("w8a8", [False, True], ids=["w8", "w8a8"])
def test_gpt_forward_q_matches_jax(w8a8):
    """T=40 causal on the flash route (the plain K1-fwd here); the head
    (N = 97) takes the padded int8 product under w8a8."""
    jp, tp = both_params(JCFG, TCFG, seed=6)
    jq = JQT.quantize_params(jp, mode="gpt")
    tq = TQT.quantize_params(tp, mode="gpt")
    toks = _rng(7).integers(0, TCFG.vocab_size, (2, 40))
    got = TQ.gpt_forward_q(tq, torch.as_tensor(toks), TCFG, w8a8=w8a8)
    want = JQ.gpt_forward_q(jq, jnp.asarray(toks), JCFG, w8a8=w8a8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("w8a8", [False, True], ids=["w8", "w8a8"])
def test_prepared_int8_head_is_padded_once(w8a8):
    """prepare_params pads the int8 head's 97 output channels once to 104
    zero-padded rows (an aligned weight keeps its storage); the
    prepared forward equals the unprepared one, whose product pads the
    weight itself."""
    _, tp = both_params(JCFG, TCFG, seed=6)
    tq = TQT.quantize_params(tp, mode="gpt")
    pq = TM.prepare_params(tq, TCFG)
    assert tuple(pq["wte"].shape) == (104, TCFG.channels)
    assert torch.equal(pq["wte"][:97], tq["wte"])
    assert not pq["wte"][97:].any()
    assert (pq["fcw"].shape == tq["fcw"].shape
            and pq["fcw"].data_ptr() == tq["fcw"].data_ptr())
    toks = torch.as_tensor(_rng(7).integers(0, TCFG.vocab_size, (2, 40)))
    got = TQ.gpt_forward_q(pq, toks, TCFG, w8a8=w8a8)
    assert tuple(got.shape) == (2, 40, 97)
    assert torch.equal(got, TQ.gpt_forward_q(tq, toks, TCFG, w8a8=w8a8))


def test_from_numpy_takes_jax_quantized_params():
    jp, _ = both_params(JCFG, TCFG, seed=8)
    arrs = {k: np.asarray(v) for k, v in
            JQT.quantize_params(jp, mode="gpt").items()}
    tq = TP.from_numpy(arrs, TCFG, "cpu")
    assert set(tq) == set(arrs)
    for k, v in arrs.items():
        assert tq[k].dtype == (torch.int8 if v.dtype == np.int8
                               else torch.float32), k
        np.testing.assert_array_equal(tq[k].numpy(), v)
    bad = dict(arrs, qkvw=arrs["qkvw"].astype(np.float32))
    with pytest.raises(ValueError, match="int8"):
        TP.from_numpy(bad, TCFG, "cpu")
    bad = dict(arrs, fcw_scale=arrs["fcw_scale"][..., :3])
    with pytest.raises(ValueError, match="scale"):
        TP.from_numpy(bad, TCFG, "cpu")


def test_prepare_params_keeps_int8_and_builds_no_head():
    _, tp = both_params(JCFG, TCFG, seed=9)
    cfg = TCFG.replace(dtype="bfloat16")
    pq = TM.prepare_params(TQT.quantize_params(tp, mode="gpt"), cfg)
    assert "head" not in pq
    for k in TQT._QUANT_KEYS_GPT:
        assert pq[k].dtype == torch.int8
        assert pq[k + "_scale"].dtype == torch.float32
    assert pq["qkvb"].dtype == torch.bfloat16
    assert pq["ln1w"].dtype == torch.float32
    keys = TM.block_keys(pq)
    assert {"qkvw_scale", "attprojw_scale", "fcw_scale",
            "fcprojw_scale"} <= set(keys) and "wte_scale" not in keys
    assert set(TM.layer(pq, 1)) == set(keys)
    # the float path is unchanged: a head, no scales among the block keys
    pf = TM.prepare_params(tp, cfg)
    assert pf["head"].dtype == torch.bfloat16
    assert TM.block_keys(pf) == TM.BLOCK_KEYS


def test_int8_refusals():
    """MoE with int8 weights and the configs the JAX int8 forwards do not
    compute (GQA, rope) raise ValueError."""
    mcfg = TCFG.replace(num_experts=2).validate()
    arrs = np_params(mcfg, seed=10)
    tq = TQT.quantize_params(TP.from_numpy(arrs, mcfg, "cpu"), mode="gpt")
    with pytest.raises(ValueError, match="MoE"):
        TM.prepare_params(tq, mcfg)
    toks = torch.zeros(1, 4, dtype=torch.long)
    _, tp = both_params(JCFG, TCFG, seed=10)
    tq = TQT.quantize_params(tp, mode="gpt")
    for kw in (dict(pos_emb="rope"), dict(window=4)):
        with pytest.raises(ValueError, match="int8 forwards"):
            TQ.gpt_forward_q(tq, toks, TCFG.replace(**kw).validate())
