"""PyTorch port: models/speculative.py against the JAX package, fp32 on the
CPU.  Greedy output equals JAX's speculative output and target-only greedy
`generate` of both packages token for token; a self-draft accepts every
proposal (tests/test_speculative.py:25-55); sampled output is in the vocab
with consistent stats, and a sampled self-draft accepts everything
(u < p/q = 1); the verify chunk takes K4 (its plain version here) exactly
when the cache length T0 + max_new + K + 1 is a multiple of 256."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitrs_tpu.models import generate as JG
from vitrs_tpu.models import speculative as JS
from vitrs_tpu_torch.models import generate as TG
from vitrs_tpu_torch.models import model as TM
from vitrs_tpu_torch.models import speculative as TS
from vitrs_tpu_torch.ops import flash_prefill as TFP

from test_torch_helpers import both_params, small_cfgs

JT, TT = small_cfgs()                       # target: L=2, 2 heads of 64
JD, TD = small_cfgs(num_layers=1, channels=64, num_heads=1)   # draft


@pytest.fixture(scope="module")
def models():
    jt, tt = both_params(JT, TT, seed=0)
    jd, td = both_params(JD, TD, seed=1)
    prompt = np.random.default_rng(0).integers(0, TT.vocab_size, (1, 5))
    return (jt, jd, jnp.asarray(prompt), TM.prepare_params(tt, TT),
            TM.prepare_params(td, TD), torch.as_tensor(prompt))


@pytest.mark.parametrize("K", [1, 3, 4])
def test_greedy_equals_jax_and_target_generate(models, K):
    jt, jd, jprompt, tt, td, prompt = models
    want = np.asarray(JG.generate(jt, jprompt, JT, max_new=16,
                                  key=jax.random.PRNGKey(0), temperature=0.0))
    jout, jstats = JS.generate_speculative(jt, jd, jprompt, JT, JD,
                                           max_new=16, K=K,
                                           key=jax.random.PRNGKey(0))
    out, stats = TS.generate_speculative(tt, td, prompt, TT, TD, max_new=16,
                                         K=K)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(
        out.numpy(), TG.generate(tt, prompt, TT, 16, temperature=0.0).numpy())
    assert stats == {k: int(v) for k, v in jstats.items()}
    assert stats["drafted"] == K * stats["target_calls"]
    assert 0 <= stats["accepted"] <= stats["drafted"]


def test_self_draft_accepts_everything_greedy(models):
    _, _, _, tt, _, prompt = models
    K = 4
    out, stats = TS.generate_speculative(tt, tt, prompt, TT, TT, max_new=16,
                                         K=K)
    assert stats["accepted"] == stats["drafted"]
    assert stats["target_calls"] == -(-16 // (K + 1))
    np.testing.assert_array_equal(
        out.numpy(), TG.generate(tt, prompt, TT, 16, temperature=0.0).numpy())


def test_sampled_valid_and_self_draft_accepts(models):
    _, _, _, tt, td, prompt = models
    for draft, dcfg in ((td, TD), (tt, TT)):
        outs = [TS.generate_speculative(
            tt, draft, prompt, TT, dcfg, max_new=12, K=3,
            generator=torch.Generator().manual_seed(3), temperature=0.9,
            top_k=11) for _ in range(2)]
        (out, stats), (out2, _) = outs
        assert torch.equal(out, out2)               # seeded
        assert tuple(out.shape) == (1, 17) and torch.equal(out[:, :5], prompt)
        assert ((out >= 0) & (out < TT.vocab_size)).all()
        assert stats["drafted"] == 3 * stats["target_calls"]
        assert 0 <= stats["accepted"] <= stats["drafted"]
    assert stats["accepted"] == stats["drafted"]    # the self-draft


@pytest.mark.parametrize("max_new,k4", [(122, True), (121, False)])
def test_verify_chunk_routes_by_cache_length(monkeypatch, max_new, k4):
    """T0 + max_new + K + 1 = 256 (K4) or 255 (dense); greedy output is
    target-only `generate`'s either way."""
    jcfg, tcfg = small_cfgs(max_seq_len=256)
    tp = TM.prepare_params(both_params(jcfg, tcfg, seed=2)[1], tcfg)
    calls = []
    plain = TFP.flash_prefill_plain
    monkeypatch.setattr(TFP, "flash_prefill_plain",
                        lambda *a, **k: calls.append(a[5]) or plain(*a, **k))
    prompt = torch.as_tensor(np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (1, 128)))
    out, stats = TS.generate_speculative(tp, tp, prompt, tcfg, tcfg,
                                         max_new=max_new, K=5)
    assert len(calls) == (tcfg.num_layers * stats["target_calls"] if k4
                          else 0)
    np.testing.assert_array_equal(
        out.numpy(),
        TG.generate(tp, prompt, tcfg, max_new, temperature=0.0).numpy())


def test_refusals(models):
    _, _, _, tt, td, prompt = models
    with pytest.raises(ValueError, match="B=1"):
        TS.generate_speculative(tt, td, prompt.repeat(2, 1), TT, TD, 4, 2)
    with pytest.raises(ValueError, match="max_seq_len"):
        TS.generate_speculative(tt, td, prompt, TT, TD, 56, 3)
    with pytest.raises(ValueError, match="vocabulary"):
        TS.generate_speculative(tt, td, prompt, TT,
                                TD.replace(vocab_size=98), 4, 2)
    with pytest.raises(ValueError, match="generator"):
        TS.generate_speculative(tt, td, prompt, TT, TD, 4, 2,
                                temperature=0.5)
