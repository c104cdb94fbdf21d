"""PyTorch port: models/model.py and models/generate.py against the JAX
package, fp32, at L=2, NH=2, C=128 (D=64, so the prefill attention takes
the flash path), vocab 97.  Logits and caches at atol/rtol 1e-4; greedy
tokens equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitrs_tpu.models import generate as JG
from vitrs_tpu.models import model as JM
from vitrs_tpu_torch.models import generate as TG
from vitrs_tpu_torch.models import model as TM

from test_torch_helpers import both_params, small_cfgs

TOL = dict(rtol=1e-4, atol=1e-4)
JCFG, TCFG = small_cfgs()


@pytest.fixture(scope="module")
def params():
    jp, tp = both_params(JCFG, TCFG, seed=0)
    return jp, TM.prepare_params(tp, TCFG)


def _toks(shape, seed):
    return np.random.default_rng(seed).integers(0, TCFG.vocab_size, shape)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_gpt_forward(params):
    jp, tp = params
    toks = _toks((2, 50), 0)
    _close(TM.gpt_forward(tp, torch.as_tensor(toks), TCFG),
           JM.gpt_forward(jp, jnp.asarray(toks), JCFG))


@pytest.mark.parametrize("last_only", [False, True])
def test_prefill_logits_and_caches(params, last_only):
    jp, tp = params
    toks = _toks((2, 37), 1)
    jl, (jk, jv) = JG.forward_with_cache(jp, jnp.asarray(toks),
                                         JG.init_kv_cache(JCFG, 2, 48), 0,
                                         JCFG, last_only=last_only)
    tl, (tk, tv) = TG.forward_with_cache(tp, torch.as_tensor(toks),
                                         TG.init_kv_cache(TCFG, 2, 48, device="cpu"), 0,
                                         TCFG, last_only=last_only)
    assert tuple(tl.shape) == jl.shape and tl.dtype == torch.float32
    _close(tl, jl)
    _close(tk, jk)
    _close(tv, jv)


def test_continuation_against_cache(params):
    """pos > 0 steps attend against the cache in plain torch."""
    jp, tp = params
    toks = _toks((2, 20), 2)
    jc = JG.init_kv_cache(JCFG, 2, 32)
    tc = TG.init_kv_cache(TCFG, 2, 32, device="cpu")
    for pos, S in ((0, 12), (12, 1), (13, 4)):
        chunk = toks[:, pos:pos + S]
        jl, jc = JG.forward_with_cache(jp, jnp.asarray(chunk), jc, pos, JCFG)
        tl, tc = TG.forward_with_cache(tp, torch.as_tensor(chunk), tc, pos,
                                       TCFG)
        _close(tl, jl)
    _close(tc[0], jc[0])


def test_decode_step_multi(params):
    jp, tp = params
    rng = np.random.default_rng(3)
    shape = (TCFG.num_layers, 3, 24, TCFG.channels)
    kc, vc = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
    toks = rng.integers(0, TCFG.vocab_size, 3)
    pos = np.array([0, 9, 23])
    jl, (jk, jv) = JG.decode_step_multi(
        jp, jnp.asarray(toks), (jnp.asarray(kc), jnp.asarray(vc)),
        jnp.asarray(pos), JCFG)
    tcaches = (torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()))
    tl, (tk, tv) = TG.decode_step_multi(tp, torch.as_tensor(toks), tcaches,
                                        torch.as_tensor(pos), TCFG)
    assert tk is tcaches[0]                     # updated in place
    _close(tl, jl)
    _close(tk, jk)
    _close(tv, jv)


def test_prefill_into_slots(params):
    jp, tp = params
    prompts = _toks((2, 16), 4)
    slots = np.array([2, 0])
    jl, (jk, _) = JG.prefill_into_slots(jp, jnp.asarray(prompts),
                                        JG.init_kv_cache(JCFG, 3, 32),
                                        jnp.asarray(slots), JCFG)
    tl, (tk, _) = TG.prefill_into_slots(tp, torch.as_tensor(prompts),
                                        TG.init_kv_cache(TCFG, 3, 32, device="cpu"),
                                        torch.as_tensor(slots), TCFG)
    _close(tl, jl)
    _close(tk, jk)


@pytest.mark.parametrize("T0,max_new", [(9, 12), (40, 20)])
def test_greedy_generate_matches_jax(params, T0, max_new):
    jp, tp = params
    prompt = _toks((2, T0), 5 + T0)
    want = JG.generate(jp, jnp.asarray(prompt), JCFG, max_new=max_new,
                       key=jax.random.PRNGKey(0), temperature=0.0)
    got = TG.generate(tp, torch.as_tensor(prompt), TCFG, max_new=max_new,
                      temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_ticks_greedy_matches_jax(params):
    jp, tp = params
    rng = np.random.default_rng(6)
    prompts = rng.integers(0, TCFG.vocab_size, (2, 8))
    toks, pos = prompts[:, -1], np.array([7, 7])
    jc = JG.prefill_into_slots(jp, jnp.asarray(prompts),
                               JG.init_kv_cache(JCFG, 2, 32),
                               jnp.arange(2), JCFG)[1]
    tc = TG.prefill_into_slots(tp, torch.as_tensor(prompts),
                               TG.init_kv_cache(TCFG, 2, 32, device="cpu"),
                               torch.arange(2), TCFG)[1]
    jt, _, jpos = JG.decode_ticks_multi(
        jp, jnp.asarray(toks), jc, jnp.asarray(pos),
        jax.random.split(jax.random.PRNGKey(0), 5), jnp.zeros(2), JCFG, 0)
    tt, _, tpos = TG.decode_ticks_multi(
        tp, torch.as_tensor(toks), tc, torch.as_tensor(pos), 5,
        torch.zeros(2), TCFG, 0)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))


def test_sampled_generate_is_seeded(params):
    _, tp = params
    prompt = torch.as_tensor(_toks((2, 6), 7))
    outs = [TG.generate(tp, prompt, TCFG, max_new=10, temperature=0.9,
                        top_k=5, top_p=0.9,
                        generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    assert outs[0].shape == (2, 16)
    assert ((outs[0] >= 0) & (outs[0] < TCFG.vocab_size)).all()


@pytest.mark.parametrize("top_k,top_p", [(5, 0.0), (0, 0.7), (3, 0.5)])
def test_filter_logits_matches_jax(top_k, top_p):
    lg = np.random.default_rng(8).standard_normal((4, 97)).astype(np.float32)
    got = TG._filter_logits(torch.from_numpy(lg), top_k, top_p).numpy()
    want = np.asarray(JG._filter_logits(jnp.asarray(lg), top_k, top_p))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got[~np.isinf(got)], want[~np.isinf(want)])


def test_not_ported_yet_raises(params):
    _, tp = params
    prompt = torch.as_tensor(_toks((1, 8), 9))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TG.generate(tp, prompt, TCFG, max_new=2, temperature=0.0,
                    kv_int8=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TG.generate_beam(tp, prompt, TCFG, 2)
    # rope, the sliding window and MoE are ported; a ring cache needs a
    # window
    for kw in (dict(pos_emb="rope"), dict(window=4), dict(num_experts=2)):
        TM.prepare_params(tp, TCFG.replace(**kw).validate())
    with pytest.raises(ValueError, match="sliding-window"):
        TG.generate_streaming(tp, prompt, TCFG, 2)


@pytest.mark.parametrize("use_flash", [True, False])
def test_fresh_prefill_honours_use_flash(monkeypatch, use_flash):
    """A fresh prompt's prefill takes the flash route (the plain K1-fwd on
    the CPU) only with use_flash on; off, dense attention, as the JAX
    prefill passes its switch on.  Logits and caches equal the JAX
    package's with the same switch."""
    from vitrs_tpu_torch.ops import basic as TB
    from vitrs_tpu_torch.ops import flash_attention as TFA
    calls = []
    for module, name in ((TFA, "flash_fwd_plain"), (TB, "attention_dense")):
        fn = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, fn=fn, name=name, **k:
                            calls.append(name) or fn(*a, **k))
    jp, tp = both_params(JCFG, TCFG, seed=0)
    jcfg, tcfg = (c.replace(use_flash=use_flash) for c in (JCFG, TCFG))
    toks = _toks((2, 37), 12)
    jl, (jk, jv) = JG.forward_with_cache(jp, jnp.asarray(toks),
                                         JG.init_kv_cache(jcfg, 2, 48), 0,
                                         jcfg)
    tl, (tk, tv) = TG.forward_with_cache(
        TM.prepare_params(tp, tcfg), torch.as_tensor(toks),
        TG.init_kv_cache(tcfg, 2, 48, device="cpu"), 0, tcfg)
    want = "flash_fwd_plain" if use_flash else "attention_dense"
    assert calls == [want] * tcfg.num_layers
    _close(tl, jl)
    _close(tk, jk)
    _close(tv, jv)
