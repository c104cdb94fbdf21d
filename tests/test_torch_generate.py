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
from vitrs_tpu.ops import quant as JQT
from vitrs_tpu_torch.models import generate as TG
from vitrs_tpu_torch.models import model as TM
from vitrs_tpu_torch.ops import flash_prefill as TFP
from vitrs_tpu_torch.ops import quant as TQT

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
    """What once raised for ROADMAP.md item 15 now runs: the int8 KV cache
    and beam search (held against JAX below); a ring cache still needs a
    window."""
    _, tp = params
    prompt = torch.as_tensor(_toks((1, 8), 9))
    out = TG.generate(tp, prompt, TCFG, max_new=2, temperature=0.0,
                      kv_int8=True)
    assert tuple(out.shape) == (1, 10) and torch.equal(out[:, :8], prompt)
    out = TG.generate_beam(tp, prompt, TCFG, 2)
    assert tuple(out.shape) == (1, 10) and torch.equal(out[:, :8], prompt)
    with pytest.raises(ValueError, match="max_seq_len"):
        TG.generate_beam(tp, prompt, TCFG, TCFG.max_seq_len)
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


# --------------------------------------------------------------------------
# The int8 KV cache (JAX l.58-76, 172-257): values within one int8 step of
# their scale, rounding as JAX rounds (a one-step difference only at an
# exact tie, counted: at most 0.1% of the entries)
# --------------------------------------------------------------------------

def _int8_close(got, want, what):
    got, want = got.numpy().astype(np.int32), np.asarray(want, np.int32)
    assert (np.abs(got - want) <= 1).all(), what
    assert (got != want).sum() <= 1e-3 * got.size, what


def _int8_pairs_close(tc, jc):
    """Port int8 caches equal JAX's within `_int8_close`, scales at TOL:
    k and v carry fp32 noise (another summation order), which moves a
    value sitting at a rounding boundary by one step, and an absmax by an
    ulp."""
    for (tq, ts), (jq, js) in zip(tc, jc):
        _int8_close(tq, jq, "cache values")
        _close(ts, js)


def test_int8_kv_forward_matches_jax(params):
    """A fresh prompt (exact k/v), a decode step and a dense continuation
    chunk (cache length 32: not K4's) against the int8 cache.  The caches
    agree with JAX's as `_int8_pairs_close` says; each step's logits are
    held at TOL from the same int8 history (JAX's, copied in), so that a
    value one rounding step apart does not reach them.  After the prefill,
    which attends the exact k/v in both, the dequantized cache lies within
    one int8 step (scale / 127) of the raw cache written from the same
    k/v."""
    jp, tp = params
    toks = _toks((2, 20), 21)
    jc = JG.init_kv_cache(JCFG, 2, 32, int8=True)
    tc = TG.init_kv_cache(TCFG, 2, 32, int8=True, device="cpu")
    assert tc[0][0].dtype == torch.int8 and (tc[0][1] == 1).all()
    for pos, S in ((0, 12), (12, 1), (13, 4)):
        for tpair, jpair in zip(tc, jc):
            for t, j in zip(tpair, jpair):
                t.copy_(torch.from_numpy(np.array(j)))
        chunk = toks[:, pos:pos + S]
        jl, jc = JG.forward_with_cache(jp, jnp.asarray(chunk), jc, pos, JCFG)
        tl, tc = TG.forward_with_cache(tp, torch.as_tensor(chunk), tc, pos,
                                       TCFG)
        _close(tl, jl)
        _int8_pairs_close(tc, jc)
        if pos == 0:
            raw = TG.forward_with_cache(tp, torch.as_tensor(chunk),
                                        TG.init_kv_cache(TCFG, 2, 12,
                                                         device="cpu"),
                                        0, TCFG)[1]
            for (tq, ts), r in zip(tc, raw):
                L, B, _, KH, D = tq.shape
                deq = TG._dequant_rows(tq[:, :, :12], ts[:, :, :12],
                                       torch.float32).reshape(L, B, 12, -1)
                step = (ts[:, :, :12] / 127.0).expand(L, B, 12, KH, D)
                assert ((deq - r).abs()
                        <= step.reshape(L, B, 12, -1) * (1 + 1e-5)).all()


def test_int8_kv_chunked_prefill_through_k4(monkeypatch):
    """A 64-token prompt in chunks of 16 against a 256-slot int8 cache:
    the port's continuation chunks take K4 (its plain version here) over
    the dequantized cache, the JAX package's (no Mosaic on the CPU) dense
    attention over the same values; last-position logits agree."""
    jcfg, tcfg = small_cfgs(max_seq_len=256)
    jp, tp = both_params(jcfg, tcfg, seed=22)
    tp = TM.prepare_params(tp, tcfg)
    calls = []
    plain = TFP.flash_prefill_plain
    monkeypatch.setattr(TFP, "flash_prefill_plain",
                        lambda *a, **k: calls.append(a[5]) or plain(*a, **k))
    toks = np.random.default_rng(23).integers(0, tcfg.vocab_size, (2, 64))
    jc = JG.init_kv_cache(jcfg, 2, 256, int8=True)
    tc = TG.init_kv_cache(tcfg, 2, 256, int8=True, device="cpu")
    for off in range(0, 64, 16):
        chunk = toks[:, off:off + 16]
        jl, jc = JG.forward_with_cache(jp, jnp.asarray(chunk), jc, off, jcfg,
                                       last_only=True)
        tl, tc = TG.forward_with_cache(tp, torch.as_tensor(chunk), tc, off,
                                       tcfg, last_only=True)
    assert calls == [off for off in (16, 32, 48)
                     for _ in range(tcfg.num_layers)]
    _close(tl, jl)


@pytest.mark.parametrize("chunk", [0, 8])
def test_generate_kv_int8_matches_jax(params, chunk):
    jp, tp = params
    prompt = _toks((2, 16), 24 + chunk)
    want = JG.generate(jp, jnp.asarray(prompt), JCFG, max_new=10,
                       key=jax.random.PRNGKey(0), temperature=0.0,
                       kv_int8=True, prefill_chunk=chunk)
    got = TG.generate(tp, torch.as_tensor(prompt), TCFG, max_new=10,
                      temperature=0.0, kv_int8=True, prefill_chunk=chunk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# int8 weights on every decode path (JAX _plin, l.110-119, 269-295, 626-646)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qparams(params):
    jp, _ = params
    jq = JQT.quantize_params(jp, mode="gpt")
    from vitrs_tpu_torch import params as TP
    tq = TP.from_numpy({k: np.asarray(v) for k, v in jq.items()}, TCFG,
                       "cpu")
    return jq, TM.prepare_params(tq, TCFG)


def test_int8_weights_forward_and_decode_match_jax(qparams):
    jq, tq = qparams
    assert "head" not in tq and tq["wte"].dtype == torch.int8
    toks = _toks((2, 12), 25)
    jl, jc = JG.forward_with_cache(jq, jnp.asarray(toks),
                                   JG.init_kv_cache(JCFG, 2, 24), 0, JCFG)
    tl, tc = TG.forward_with_cache(tq, torch.as_tensor(toks),
                                   TG.init_kv_cache(TCFG, 2, 24,
                                                    device="cpu"), 0, TCFG)
    _close(tl, jl)
    nxt = np.array([3, 5])
    pos = np.array([12, 12])
    jl, _ = JG.decode_step_multi(jq, jnp.asarray(nxt), jc, jnp.asarray(pos),
                                 JCFG)
    tl, _ = TG.decode_step_multi(tq, torch.as_tensor(nxt), tc,
                                 torch.as_tensor(pos), TCFG)
    _close(tl, jl)


def test_generate_int8_weights_matches_jax(qparams):
    jq, tq = qparams
    prompt = _toks((2, 9), 26)
    want = JG.generate(jq, jnp.asarray(prompt), JCFG, max_new=8,
                       key=jax.random.PRNGKey(0), temperature=0.0)
    got = TG.generate(tq, torch.as_tensor(prompt), TCFG, max_new=8,
                      temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# Beam search (JAX l.384-446), fp32
# --------------------------------------------------------------------------

@pytest.mark.parametrize("beams", [2, 4])
def test_generate_beam_matches_jax(params, beams):
    jp, tp = params
    prompt = _toks((2, 10), 27 + beams)
    want = JG.generate_beam(jp, jnp.asarray(prompt), JCFG, max_new=8,
                            beams=beams)
    got = TG.generate_beam(tp, torch.as_tensor(prompt), TCFG, max_new=8,
                           beams=beams)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_beam_one_beam_is_greedy(params):
    _, tp = params
    prompt = torch.as_tensor(_toks((3, 7), 31))
    np.testing.assert_array_equal(
        TG.generate_beam(tp, prompt, TCFG, max_new=9, beams=1).numpy(),
        TG.generate(tp, prompt, TCFG, max_new=9, temperature=0.0).numpy())


def test_top_orders_ties_as_jax():
    """Equal candidates come out lower index first, as jax.lax.top_k
    gives them (torch.topk promises no order for ties)."""
    x = np.array([[1.0, 3.0, 3.0, 0.5, 3.0, 2.0],
                  [2.0, 2.0, 2.0, 2.0, 1.0, 2.0]], np.float32)
    vals, idx = TG._top(torch.from_numpy(x), 4)
    jvals, jidx = jax.lax.top_k(jnp.asarray(x), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


# --------------------------------------------------------------------------
# The paged cache (JAX l.683-846)
# --------------------------------------------------------------------------

def _pools(seed, n_pages=7):
    rng = np.random.default_rng(seed)
    shape = (TCFG.num_layers, n_pages, TG.PAGE, TCFG.kv_dim)
    return [rng.standard_normal(shape).astype(np.float32) for _ in "kv"]


def _both_pools(arrs):
    return (tuple(jnp.asarray(a) for a in arrs),
            tuple(torch.from_numpy(a.copy()) for a in arrs))


def test_prefill_into_pages_matches_jax(params):
    jp, tp = params
    assert TG.PAGE == JG.PAGE
    jc, tc = _both_pools(_pools(32))
    prompts = _toks((2, 32), 33)
    pids = np.array([[5, 1], [2, 6]])
    jl, jc = JG.prefill_into_pages_multi(jp, jnp.asarray(prompts), jc,
                                         jnp.asarray(pids), JCFG)
    tl, tc = TG.prefill_into_pages_multi(tp, torch.as_tensor(prompts), tc,
                                         torch.as_tensor(pids), TCFG)
    _close(tl, jl)
    jl, jc = JG.prefill_into_pages(jp, jnp.asarray(prompts[0, :16]), jc,
                                   jnp.asarray([3]), JCFG)
    tl, tc = TG.prefill_into_pages(tp, torch.as_tensor(prompts[0, :16]), tc,
                                   torch.as_tensor([3]), TCFG)
    _close(tl, jl)
    _close(tc[0], jc[0])
    _close(tc[1], jc[1])


def test_decode_step_and_ticks_paged_match_jax(params):
    """Slots at different depths over shared pages, one retired onto the
    sink page 0; one step, then 4 greedy ticks."""
    jp, tp = params
    arrs = _pools(34)
    table = np.array([[1, 4, 0], [2, 3, 5], [0, 0, 0]])
    pos = np.array([20, 41, 0])
    toks = np.array([7, 11, 13])
    jc, tc = _both_pools(arrs)
    jl, jc = JG.decode_step_paged(jp, jnp.asarray(toks), jc,
                                  jnp.asarray(table), jnp.asarray(pos), JCFG)
    tl, tc2 = TG.decode_step_paged(tp, torch.as_tensor(toks), tc,
                                   torch.as_tensor(table),
                                   torch.as_tensor(pos), TCFG)
    assert tc2 is tc                            # written in place
    _close(tl, jl)
    _close(tc[0][:, 1:], jc[0][:, 1:])          # page 0 is the sink
    _close(tc[1][:, 1:], jc[1][:, 1:])
    jc, tc = _both_pools(arrs)
    live = np.array([20, 40, 0])
    jt, _, jpos = JG.decode_ticks_paged(
        jp, jnp.asarray(toks), jc, jnp.asarray(table), jnp.asarray(live),
        jax.random.split(jax.random.PRNGKey(0), 4), jnp.zeros(3), JCFG, 0)
    tt, _, tpos = TG.decode_ticks_paged(
        tp, torch.as_tensor(toks), tc, torch.as_tensor(table),
        torch.as_tensor(live), 4, torch.zeros(3), TCFG, 0)
    np.testing.assert_array_equal(tt.numpy()[:, :2], np.asarray(jt)[:, :2])
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
