"""PyTorch port: serving_gen.py against the JAX engine, fp32, at L=2, NH=2,
C=128 (prefill attention on the flash path), vocab 97.

Greedy token streams must be equal.  The JAX engine compiles its programs
per engine, so each JAX scenario runs once per module (fixture) and the
port's engine is held against it in per-tick and chunked decode."""

import numpy as np
import pytest
import torch

from vitrs_tpu.data.tokenizer import ByteBPETokenizer as JaxTokenizer
from vitrs_tpu.serving_gen import GenerationEngine as JaxEngine
from vitrs_tpu.serving_gen import TextEngine as JaxTextEngine
from vitrs_tpu_torch.data.tokenizer import ByteBPETokenizer
from vitrs_tpu_torch.serving_gen import GenerationEngine, TextEngine

from test_torch_helpers import both_params, small_cfgs

JCFG, TCFG = small_cfgs()
V = TCFG.vocab_size


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, n) for n in lengths]


# name -> (engine kwargs, prompts, max_new per request)
SCENARIOS = {
    # mixed lengths in one batch, two buckets (one flash prefill each)
    "mixed": (dict(max_slots=4, max_len=48, prompt_buckets=(16, 32)),
              _prompts(0, (5, 9, 30, 17)), (6, 4, 9, 5)),
    # more requests than slots: admission as slots retire
    "admission": (dict(max_slots=2, max_len=32, prompt_buckets=(8,)),
                  _prompts(1, (4, 7, 5, 8, 3)), (3, 5, 2, 4, 6)),
    # the paged cache (JAX tests/test_serving_gen.py:84-117): a pool for
    # about two requests, so that a second wave recycles the first's pages
    "paged-recycle": (dict(max_slots=2, max_len=32, prompt_buckets=(16,),
                           paged=True, n_pages=5),
                      _prompts(6, (5, 9, 4, 7)), (4, 4, 4, 4)),
    # a pool smaller than the slots: admission waits for pages
    "paged-small-pool": (dict(max_slots=4, max_len=32, prompt_buckets=(16,),
                              paged=True, n_pages=4),
                         _prompts(7, (6, 6, 6, 6)), (3, 3, 3, 3)),
    # two buckets, slots growing across pages while they decode
    "paged-grow": (dict(max_slots=3, max_len=48, prompt_buckets=(16, 32),
                        paged=True, n_pages=9),
                   _prompts(8, (5, 20, 9, 30, 3)), (12, 6, 9, 4, 14)),
}
PAGED = sorted(n for n in SCENARIOS if n.startswith("paged"))


def _run(engine):
    return dict(engine.run())


@pytest.fixture(scope="module")
def params():
    return both_params(JCFG, TCFG, seed=3)


def _eos_id(streams):
    """A token the "mixed" requests emit: request 0's third new token."""
    return int(streams["mixed"][0][len(SCENARIOS["mixed"][1][0]) + 2])


def _submit_all(eng, name, eos_id=None):
    _, prompts, news = SCENARIOS[name]
    for p, n in zip(prompts, news):
        eng.submit(p, max_new=n, eos_id=eos_id)


@pytest.fixture(scope="module")
def jax_streams(params):
    """JAX engine output per scenario, plus "eos": the "mixed" requests
    again with an eos id that some of them emit."""
    jp, _ = params
    out = {}
    for name, (kw, _, _) in SCENARIOS.items():
        eng = JaxEngine(jp, JCFG, **kw)
        _submit_all(eng, name)
        out[name] = _run(eng)
    eng = JaxEngine(jp, JCFG, **SCENARIOS["mixed"][0])
    _submit_all(eng, "mixed", eos_id=_eos_id(out))
    out["eos"] = _run(eng)
    return out


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("name", sorted(SCENARIOS) + ["eos"])
def test_greedy_streams_equal_jax_engine(params, jax_streams, name, chunk):
    _, tp = params
    scenario = "mixed" if name == "eos" else name
    kw = SCENARIOS[scenario][0]
    eng = GenerationEngine(tp, TCFG, decode_chunk=chunk, **kw)
    _submit_all(eng, scenario,
                eos_id=_eos_id(jax_streams) if name == "eos" else None)
    got = _run(eng)
    assert sorted(got) == sorted(jax_streams[name])
    for rid, toks in jax_streams[name].items():
        np.testing.assert_array_equal(got[rid], toks, err_msg=f"request {rid}")
    assert eng.prefill_dispatches >= 1
    assert sorted(eng.free) == list(range(kw["max_slots"]))
    if kw.get("paged"):     # every page but the sink came back
        assert sorted(eng.free_pages) == list(range(1, kw["n_pages"]))
    if name == "eos":       # some request stopped early at the eos id
        full = [len(p) + n for p, n in zip(*SCENARIOS["mixed"][1:])]
        assert any(len(got[r]) < full[r] for r in got)


@pytest.mark.parametrize("name", PAGED)
def test_paged_streams_equal_dense_engine(params, jax_streams, name):
    """The paged engine's streams are the dense engine's on the same
    requests (the JAX package's own check, test_serving_gen.py:84-117)."""
    _, tp = params
    kw = {k: v for k, v in SCENARIOS[name][0].items()
          if k not in ("paged", "n_pages")}
    eng = GenerationEngine(tp, TCFG, decode_chunk=4, **kw)
    _submit_all(eng, name)
    got = _run(eng)
    for rid, toks in jax_streams[name].items():
        np.testing.assert_array_equal(got[rid], toks, err_msg=f"request {rid}")


@pytest.mark.parametrize("paged", [False, True])
def test_int8_weight_engine_equals_jax(params, paged):
    """Weight-only int8 params (the JAX package's quantize_params) through
    both engines, dense and paged, chunked: the JAX engine's streams."""
    from vitrs_tpu.ops import quant as JQT
    from vitrs_tpu_torch import params as TP
    jp, _ = params
    jq = JQT.quantize_params(jp, mode="gpt")
    tq = TP.from_numpy({k: np.asarray(v) for k, v in jq.items()}, TCFG,
                       "cpu")
    kw = dict(max_slots=2, max_len=32, prompt_buckets=(16,), paged=paged)
    jeng = JaxEngine(jq, JCFG, **kw)
    eng = GenerationEngine(tq, TCFG, decode_chunk=3, **kw)
    for e in (jeng, eng):
        for p in _prompts(9, (6, 11, 3)):
            e.submit(p, max_new=5)
    want, got = _run(jeng), _run(eng)
    assert "head" not in eng.params and eng.params["wte"].dtype == torch.int8
    for rid, toks in want.items():
        np.testing.assert_array_equal(got[rid], toks, err_msg=f"request {rid}")


def test_eos_stops_and_frees_slot(params, jax_streams):
    _, tp = params
    kw, prompts, news = SCENARIOS["mixed"]
    first = int(jax_streams["mixed"][0][len(prompts[0])])   # greedy token 1
    for chunk in (1, 4):
        eng = GenerationEngine(tp, TCFG, decode_chunk=chunk, **kw)
        eng.submit(prompts[0], max_new=10, eos_id=first)
        out = _run(eng)
        assert len(out[0]) == len(prompts[0]) + 1
        assert sorted(eng.free) == list(range(kw["max_slots"]))


def test_chunked_equals_per_tick_with_mid_chunk_retirement(params):
    _, tp = params
    prompts = _prompts(4, (5, 9, 4, 12))
    news = (6, 3, 7, 2)
    outs = []
    for chunk in (1, 3, 5):
        eng = GenerationEngine(tp, TCFG, max_slots=2, max_len=32,
                               prompt_buckets=(16,), decode_chunk=chunk)
        for p, n in zip(prompts, news):
            eng.submit(p, max_new=n)
        outs.append(_run(eng))
    for o in outs[1:]:
        for rid in outs[0]:
            np.testing.assert_array_equal(o[rid], outs[0][rid])


@pytest.mark.parametrize("chunk", [1, 3])
def test_sampled_smoke(params, chunk):
    _, tp = params
    eng = GenerationEngine(tp, TCFG, max_slots=2, max_len=32,
                           prompt_buckets=(8,), decode_chunk=chunk, top_k=5,
                           seed=1)
    for p in _prompts(5, (6, 3)):
        eng.submit(p, max_new=5, temperature=0.9, top_k=5)
    out = _run(eng)
    assert [len(out[0]), len(out[1])] == [11, 8]
    assert all(((o >= 0) & (o < V)).all() for o in out.values())


def test_text_engine_equals_jax(params):
    corpus = "the quick brown fox jumps over the lazy dog " * 20
    tok = ByteBPETokenizer.train(corpus, vocab_size=280)
    jtok = JaxTokenizer.train(corpus, vocab_size=280)
    jcfg, tcfg = small_cfgs(vocab_size=tok.vocab_size)
    jp, tp = both_params(jcfg, tcfg, seed=6)
    kw = dict(max_slots=2, max_len=32, prompt_buckets=(16,))
    prompts = ["the quick", "lazy dog"]
    want = JaxTextEngine(jp, jcfg, jtok, **kw).generate(prompts, max_new=5)
    got = TextEngine(tp, tcfg, tok, **kw).generate(prompts, max_new=5)
    assert got == want
    echo = TextEngine(tp, tcfg, tok, **kw).generate(["the quick"], max_new=3,
                                                    echo_prompt=True)
    assert echo[0].startswith("the quick")


@pytest.mark.parametrize("text", [
    "the quick brown fox jumps over the lazy dog " * 10,
    "snake_case_names and CamelCase, 123 456 — ünïcödé!\n\tend<|endoftext|>",
])
def test_tokenizer_ids_equal_jax_after_train(text, tmp_path):
    tok = ByteBPETokenizer.train(text, vocab_size=300)
    jtok = JaxTokenizer.train(text, vocab_size=300)
    assert tok.merges == jtok.merges
    assert tok.encode(text) == jtok.encode(text)
    assert tok.decode(tok.encode(text)) == text
    path = str(tmp_path / "tok.json")
    tok.save(path)
    assert JaxTokenizer.load(path).encode(text) == tok.encode(text)


def test_engine_refuses_what_it_does_not_run(params):
    """The paged engine runs now (held against JAX above); it refuses a
    geometry off the page size and a pool too small for a bucket."""
    _, tp = params
    with pytest.raises(ValueError, match="multiples"):
        GenerationEngine(tp, TCFG, max_slots=2, max_len=40, paged=True,
                         prompt_buckets=(16,))
    with pytest.raises(ValueError, match="multiples"):
        GenerationEngine(tp, TCFG, max_slots=2, max_len=32, paged=True,
                         prompt_buckets=(8,))
    with pytest.raises(ValueError, match="cannot hold"):
        GenerationEngine(tp, TCFG, max_slots=2, max_len=32, paged=True,
                         prompt_buckets=(32,), n_pages=2)
    eng = GenerationEngine(tp, TCFG, max_slots=2, max_len=32, paged=True,
                           prompt_buckets=(16,))
    assert len(eng.free_pages) == 2 * 2 and eng.caches[0].shape[1] == 5
    eng = GenerationEngine(tp, TCFG, max_slots=2, max_len=32,
                           prompt_buckets=(8,))
    with pytest.raises(ValueError, match="empty"):
        eng.submit([], max_new=2)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(np.zeros(8, int), max_new=30)
    with pytest.raises(ValueError, match="buckets"):
        eng.submit(np.zeros(9, int), max_new=2)


def test_engine_keeps_its_own_compute_copy(params):
    """Weights cast once at construction: bf16 matmul weights, fp32 LN."""
    _, tp = params
    cfg = TCFG.replace(dtype="bfloat16")
    eng = GenerationEngine(tp, cfg, max_slots=2, max_len=32,
                           prompt_buckets=(16,))
    assert eng.params["qkvw"].dtype == torch.bfloat16
    assert eng.params["head"].dtype == torch.bfloat16
    assert eng.params["ln1w"].dtype == torch.float32
    assert tp["qkvw"].dtype == torch.float32          # caller's dict untouched
    eng.submit(_prompts(7, (10,))[0], max_new=4)
    out = _run(eng)
    assert len(out[0]) == 14 and eng.caches[0].dtype == torch.bfloat16
