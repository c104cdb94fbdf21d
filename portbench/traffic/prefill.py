"""Open-loop prefill cells: requests arrive on a Poisson schedule at a
fixed rate and are served by `serving_gen.GenerationEngine` (dense slot
cache, prompt buckets, same-bucket prompts prefilled together), greedy,
one new token each: the first token is the whole answer.

The schedule is drawn so that every seed serves the same set of prompt
lengths and the same set of gaps between arrivals, in another order: the
lengths are the lognormal's quantiles at (i + 1/2) / N (median, sigma,
clipped to [min_prompt, max_prompt]) and the gaps the exponential's, N =
rate x seconds; the seed permutes both and draws the token ids.  A
request's time to first token runs from when it was due to the end of
the engine step that returned its token; the p95 is over every request
due in the window, a request not served within `drain_s` of the window's
end counting as missing.

Set-up makes the weights, builds the engine and runs every bucket at every
power-of-two group size up to the slot count, with its decode tick.
After the window, `reference/model` runs each prompt of a sample drawn
from the seed (the longest prompt in it) and of the last request each slot
held: the served token's gap below the reference's best logit, and each
layer's K and V as the engine's cache holds them at every prompt position.

params: rate, slots, max_len, buckets, median_prompt, sigma, min_prompt,
max_prompt, check_requests, drain_s.
"""

from __future__ import annotations

import math
import statistics
import time

import numpy as np
import torch

from .. import weights as W
from ..reference import compare
from ..reference.model import Ref, fp32_exact, gpt_served, to_device
from . import common as CM


def program_engine(cfg, weights, p: dict, seed: int):
    from vitrs_tpu_torch.serving_gen import GenerationEngine
    return GenerationEngine(weights, cfg, max_slots=p["slots"],
                            max_len=p["max_len"], seed=seed,
                            prompt_buckets=tuple(p["buckets"]))


def schedule(p: dict, seconds: float, seed: int, vocab: int):
    """(due times (N,), prompt lengths (N,), prompts [N arrays])."""
    n = max(1, int(round(p["rate"] * seconds)))
    q = (np.arange(n) + 0.5) / n
    inv = statistics.NormalDist().inv_cdf
    lens = np.array([math.exp(math.log(p["median_prompt"])
                              + p["sigma"] * inv(x)) for x in q])
    lens = np.clip(np.rint(lens), p["min_prompt"], p["max_prompt"])
    gaps = -np.log1p(-q) / p["rate"]
    rng = np.random.default_rng([int(seed), 0x9F11])
    lens = rng.permutation(lens).astype(np.int64)
    due = np.cumsum(rng.permutation(gaps))
    ids = rng.integers(0, vocab, size=int(lens.sum()), dtype=np.int64)
    prompts = np.split(ids, np.cumsum(lens)[:-1])
    return due, lens, prompts


def p95(values) -> float:
    """The nearest-rank 95th percentile."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def _warm(eng, p: dict, rng, vocab: int):
    K = 1
    while K <= p["slots"]:
        for b in p["buckets"]:
            n = min(b, p["max_prompt"])
            for _ in range(K):
                eng.submit(rng.integers(0, vocab, size=n), max_new=1,
                           temperature=0.0)
            while eng.pending or eng.active:
                eng.step()
        K *= 2
    eng.finished.clear()


def serve(eng, due, prompts, seconds: float, drain_s: float, tr) -> dict:
    """Offer the requests at their due times (seconds from the start),
    step the engine while it has work, and wait for what is due in
    `seconds` until `drain_s` past it.  Returns each request's completion
    time (NaN if never), how late it was submitted, its served token, the
    last request of each slot, the backlog (due but unserved) when the
    window closed and the window's length."""
    N = len(due)
    done_t = np.full(N, np.nan)
    late = np.zeros(N)
    served = np.full(N, -1, np.int64)
    slot_last, rid_of = {}, {}
    backlog_end = None
    i = 0
    with tr.window():
        t0 = CM.now()
        while True:
            t = CM.now() - t0
            if backlog_end is None and t >= seconds:
                backlog_end = int(np.sum(due <= seconds)
                                  - np.sum(done_t <= seconds))
            if (i >= N and not (eng.pending or eng.active)) or \
                    t > seconds + drain_s:
                break
            with tr.span("submit"):
                while i < N and due[i] <= t:
                    rid_of[eng.submit(prompts[i], max_new=1,
                                      temperature=0.0)] = i
                    late[i] = CM.now() - t0 - due[i]
                    i += 1
            if eng.pending or eng.active:
                with tr.span("engine.step"):
                    fin = eng.step()
                tc = CM.now() - t0
                for r in fin:
                    j = rid_of[r.rid]
                    done_t[j] = tc
                    served[j] = r.out[0]
                    slot_last[r.slot] = j
            elif i < N:
                with tr.span("sample_due"):
                    time.sleep(max(0.0, due[i] - (CM.now() - t0)))
        CM.sync(eng.device)
        window_s = CM.now() - t0
    return {"done_t": done_t, "late": late, "served": served,
            "slot_last": slot_last, "window_s": window_s,
            "backlog_end": 0 if backlog_end is None else backlog_end}


def run(ctx) -> CM.Outcome:
    s, cfg, p, dev = ctx.shape, ctx.cfg, ctx.params, ctx.device
    V = s.vocab_size
    ctx.mark("start")
    w = W.make_weights(s, ctx.seed, dev)
    w_host = {k: t.to("cpu", copy=True) for k, t in w.items()}
    due, lens, prompts = schedule(p, ctx.seconds, ctx.seed, V)
    N = len(due)
    eng = program_engine(cfg, w, p, ctx.seed)
    ctx.mark("engine_built")
    _warm(eng, p, np.random.default_rng([int(ctx.seed), 0x3A3A]), V)
    passes0 = eng.prefill_dispatches
    CM.sync(dev)
    setup_s = CM.now() - ctx.t_start

    r = serve(eng, due, prompts, ctx.seconds, p["drain_s"], ctx.tracer)
    done_t, late, served, slot_last = (r["done_t"], r["late"], r["served"],
                                       r["slot_last"])
    window_s, backlog_end = r["window_s"], r["backlog_end"]
    passes = eng.prefill_dispatches - passes0
    finished = np.flatnonzero(~np.isnan(done_t))
    ttft_ms = np.where(np.isnan(done_t), window_s - due, done_t - due) * 1e3
    peak = CM.peak_bytes(dev)

    rng = np.random.default_rng([int(ctx.seed), 0xC4EC])
    longest = [int(finished[np.argmax(lens[finished])])] if len(finished) \
        else []
    sample = CM.sample(rng, [int(j) for j in finished], p["check_requests"],
                       always=longest)
    kc, vc = eng.caches
    del eng, w
    CM.free(dev)

    fp32_exact()
    ref = Ref(s, "fp32")
    refw = to_device(w_host, dev)
    gaps, n_off, n_all = [], 0, 0
    cache_of = {j: slot for slot, j in slot_last.items()}
    t_ref = CM.now()
    for j in sorted(set(sample) | set(cache_of)):
        prompt = torch.as_tensor(prompts[j], device=dev)
        logits, kv = gpt_served(ref, refw, prompt)
        if j in sample:
            gaps.append(compare.token_gap(logits, int(served[j])))
        if j in cache_of:
            slot, T0 = cache_of[j], int(lens[j])
            for layer, (k, v) in enumerate(kv):
                for got, want in ((kc[layer, slot, :T0], k),
                                  (vc[layer, slot, :T0], v)):
                    bad = compare.off(got, want)
                    n_off += int(bad.sum())
                    n_all += bad.numel()
    done_lens = [int(lens[j]) for j in finished]
    return CM.Outcome(
        e2e={"ttft_p95_ms": p95(ttft_ms)}, setup_s=setup_s, attempted=N,
        failed=N - len(finished),
        numbers={"token_gap": max(gaps) if gaps else float("nan"),
                 "kv_over": 100.0 * n_off / n_all if n_all
                 else float("nan")},
        work={"prompt_lens": done_lens},
        counters={"prompt_tokens": int(sum(done_lens)),
                  "prefill_passes": int(passes)},
        memory_peak_bytes=peak,
        notes={"window_s": window_s, "requests": N,
               "served": len(finished), "ttft_p50_ms": float(
                   np.median(ttft_ms)),
               "ttft_samples_beyond_p95": int(N - math.ceil(0.95 * N)),
               "generator_late_ms_max": float(late.max() * 1e3),
               "generator_late_ms_p95": p95(late * 1e3),
               "backlog_at_end": backlog_end, "prefill_passes": passes,
               "checked_requests": len(sample),
               "checked_caches": len(cache_of),
               "reference_s": CM.now() - t_ref})
