"""Continuous-batching generation engine — the port of
`vitrs_tpu/serving_gen.py`, with the dense slot cache and the paged one.

A fixed pool of decode slots shares one KV cache (L, slots, max_len,
kv_dim) on the device.  Requests are admitted into free slots as others
retire; prompts are right-padded to a bucket and same-bucket prompts
prefill together in one pass (`generate.prefill_into_slots`, whose
attention is the flash kernel: K1-fwd, or K3-fwd under GQA);
every tick then decodes one token for all slots (`decode_step_multi`), or
`decode_chunk` ticks at once with sampling on the device.  Inactive slots
decode garbage that the host discards.  A rope and sliding-window config
serves the same way: prefill rotates q and k at absolute positions and
runs the kernels with the band, and decode rotates at each slot's own
position and masks to its window.

`paged=True` replaces the slot cache by a pool of `n_pages` pages of
`generate.PAGE` tokens shared by all slots, with a host page table per
slot: memory follows the live tokens instead of max_slots x max_len.
Page 0 is a reserved write sink (a retired slot's decode writes land
there); admission waits until the head request's bucket has pages, and a
slot grows by a page when its next write crosses its allocation (before
a chunk of decode ticks, for every tick of the chunk).  Page groups
prefill through `generate.prefill_into_pages_multi` (K1-fwd / K3-fwd).

int8 weights (`ops/quant.quantize_params(params, "gpt")`) serve as they
are: every decode path reads the `_scale` leaves.

Differences from the JAX engine: there is no jit, so nothing compiles per
bucket; the cache is updated in place where JAX donated it; the weights are
cast to the compute dtype once, here; sampling draws from torch.Generators
seeded with `seed`; a pool too small for the largest bucket raises
ValueError (the JAX engine would wait for pages forever).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from .config import ViTConfig
from .models import generate as G
from .models import model as M
from .utils import trace


@dataclass
class _Request:
    rid: int
    prompt: np.ndarray                 # (T0,) int
    max_new: int
    temperature: float
    top_k: int
    top_p: float
    eos_id: Optional[int]
    out: List[int] = field(default_factory=list)
    slot: int = -1


class GenerationEngine:
    """Slot-pool continuous batching over one shared KV cache.

    >>> eng = GenerationEngine(params, cfg, max_slots=8, max_len=256)
    >>> eng.submit(prompt_tokens, max_new=64)
    >>> finished = eng.run()            # list of (rid, np.ndarray tokens)

    params: the canonical tensor dict (or its int8 form), on the device to
    serve from; the engine keeps its own copy with the float matmul weights
    in cfg.dtype.  `prefill_dispatches` counts prefill passes and
    `decode_ticks` decode passes (one token a slot).  paged:
    n_pages <= 0 sizes the pool to the dense equivalent, max_slots x
    max_len / PAGE pages + the sink.

    While a torch.profiler session records, the engine marks its phases
    (`utils/trace.py`): `gen.submit` (the request id), `gen.admit`,
    `gen.prefill` (prompt and computed tokens), `gen.decode` (the tick's
    launch) and `gen.sample` (the host read and sampling; the ids given
    their first token)."""

    def __init__(self, params: Mapping[str, torch.Tensor], cfg: ViTConfig,
                 max_slots: int, max_len: int, seed: int = 0,
                 prompt_buckets: tuple = (32, 64, 128),
                 paged: bool = False, n_pages: int = 0,
                 decode_chunk: int = 1, top_k: int = 0, top_p: float = 0.0):
        if max_len > cfg.max_seq_len:
            raise ValueError(f"max_len {max_len} > max_seq_len "
                             f"{cfg.max_seq_len}")
        self.device = params["wte"].device
        self.params = M.prepare_params(params, cfg)
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_len = max_len
        self.buckets = (tuple(sorted(b for b in prompt_buckets
                                     if b <= max_len))
                        or (max_len,))   # tiny configs: one bucket
        self.free: List[int] = list(range(max_slots))
        self.active: Dict[int, _Request] = {}      # slot -> request
        self.pending: List[_Request] = []
        self.finished: List[_Request] = []
        self._next_rid = 0
        # host sampling (per-tick mode) and device sampling (chunked mode)
        self._host_gen = torch.Generator().manual_seed(seed)
        self._dev_gen = torch.Generator(device=self.device).manual_seed(seed)
        # host mirrors of per-slot state fed to the decode step
        self._tokens = np.zeros(max_slots, np.int64)
        self._pos = np.zeros(max_slots, np.int64)
        # chunked decode: per-slot temperature, but ONE engine-wide top_k /
        # top_p; per-request values are honoured only by decode_chunk=1
        self.decode_chunk = decode_chunk
        self.top_k = top_k
        self.top_p = top_p
        self.paged = paged
        if paged:
            if max_len % G.PAGE or any(b % G.PAGE for b in self.buckets):
                raise ValueError(f"paged: max_len and the prompt buckets "
                                 f"must be multiples of {G.PAGE}")
            self.max_pp = max_len // G.PAGE
            if n_pages <= 0:
                n_pages = max_slots * self.max_pp + 1
            if n_pages - 1 < max(self.buckets) // G.PAGE:
                raise ValueError(f"paged: {n_pages} pages (one the sink) "
                                 f"cannot hold a {max(self.buckets)}-token "
                                 f"prompt")
            self.caches = G.init_paged_kv(cfg, n_pages, device=self.device)
            self.free_pages: List[int] = list(range(1, n_pages))
            # host page table and each slot's allocated-token high-water mark
            self._table = np.zeros((max_slots, self.max_pp), np.int64)
            self._alloc = np.zeros(max_slots, np.int64)
        else:
            self.caches = G.init_kv_cache(cfg, max_slots, max_len,
                                          device=self.device)
        self.prefill_dispatches = 0
        self.decode_ticks = 0

    # ------------------------------------------------------------- intake

    def submit(self, prompt, max_new: int, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 0.0,
               eos_id: Optional[int] = None) -> int:
        if self.decode_chunk > 1 and (top_k != self.top_k
                                      or top_p != self.top_p):
            warnings.warn(
                f"per-request top_k={top_k}/top_p={top_p} is ignored in "
                f"chunked mode (decode_chunk={self.decode_chunk} uses the "
                f"engine-wide top_k={self.top_k}/top_p={self.top_p}); pass "
                "them to the engine constructor or use decode_chunk=1",
                stacklevel=2)
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("empty prompt (use a BOS/<|endoftext|> id)")
        if len(prompt) + max_new > self.max_len:
            raise ValueError("request exceeds max_len")
        if len(prompt) > max(self.buckets):
            raise ValueError("prompt exceeds buckets")
        rid = self._next_rid
        self._next_rid += 1
        self.pending.append(_Request(rid, prompt, max_new, temperature,
                                     top_k, top_p, eos_id))
        trace.event("gen.submit", rid=rid)
        return rid

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(n)

    def _release_pages(self, slot: int):
        n = int(self._alloc[slot]) // G.PAGE
        self.free_pages.extend(int(p) for p in self._table[slot, :n])
        self._table[slot] = 0              # retired writes land in page 0
        self._pos[slot] = 0
        self._alloc[slot] = 0

    def _grow(self, slot: int, upto: int):
        """Give `slot` pages until its allocation covers `upto` tokens."""
        while self._alloc[slot] < upto:
            if not self.free_pages:
                raise RuntimeError("page pool exhausted; size n_pages for "
                                   "the expected live-token total")
            self._table[slot, int(self._alloc[slot]) // G.PAGE] = \
                self.free_pages.pop()
            self._alloc[slot] += G.PAGE

    def _retire(self, slot: int):
        del self.active[slot]
        self.free.append(slot)
        if self.paged:
            self._release_pages(slot)

    def _admit(self):
        """Admit pending requests, coalescing same-bucket prompts into one
        prefill pass (group size padded to a power of two, as in the JAX
        engine, where it bounds the set of compiled programs).  Paged: the
        head request waits until its bucket's pages are free, and a group
        takes no more requests than the free pages hold."""
        while self.pending and self.free:
            head_bucket = self._bucket(len(self.pending[0].prompt))
            n_pg = head_bucket // G.PAGE
            limit = len(self.free)
            if self.paged:
                if len(self.free_pages) < n_pg:
                    return                         # wait for pages to free
                limit = min(limit, len(self.free_pages) // n_pg)
            group, rest = [], []
            for req in self.pending:
                if (len(group) < limit
                        and self._bucket(len(req.prompt)) == head_bucket):
                    group.append(req)
                else:
                    rest.append(req)
            self.pending = rest

            K = len(group)
            K_pad = 1 << (K - 1).bit_length()
            prompts = np.zeros((K_pad, head_bucket), np.int64)
            slots = np.zeros(K_pad, np.int64)
            pids = np.zeros((K_pad, n_pg), np.int64)
            for j, req in enumerate(group):
                T0 = len(req.prompt)
                slot = self.free.pop()
                req.slot = slot
                # pad tokens write cache rows >= T0, which decode's causal
                # mask (t <= pos) never reads before overwriting them
                prompts[j, :T0] = req.prompt
                slots[j] = slot
                if self.paged:
                    self._grow(slot, head_bucket)
                    pids[j] = self._table[slot, :n_pg]
                # seed decode with the last prompt token at pos T0-1: the
                # first decode tick produces the first new token
                self._tokens[slot] = req.prompt[-1]
                self._pos[slot] = T0 - 1
                self.active[slot] = req
            # group padding duplicates the last row: identical content
            prompts[K:] = prompts[K - 1]
            slots[K:] = slots[K - 1]
            pids[K:] = pids[K - 1]
            tokens = (dict(real_tokens=sum(len(r.prompt) for r in group),
                           computed_tokens=K_pad * head_bucket)
                      if trace.recording() else {})
            with trace.span("gen.prefill", **tokens):
                if self.paged:
                    G.prefill_into_pages_multi(
                        self.params, self._dev(prompts), self.caches,
                        self._dev(pids), self.cfg)
                else:
                    G.prefill_into_slots(self.params, self._dev(prompts),
                                         self.caches, self._dev(slots),
                                         self.cfg)
            self.prefill_dispatches += 1

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # ------------------------------------------------------------- decode

    def _sample_host(self, req: _Request, logits: np.ndarray) -> int:
        if req.temperature == 0.0:
            return int(np.argmax(logits))
        lg = G._filter_logits(torch.from_numpy(logits)[None] / req.temperature,
                              req.top_k, req.top_p)
        return int(G._categorical(lg, self._host_gen)[0])

    def _firsts(self) -> dict:
        """`gen.sample`'s record while a profiler records: the ids of the
        active requests that the tick gives their first token."""
        if not trace.recording():
            return {}
        return {"first": [r.rid for r in self.active.values() if not r.out]}

    def step(self) -> List[_Request]:
        """One decode tick for every active slot; returns newly finished."""
        with trace.span("gen.admit"):
            self._admit()
        if not self.active:
            return []
        with trace.span("gen.decode"):
            if self.paged:
                # a slot whose next write crosses its allocation gets a page
                for slot in self.active:
                    self._grow(slot, int(self._pos[slot]) + 1)
                logits, self.caches = G.decode_step_paged(
                    self.params, self._dev(self._tokens), self.caches,
                    self._dev(self._table), self._dev(self._pos), self.cfg)
            else:
                logits, self.caches = G.decode_step_multi(
                    self.params, self._dev(self._tokens), self.caches,
                    self._dev(self._pos), self.cfg)
            self.decode_ticks += 1
        done: List[_Request] = []
        with trace.span("gen.sample", **self._firsts()):
            logits = logits.cpu().numpy()
            for slot, req in list(self.active.items()):
                nxt = self._sample_host(req, logits[slot])
                req.out.append(nxt)
                self._tokens[slot] = nxt
                self._pos[slot] += 1
                hit_eos = req.eos_id is not None and nxt == req.eos_id
                if len(req.out) >= req.max_new or hit_eos:
                    done.append(req)
                    self._retire(slot)
        self.finished.extend(done)
        return done

    def step_chunk(self) -> List[_Request]:
        """Chunked tick: n tokens for every active slot per host read.
        Slots that finish mid-chunk decode on to the chunk's end and the
        host discards those tokens.  Paged: every page the chunk writes is
        allocated first; where the pool is short of them, one tick runs
        instead (`step`)."""
        with trace.span("gen.admit"):
            self._admit()
        if not self.active:
            return []
        room = min(self.max_len - int(self._pos[s]) for s in self.active)
        n = max(1, min(self.decode_chunk, room))
        if self.paged:
            need = sum(max(0, -(-(int(self._pos[s]) + n) // G.PAGE)
                           - int(self._alloc[s]) // G.PAGE)
                       for s in self.active)
            if need > len(self.free_pages):
                return self.step()
            for slot in self.active:
                self._grow(slot, int(self._pos[slot]) + n)
        temps = np.zeros(self.max_slots, np.float32)
        for slot, req in self.active.items():
            temps[slot] = req.temperature
        with trace.span("gen.decode"):
            args = (self.params, self._dev(self._tokens), self.caches)
            if self.paged:
                toks, self.caches, _ = G.decode_ticks_paged(
                    *args, self._dev(self._table), self._dev(self._pos), n,
                    self._dev(temps), self.cfg, self.top_k, self.top_p,
                    self._dev_gen)
            else:
                toks, self.caches, _ = G.decode_ticks_multi(
                    *args, self._dev(self._pos), n, self._dev(temps),
                    self.cfg, self.top_k, self.top_p, self._dev_gen)
            self.decode_ticks += n
        done: List[_Request] = []
        with trace.span("gen.sample", **self._firsts()):
            toks = toks.cpu().numpy()              # (n, B): one host read
            live = dict(self.active)
            for t in range(n):
                for slot, req in list(live.items()):
                    nxt = int(toks[t, slot])
                    req.out.append(nxt)
                    hit_eos = req.eos_id is not None and nxt == req.eos_id
                    if len(req.out) >= req.max_new or hit_eos:
                        done.append(req)
                        del live[slot]
                        self._retire(slot)
            for slot in live:
                self._tokens[slot] = int(toks[n - 1, slot])
                self._pos[slot] += n
        self.finished.extend(done)
        return done

    def run(self) -> List[tuple]:
        """Drive until every submitted request finishes; returns
        (rid, prompt + generated tokens) pairs in submission order."""
        while self.pending or self.active:
            self.step_chunk() if self.decode_chunk > 1 else self.step()
        out = [(r.rid, np.concatenate([r.prompt, np.asarray(r.out,
                                                            np.int64)]))
               for r in sorted(self.finished, key=lambda r: r.rid)]
        self.finished.clear()
        return out


class TextEngine:
    """Text in, text out over GenerationEngine: a ByteBPETokenizer encodes
    prompts, eos defaults to its <|endoftext|> id, and completions decode
    back to strings (trimmed at eos).

    >>> te = TextEngine(params, cfg, tokenizer, max_slots=8, max_len=256)
    >>> te.generate(["Once upon a time"], max_new=32)[0]
    """

    def __init__(self, params: Mapping[str, torch.Tensor], cfg: ViTConfig,
                 tokenizer, **engine_kw):
        if tokenizer.vocab_size > cfg.vocab_size:
            raise ValueError(f"tokenizer vocab {tokenizer.vocab_size} > "
                             f"model vocab {cfg.vocab_size}")
        self.tokenizer = tokenizer
        self.engine = GenerationEngine(params, cfg, **engine_kw)
        self.eos_id = tokenizer.eot_id

    def generate(self, prompts: List[str], max_new: int = 64,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, echo_prompt: bool = False) -> List[str]:
        """Continuously batched generation for string prompts; returns the
        completions in submission order."""
        reqs = []
        for text in prompts:
            ids = self.tokenizer.encode(text)
            if not ids:                       # "" -> generate from BOS
                if self.eos_id is None:
                    raise ValueError("empty prompt needs an eot id")
                ids = [self.eos_id]
            rid = self.engine.submit(np.asarray(ids, np.int64), max_new,
                                     temperature=temperature, top_k=top_k,
                                     top_p=top_p, eos_id=self.eos_id)
            reqs.append((rid, text, len(ids)))
        finished = dict(self.engine.run())
        outs = []
        for rid, text, n_prompt in reqs:
            gen = [int(t) for t in finished[rid][n_prompt:]]
            if self.eos_id is not None and self.eos_id in gen:
                gen = gen[:gen.index(self.eos_id)]
            completion = self.tokenizer.decode(gen)
            outs.append(text + completion if echo_prompt else completion)
        return outs
