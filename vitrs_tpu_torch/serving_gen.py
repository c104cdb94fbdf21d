"""Continuous-batching generation engine — the port of
`vitrs_tpu/serving_gen.py` (dense slot cache).

A fixed pool of decode slots shares one KV cache (L, slots, max_len, C) on
the device.  Requests are admitted into free slots as others retire; prompts
are right-padded to a bucket and same-bucket prompts prefill together in one
pass (`generate.prefill_into_slots`, whose attention is the flash kernel);
every tick then decodes one token for all slots (`decode_step_multi`), or
`decode_chunk` ticks at once with sampling on the device.  Inactive slots
decode garbage that the host discards.

Differences from the JAX engine: there is no jit, so nothing compiles per
bucket; the cache is updated in place where JAX donated it; the weights are
cast to the compute dtype once, here; sampling draws from torch.Generators
seeded with `seed`.  The paged cache is not ported yet.
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

    params: the canonical tensor dict, on the device to serve from; the
    engine keeps its own copy with the matmul weights in cfg.dtype.
    `prefill_dispatches` counts prefill passes."""

    def __init__(self, params: Mapping[str, torch.Tensor], cfg: ViTConfig,
                 max_slots: int, max_len: int, seed: int = 0,
                 prompt_buckets: tuple = (32, 64, 128),
                 paged: bool = False, decode_chunk: int = 1, top_k: int = 0,
                 top_p: float = 0.0):
        if paged:
            raise NotImplementedError(
                "paged KV cache: ROADMAP.md Queue 1 item 15")
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
        self.caches = G.init_kv_cache(cfg, max_slots, max_len,
                                      device=self.device)
        self.prefill_dispatches = 0

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
        return rid

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(n)

    def _admit(self):
        """Admit pending requests, coalescing same-bucket prompts into one
        prefill pass (group size padded to a power of two, as in the JAX
        engine, where it bounds the set of compiled programs)."""
        while self.pending and self.free:
            head_bucket = self._bucket(len(self.pending[0].prompt))
            group, rest = [], []
            for req in self.pending:
                if (len(group) < len(self.free)
                        and self._bucket(len(req.prompt)) == head_bucket):
                    group.append(req)
                else:
                    rest.append(req)
            self.pending = rest

            K = len(group)
            K_pad = 1 << (K - 1).bit_length()
            prompts = np.zeros((K_pad, head_bucket), np.int64)
            slots = np.zeros(K_pad, np.int64)
            for j, req in enumerate(group):
                T0 = len(req.prompt)
                slot = self.free.pop()
                req.slot = slot
                # pad tokens write cache rows >= T0, which decode's causal
                # mask (t <= pos) never reads before overwriting them
                prompts[j, :T0] = req.prompt
                slots[j] = slot
                # seed decode with the last prompt token at pos T0-1: the
                # first decode tick produces the first new token
                self._tokens[slot] = req.prompt[-1]
                self._pos[slot] = T0 - 1
                self.active[slot] = req
            # group padding duplicates the last row: identical content
            prompts[K:] = prompts[K - 1]
            slots[K:] = slots[K - 1]
            G.prefill_into_slots(self.params, self._dev(prompts), self.caches,
                                 self._dev(slots), self.cfg)
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

    def step(self) -> List[_Request]:
        """One decode tick for every active slot; returns newly finished."""
        self._admit()
        if not self.active:
            return []
        logits, self.caches = G.decode_step_multi(
            self.params, self._dev(self._tokens), self.caches,
            self._dev(self._pos), self.cfg)
        logits = logits.cpu().numpy()
        done: List[_Request] = []
        for slot, req in list(self.active.items()):
            nxt = self._sample_host(req, logits[slot])
            req.out.append(nxt)
            self._tokens[slot] = nxt
            self._pos[slot] += 1
            hit_eos = req.eos_id is not None and nxt == req.eos_id
            if len(req.out) >= req.max_new or hit_eos:
                done.append(req)
                del self.active[slot]
                self.free.append(slot)
        self.finished.extend(done)
        return done

    def step_chunk(self) -> List[_Request]:
        """Chunked tick: n tokens for every active slot per host read.
        Slots that finish mid-chunk decode on to the chunk's end and the
        host discards those tokens."""
        self._admit()
        if not self.active:
            return []
        room = min(self.max_len - int(self._pos[s]) for s in self.active)
        n = max(1, min(self.decode_chunk, room))
        temps = np.zeros(self.max_slots, np.float32)
        for slot, req in self.active.items():
            temps[slot] = req.temperature
        toks, self.caches, _ = G.decode_ticks_multi(
            self.params, self._dev(self._tokens), self.caches,
            self._dev(self._pos), n, self._dev(temps), self.cfg,
            self.top_k, self.top_p, self._dev_gen)
        toks = toks.cpu().numpy()                  # (n, B): one host read
        done: List[_Request] = []
        live = dict(self.active)
        for t in range(n):
            for slot, req in list(live.items()):
                nxt = int(toks[t, slot])
                req.out.append(nxt)
                hit_eos = req.eos_id is not None and nxt == req.eos_id
                if len(req.out) >= req.max_new or hit_eos:
                    done.append(req)
                    del live[slot]
                    del self.active[slot]
                    self.free.append(slot)
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
