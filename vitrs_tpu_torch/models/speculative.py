"""Speculative decoding: a draft model proposes K tokens, the target scores
all K + 1 positions in one forward, and the agreeing prefix is accepted —
the port of `vitrs_tpu/models/speculative.py`.

The output is the target's: greedy output equals target-only greedy
`generate` (bitwise where both sides round alike: fp32 on the CPU), and
sampled output keeps the target distribution through the rejection rule
of Leviathan et al. (2023).

There is no cache rollback: both caches are position-masked, and draft
step j consumes the token at position pos-1+j and writes that row, so
after accepting a <= K tokens the next round restarts at pos+a, the first
row a rejected draft may have written.

A host loop takes the place of the JAX `lax.while_loop`, reading the
accepted count once a round; sampling draws from an explicit
torch.Generator.  The target's verify chunk (K + 1 queries at position
pos-1) routes as every continuation chunk does (`generate._flash_cont_ok`):
K4 only when the cache length T0 + max_new + K + 1, the JAX allocation, is
a multiple of PREFILL_BLOCK, else dense cache attention.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from ..config import ViTConfig
from .generate import _filter_logits, forward_with_cache, init_kv_cache


def generate_speculative(target_params: Mapping[str, torch.Tensor],
                         draft_params: Mapping[str, torch.Tensor],
                         prompt: torch.Tensor, target_cfg: ViTConfig,
                         draft_cfg: ViTConfig, max_new: int, K: int,
                         generator: Optional[torch.Generator] = None,
                         temperature: float = 0.0, top_k: int = 0,
                         top_p: float = 0.0
                         ) -> Tuple[torch.Tensor, Dict[str, int]]:
    """prompt (1, T0) -> ((1, T0 + max_new), stats), params from
    `model.prepare_params`.  stats: target_calls, drafted, accepted (tokens
    per target call = 1 + K * accepted / drafted).  temperature > 0 needs
    `generator`, on the prompt's device.  Raises ValueError for a batch
    other than 1, K < 1, vocabularies that differ, or a cache length past
    max_seq_len without rope (the JAX wpe slice would clamp silently)."""
    B, T0 = prompt.shape
    if B != 1:
        raise ValueError("speculative decoding takes one sequence (B=1)")
    if K < 1:
        raise ValueError(f"K must be >= 1, got {K}")
    V = target_cfg.vocab_size
    if draft_cfg.vocab_size != V:
        raise ValueError("the draft and the target must share a vocabulary")
    Tmax = T0 + max_new + K + 1          # slack: the last round overshoots
    for cfg in (target_cfg, draft_cfg):
        if cfg.pos_emb != "rope" and Tmax > cfg.max_seq_len:
            raise ValueError(f"T0 + max_new + K + 1 = {Tmax} exceeds "
                             f"max_seq_len {cfg.max_seq_len}")
    sampled = temperature != 0.0
    if sampled and generator is None:
        raise ValueError("sampling needs a generator")
    dev = prompt.device
    t_caches = init_kv_cache(target_cfg, 1, Tmax, device=dev)
    d_caches = init_kv_cache(draft_cfg, 1, Tmax, device=dev)
    # both prefill the whole prompt; row T0-1 is written again, with the
    # same values, by the first round's draft step and verify chunk
    forward_with_cache(target_params, prompt, t_caches, 0, target_cfg,
                       last_only=True)
    forward_with_cache(draft_params, prompt, d_caches, 0, draft_cfg,
                       last_only=True)
    buf = torch.zeros(1, Tmax, dtype=torch.long, device=dev)
    buf[:, :T0] = prompt

    def probs_of(logits):
        return torch.softmax(_filter_logits(
            logits / max(temperature, 1e-6), top_k, top_p), dim=-1)

    def accepted_prefix(ok):
        return int(torch.cumprod(ok.int(), dim=0).sum())

    n = drafted = accepted = calls = 0
    ar = torch.arange(K, device=dev)
    while n < max_new:
        pos = T0 + n
        tok = buf[:, pos - 1:pos]
        drafts, qs = [], []
        for j in range(K):           # K draft steps, one token each
            lg, _ = forward_with_cache(draft_params, tok, d_caches,
                                       pos - 1 + j, draft_cfg)
            lg = lg[:, -1]
            if sampled:
                q = probs_of(lg)[0]
                nxt = torch.multinomial(q, 1, generator=generator)
                qs.append(q)
            else:
                nxt = torch.argmax(lg, dim=-1)
            drafts.append(nxt)
            tok = nxt[:, None]
        drafts = torch.cat(drafts)                          # (K,)
        chunk = torch.cat([buf[0, pos - 1:pos], drafts])[None]
        t_lg, _ = forward_with_cache(target_params, chunk, t_caches, pos - 1,
                                     target_cfg)
        t_lg = t_lg[0]                                      # (K + 1, V)
        if not sampled:
            emit = torch.argmax(t_lg, dim=-1)
            a = accepted_prefix(drafts == emit[:K])
        else:
            qs = torch.stack(qs)                            # (K, V)
            ps = probs_of(t_lg)                             # (K + 1, V)
            u = torch.rand(K, generator=generator, device=dev)
            a = accepted_prefix(u < ps[ar, drafts]
                                / qs[ar, drafts].clamp_min(1e-30))
            # the correction at position a: from max(p - q, 0) after a
            # rejection, from p_K (the bonus token) when every draft passed
            resid = (ps[:K] - qs).clamp_min(0.0)
            resid = resid / resid.sum(-1, keepdim=True).clamp_min(1e-30)
            dist = torch.cat([resid, ps[K:]])[a]
            corr = torch.multinomial(dist, 1, generator=generator)
            emit = torch.cat([drafts[:a], corr,
                              drafts.new_zeros(K - a)])
        buf[0, pos:pos + K + 1] = emit
        n += a + 1
        drafted += K
        accepted += a
        calls += 1
    return buf[:, :T0 + max_new], {"target_calls": calls,
                                   "drafted": drafted, "accepted": accepted}
