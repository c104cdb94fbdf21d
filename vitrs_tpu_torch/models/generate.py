"""Autoregressive generation with a KV cache — the port of the dense-cache
paths of `vitrs_tpu/models/generate.py`.

Cache layout as in the JAX package: K and V each (L, B, Tmax, kv_dim), in
cfg.dtype, the packed channel convention of the qkv activations.  Where JAX
donates the cache buffers and returns updated ones, the port writes into the
caches in place and returns the same tensors.

Fresh-prompt prefill (pos == 0, S > 1) is causal self-attention over the
prompt and goes through the flash kernel (ops/attention.py).  Decode and
continuation steps attend against the cache with plain torch
(`_cache_attention`), as the JAX package does with plain XLA.  The head
computes last-row logits only where the caller asks (`last_only`).

Not ported yet: the int8 KV cache, chunked prefill (continuation chunks
through the rectangular kernel K4), paged, beam and streaming decode —
they raise NotImplementedError naming ROADMAP.md Queue 1 item 15.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import torch

from ..config import ViTConfig
from ..ops import basic
from ..ops.attention import attention, split_gqa
from . import model as M

_ITEM15 = "ROADMAP.md Queue 1 item 15 (generation and serving)"


def init_kv_cache(cfg: ViTConfig, B: int, Tmax: int, int8: bool = False,
                  device="cpu"):
    """Zeroed (K, V) caches, each (L, B, Tmax, kv_dim) in cfg.dtype."""
    if int8:
        raise NotImplementedError(f"int8 KV cache: {_ITEM15}")
    shape = (cfg.num_layers, B, Tmax, cfg.kv_dim)
    dtype = getattr(torch, cfg.dtype)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _cache_attention(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                     mask_bst: torch.Tensor, out_dtype) -> torch.Tensor:
    """Grouped cache attention: qh (B, NH, S, D) against kh/vh (B, KH, T, D)
    with KH | NH; mask broadcastable to (B, S, T).  Scores and softmax in
    fp32; the probabilities round to the cache dtype before P.V, whose
    products accumulate in fp32 (the JAX einsums' preferred_element_type)."""
    B, NH, S, D = qh.shape
    KH = kh.shape[1]
    qg = qh.reshape(B, KH, NH // KH, S, D).float()
    s = torch.matmul(qg, kh.float()[:, :, None].transpose(-1, -2))
    s = s * (1.0 / math.sqrt(D))
    s = s.masked_fill(~mask_bst[:, None, None], -math.inf)
    att = torch.softmax(s, dim=-1).to(vh.dtype)
    out = torch.matmul(att.float(), vh.float()[:, :, None])
    return out.reshape(B, NH, S, D).to(out_dtype)


def _heads(t: torch.Tensor, n: int) -> torch.Tensor:
    B, T, W = t.shape
    return t.reshape(B, T, n, W // n).transpose(1, 2)


def _block_with_kv(x, p, cfg: ViTConfig, k_cache, v_cache, pos: int):
    """One block over S tokens at positions pos..pos+S-1; writes their K/V
    into the (B, Tmax, kv_dim) caches in place."""
    B, S, C = x.shape
    NH, KH = cfg.num_heads, cfg.kv_heads
    ln1 = basic.layernorm(x, p["ln1w"], p["ln1b"])[0]
    qkv = basic.linear(ln1, p["qkvw"], p["qkvb"])
    q, k, v = split_gqa(qkv, NH, KH)
    k_cache[:, pos:pos + S] = k
    v_cache[:, pos:pos + S] = v
    if pos == 0 and S > 1:
        # causal self-attention over the prompt: the cache holds nothing the
        # causal mask would admit beyond it, so the flash kernel reads the
        # packed qkv in place
        atty = attention(qkv, NH, causal=True)
    else:
        Tmax = k_cache.shape[1]
        q_pos = pos + torch.arange(S, device=x.device)[:, None]
        mask = torch.arange(Tmax, device=x.device)[None, :] <= q_pos
        atty = _cache_attention(_heads(q, NH), _heads(k_cache, KH),
                                _heads(v_cache, KH), mask[None], x.dtype)
        atty = atty.transpose(1, 2).reshape(B, S, C)
    x = x + basic.linear(atty, p["attprojw"], p["attprojb"])
    return x + M.mlp(p, cfg, basic.layernorm(x, p["ln2w"], p["ln2b"])[0])


def forward_with_cache(params: Mapping[str, torch.Tensor],
                       tokens: torch.Tensor, caches, pos: int,
                       cfg: ViTConfig, last_only: bool = False):
    """Run tokens (B, S) from position `pos` through the stack, writing the
    caches in place.  Returns (logits (B, S, V) fp32, caches), or (B, 1, V)
    logits when last_only.  params from `model.prepare_params`."""
    k_caches, v_caches = caches
    dtype = getattr(torch, cfg.dtype)
    S = tokens.shape[-1]
    x = (params["wte"][tokens].to(dtype)
         + params["wpe"][pos:pos + S][None].to(dtype))
    for i in range(cfg.num_layers):
        x = _block_with_kv(x, M.layer(params, i), cfg, k_caches[i],
                           v_caches[i], pos)
    if last_only:
        x = x[:, -1:]
    lnf = basic.layernorm(x, params["lnfw"], params["lnfb"])[0]
    return basic.linear(lnf, params["head"]).float(), caches


def _filter_logits(logits: torch.Tensor, top_k: int, top_p: float):
    """Top-k and/or nucleus (top-p) filtering; top-p keeps the smallest set
    whose probability mass reaches p (the argmax always survives)."""
    if top_k:
        kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
        logits = logits.masked_fill(logits < kth, -math.inf)
    if top_p and top_p < 1.0:
        srt = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
        kth = torch.where(keep, srt, torch.full_like(srt, math.inf)).amin(
            dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < kth, -math.inf)
    return logits


def _categorical(logits: torch.Tensor, generator: torch.Generator):
    """One draw per row of (B, V) logits."""
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0]


def _sample(logits, generator, temperature: float, top_k: int,
            top_p: float = 0.0):
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    return _categorical(_filter_logits(logits / temperature, top_k, top_p),
                        generator)


def generate(params: Mapping[str, torch.Tensor], prompt: torch.Tensor,
             cfg: ViTConfig, max_new: int,
             generator: Optional[torch.Generator] = None,
             temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0,
             kv_int8: bool = False, prefill_chunk: int = 0) -> torch.Tensor:
    """prompt (B, T0) -> (B, T0 + max_new): prefill once, then decode one
    token per step.  Sampling draws from `generator` (required when
    temperature > 0); its stream differs from jax.random's, so only greedy
    output is comparable across the two packages."""
    if prefill_chunk:
        raise NotImplementedError(
            f"chunked prefill (kernel K4, flash_prefill): {_ITEM15}")
    B, T0 = prompt.shape
    if T0 + max_new > cfg.max_seq_len:
        raise ValueError(f"{T0} + {max_new} tokens exceed max_seq_len "
                         f"{cfg.max_seq_len}")
    caches = init_kv_cache(cfg, B, T0 + max_new, int8=kv_int8,
                           device=prompt.device)
    logits, caches = forward_with_cache(params, prompt, caches, 0, cfg,
                                        last_only=True)
    tok = _sample(logits[:, -1], generator, temperature, top_k, top_p)
    out = [tok]
    for pos in range(T0, T0 + max_new - 1):
        logits, caches = forward_with_cache(params, tok[:, None], caches, pos,
                                            cfg)
        tok = _sample(logits[:, -1], generator, temperature, top_k, top_p)
        out.append(tok)
    return torch.cat([prompt, torch.stack(out, dim=1).to(prompt.dtype)], dim=1)


def generate_beam(*args, **kwargs):
    raise NotImplementedError(f"beam search: {_ITEM15}")


def generate_streaming(*args, **kwargs):
    raise NotImplementedError(f"ring-cache streaming decode: {_ITEM15}")


# --------------------------------------------------------------------------
# Continuous-batching decode: per-slot positions (serving_gen.py engine)
# --------------------------------------------------------------------------

def _block_decode_multi(x, p, cfg: ViTConfig, k_cache, v_cache,
                        pos: torch.Tensor):
    """One block for ONE new token per slot, at per-slot positions pos (B,);
    writes each slot's K/V at its own position, in place."""
    B, _, C = x.shape
    NH, KH = cfg.num_heads, cfg.kv_heads
    Tmax = k_cache.shape[1]
    ln1 = basic.layernorm(x, p["ln1w"], p["ln1b"])[0]
    qkv = basic.linear(ln1, p["qkvw"], p["qkvb"])
    q, k, v = split_gqa(qkv, NH, KH)
    bidx = torch.arange(B, device=x.device)
    k_cache[bidx, pos] = k[:, 0]
    v_cache[bidx, pos] = v[:, 0]
    mask = torch.arange(Tmax, device=x.device)[None, :] <= pos[:, None]
    atty = _cache_attention(_heads(q, NH), _heads(k_cache, KH),
                            _heads(v_cache, KH), mask[:, None, :], x.dtype)
    atty = atty.transpose(1, 2).reshape(B, 1, C)
    x = x + basic.linear(atty, p["attprojw"], p["attprojb"])
    return x + M.mlp(p, cfg, basic.layernorm(x, p["ln2w"], p["ln2b"])[0])


def decode_step_multi(params: Mapping[str, torch.Tensor],
                      tokens: torch.Tensor, caches, pos: torch.Tensor,
                      cfg: ViTConfig):
    """tokens (B,) at per-slot positions pos (B,) -> (logits (B, V) fp32,
    caches).  Inactive slots decode too; the engine discards their logits."""
    k_caches, v_caches = caches
    dtype = getattr(torch, cfg.dtype)
    x = (params["wte"][tokens].to(dtype)
         + params["wpe"][pos].to(dtype))[:, None, :]
    for i in range(cfg.num_layers):
        x = _block_decode_multi(x, M.layer(params, i), cfg, k_caches[i],
                                v_caches[i], pos)
    lnf = basic.layernorm(x, params["lnfw"], params["lnfb"])[0]
    return basic.linear(lnf, params["head"])[:, 0].float(), caches


def prefill_into_slots(params: Mapping[str, torch.Tensor],
                       prompts: torch.Tensor, caches, slots: torch.Tensor,
                       cfg: ViTConfig):
    """Coalesced prefill: K same-bucket prompts (K, T0) through the stack in
    one pass, their K/V written into cache rows `slots` (K,) positions
    0..T0-1.  Duplicate slot entries (group padding) carry identical rows.
    Returns (last-row logits (K, V), caches)."""
    k_caches, v_caches = caches
    K, T0 = prompts.shape
    tmp = init_kv_cache(cfg, K, T0, device=prompts.device)
    logits, (kc, vc) = forward_with_cache(params, prompts, tmp, 0, cfg,
                                          last_only=True)
    k_caches[:, slots, :T0] = kc
    v_caches[:, slots, :T0] = vc
    return logits[:, -1], caches


def decode_ticks_multi(params: Mapping[str, torch.Tensor],
                       tokens: torch.Tensor, caches, pos: torch.Tensor,
                       n: int, temps: torch.Tensor, cfg: ViTConfig,
                       top_k: int, top_p: float = 0.0,
                       generator: Optional[torch.Generator] = None):
    """n decode ticks for all slots with sampling on the device, so the
    host reads the tokens once per chunk.  temps (B,) per-slot temperature,
    0 = greedy; top_k/top_p engine-wide.  Returns (tokens (n, B), caches,
    final pos)."""
    sampled = bool((temps > 0).any())
    toks = []
    for _ in range(n):
        logits, caches = decode_step_multi(params, tokens, caches, pos, cfg)
        nxt = torch.argmax(logits, dim=-1)
        if sampled:
            lg = _filter_logits(logits / temps.clamp_min(1e-6)[:, None],
                                top_k, top_p)
            nxt = torch.where(temps == 0.0, nxt, _categorical(lg, generator))
        toks.append(nxt)
        tokens, pos = nxt, pos + 1
    return torch.stack(toks), caches, pos
