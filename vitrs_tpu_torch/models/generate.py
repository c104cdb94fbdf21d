"""Autoregressive generation with a KV cache — the port of the dense-cache
paths of `vitrs_tpu/models/generate.py`.

Cache layout as in the JAX package: K and V each (L, B, Tmax, kv_dim), in
cfg.dtype, the packed channel convention of the qkv activations.  Where JAX
donates the cache buffers and returns updated ones, the port writes into the
caches in place and returns the same tensors.

Fresh-prompt prefill (pos == 0, S > 1) is causal self-attention over the
prompt and goes through the flash kernels (ops/attention.py: K1-fwd for
MHA, K3-fwd for GQA, reading K/V at kv width).  With `prefill_chunk` the
prompt runs in chunks: the first is a fresh-prompt prefill, and every later
chunk is a rectangle of S queries against the cache prefix, which goes
through K4 (ops/flash_prefill.py) where `_flash_cont_ok` sends it, else
to dense cache attention.
Decode attends against the cache with plain torch (`_cache_attention`,
grouped under GQA), as the JAX package does with plain XLA.  The head
computes last-row logits only where the caller asks (`last_only`).

Rope (cfg.pos_emb == "rope") rotates q and k at their absolute positions
before the cache write, so the cache holds rotated K and the kernels run
with rope=False; the wpe table is not read.  A sliding window
(cfg.window) is the kernels' band in prefill and a mask in dense and
decode attention.  A window model can also decode from a ring cache of
window + chunk rows (`init_ring_kv`, `forward_with_ring`,
`generate_streaming`), in plain torch as in the JAX package.

A MoE model (cfg.num_experts) runs the routed expert layer in every
block's MLP (`_mlp`).

int8 weights (ops/quant.quantize_params, through model.prepare_params):
every decode path reads them where they are stored, as the JAX package
does: `model.plin` for the projections, the embedding rows and the tied head
dequantized from the int8 wte with its scales (`_embed`, `_head`).

The int8 KV cache (`init_kv_cache(int8=True)`, `generate(kv_int8=True)`):
K and V stored per token and kv head as int8 with an fp32 absmax scale
(`quantize_kv`), as (L, B, Tmax, KH, D) int8 beside (L, B, Tmax, KH, 1)
fp32.  A fresh prompt attends with its exact k and v (K1-fwd, K3-fwd under
GQA); a continuation chunk dequantizes the cache to the flat
(B, Tmax, kv_dim) layout in cfg.dtype and goes through K4 where
`_flash_cont_ok` sends it; decode attends the dequantized cache densely.
The per-slot and paged paths keep raw caches, as in the JAX package.

`generate_beam` is beam search over the dense cache (prefill once, tile
the caches over the beams, gather the parents' rows each step);
`init_paged_kv` .. `decode_ticks_paged` are the paged cache of
serving_gen's paged engine: a pool of PAGE-token pages shared by all
slots, a page table per slot, page groups prefilled through
`forward_with_cache` (K1-fwd / K3-fwd).
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import torch

from ..config import ViTConfig
from ..ops import basic, quant
from ..ops._build import resolve_device
from ..ops.attention import attention_gqa, split_gqa
from ..ops.flash_prefill import (PREFILL_BLOCK, flash_prefill_qkv,
                                 supports_prefill)
from ..ops.moe import moe_mlp
from ..ops.rope import rope_qk
from . import model as M


def init_kv_cache(cfg: ViTConfig, B: int, Tmax: int, int8: bool = False,
                  device="cuda"):
    """Zeroed (K, V) caches, each (L, B, Tmax, kv_dim) in cfg.dtype, on
    `device`: the card unless the caller asks for the CPU (raises when
    torch sees no CUDA device).  int8: each of K and V is the pair
    ((L, B, Tmax, KH, D) int8 zeros, (L, B, Tmax, KH, 1) fp32 ones)."""
    device = resolve_device(device)
    if int8:
        KH, D = cfg.kv_heads, cfg.head_size
        q = (cfg.num_layers, B, Tmax, KH, D)
        s = (cfg.num_layers, B, Tmax, KH, 1)
        return tuple((torch.zeros(q, dtype=torch.int8, device=device),
                      torch.ones(s, dtype=torch.float32, device=device))
                     for _ in range(2))
    shape = (cfg.num_layers, B, Tmax, cfg.kv_dim)
    dtype = getattr(torch, cfg.dtype)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def quantize_kv(x: torch.Tensor, num_heads: int):
    """(B, S, C) -> (int8 (B, S, NH, D), fp32 absmax scale (B, S, NH, 1)):
    symmetric per token and head, q = round(x / scale * 127)."""
    B, S, C = x.shape
    xh = x.reshape(B, S, num_heads, C // num_heads).float()
    scale = xh.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    q = torch.clamp(torch.round(xh / scale * 127.0), -127, 127)
    return q.to(torch.int8), scale


def _dequant_rows(q: torch.Tensor, scale: torch.Tensor, dtype):
    """(B, T, NH, D) int8 and its (B, T, NH, 1) scale -> (B, T, NH, D) in
    dtype."""
    return (q.float() * (scale * (1.0 / 127.0))).to(dtype)


def _dequant(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """The int8 cache as (B, NH, T, D) in dtype."""
    return _dequant_rows(q, scale, dtype).transpose(1, 2)


def _layer_cache(caches, i: int):
    """Layer i of a (L, ...) cache tensor, or of each tensor of an int8
    (values, scales) pair."""
    if isinstance(caches, tuple):
        return tuple(c[i] for c in caches)
    return caches[i]


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


def _flash_cont_ok(cfg: ViTConfig, Tmax: int) -> bool:
    """Whether K4 serves a continuation chunk against a cache of Tmax
    slots: a geometry K4 takes (`supports_prefill`) and a cache length that
    is a multiple of PREFILL_BLOCK.  The kernel itself needs no such
    length; the condition is kept only so that the port routes the same
    cache shapes as the JAX package's `_flash_cont_ok` under the same
    allocation rule (`generate` rounds a chunked prefill's cache up to
    PREFILL_BLOCK in both packages: ROADMAP.md Queue 3 hazard 6).  The JAX
    rule's TPU knobs are not ported."""
    return (supports_prefill(cfg.num_heads, cfg.kv_heads, cfg.head_size)
            and Tmax % PREFILL_BLOCK == 0)


def _heads(t: torch.Tensor, n: int) -> torch.Tensor:
    B, T, W = t.shape
    return t.reshape(B, T, n, W // n).transpose(1, 2)


def _window_mask(key_pos: torch.Tensor, q_pos: torch.Tensor,
                 window: int) -> torch.Tensor:
    """Which keys a query sees: key_pos <= q_pos and, with a window,
    key_pos > q_pos - window (broadcasting)."""
    mask = key_pos <= q_pos
    if window:
        mask &= key_pos > q_pos - window
    return mask


def _qkv_rotated(x, p, cfg: ViTConfig, positions):
    """ln1 -> packed projection -> (qkv, q, k, v), q and k rotated at
    `positions` under rope (then qkv is rebuilt from the rotated parts)."""
    NH, KH = cfg.num_heads, cfg.kv_heads
    ln1 = basic.layernorm(x, p["ln1w"], p["ln1b"])[0]
    qkv = M.plin(p, "qkvw", "qkvb", ln1)
    q, k, v = split_gqa(qkv, NH, KH)
    if cfg.pos_emb == "rope":
        # absolute positions: the cache stores rotated K, so attention
        # never rotates history again
        q, k = rope_qk(q, k, positions, NH, KH)
        qkv = torch.cat([q, k, v], dim=-1)
    return qkv, q, k, v


def _mlp(p, cfg: ViTConfig, ln2: torch.Tensor) -> torch.Tensor:
    """The block's MLP half on every decode path: the dense MLP, or the
    MoE layer (its router loss dropped).  The MoE capacity comes from the
    call's own token count: B x chunk in a prefill, B in a decode tick,
    the engine's idle slots included, as the JAX package routes them."""
    if cfg.is_moe:
        return moe_mlp(ln2, p["routerw"], p["fcw"], p["fcb"], p["fcprojw"],
                       p["fcprojb"], top_k=cfg.moe_top_k,
                       cap_factor=cfg.moe_cap_factor,
                       erf=cfg.act == "gelu_erf")[0]
    return M.mlp(p, cfg, ln2)


def _residuals(x, p, cfg: ViTConfig, atty):
    """x + attproj(atty), then + the MLP half: the rest of every block."""
    x = x + M.plin(p, "attprojw", "attprojb", atty)
    return x + _mlp(p, cfg, basic.layernorm(x, p["ln2w"], p["ln2b"])[0])


def _block_with_kv(x, p, cfg: ViTConfig, k_cache, v_cache, pos: int):
    """One block over S tokens at positions pos..pos+S-1; writes their K/V
    into the caches in place: (B, Tmax, kv_dim) tensors, or int8
    ((B, Tmax, KH, D), (B, Tmax, KH, 1)) pairs."""
    B, S, C = x.shape
    NH, KH = cfg.num_heads, cfg.kv_heads
    qkv, q, k, v = _qkv_rotated(x, p, cfg,
                                pos + torch.arange(S, device=x.device))
    int8_cache = isinstance(k_cache, tuple)
    if int8_cache:
        for cache, t in ((k_cache, k), (v_cache, v)):
            tq, ts = quantize_kv(t, KH)
            cache[0][:, pos:pos + S] = tq
            cache[1][:, pos:pos + S] = ts
        Tmax = k_cache[0].shape[1]
    else:
        k_cache[:, pos:pos + S] = k
        v_cache[:, pos:pos + S] = v
        Tmax = k_cache.shape[1]
    if pos == 0 and S > 1 and not cfg.quirks:
        # causal self-attention over the prompt: the cache holds nothing the
        # causal mask would admit beyond it, so the flash kernel reads the
        # packed qkv in place (K1-fwd, or K3-fwd at kv width), with the
        # window's band, unless use_flash is off; q and k are already
        # rotated.  An int8 cache's prompt attends with the exact k and v.
        atty = attention_gqa(qkv, NH, KH, causal=True, window=cfg.window,
                             use_flash=cfg.use_flash)
    elif (S > 1 and cfg.use_flash and not cfg.quirks
          and _flash_cont_ok(cfg, Tmax)):
        # a continuation chunk: K4 streams the cache from the chunk's band
        # up to its causal frontier at kv width; an int8 cache first
        # dequantizes to the flat layout, the values decode attends
        if int8_cache:
            kf = _dequant_rows(*k_cache, x.dtype).reshape(B, Tmax, -1)
            vf = _dequant_rows(*v_cache, x.dtype).reshape(B, Tmax, -1)
        else:
            kf, vf = k_cache, v_cache
        atty = flash_prefill_qkv(q, kf, vf, NH, KH, pos, window=cfg.window)
    else:
        if int8_cache:
            kh = _dequant(*k_cache, x.dtype)
            vh = _dequant(*v_cache, x.dtype)
        else:
            kh, vh = _heads(k_cache, KH), _heads(v_cache, KH)
        q_pos = pos + torch.arange(S, device=x.device)[:, None]
        mask = _window_mask(torch.arange(Tmax, device=x.device)[None, :],
                            q_pos, cfg.window)
        atty = _cache_attention(_heads(q, NH), kh, vh, mask[None], x.dtype)
        atty = atty.transpose(1, 2).reshape(B, S, C)
    return _residuals(x, p, cfg, atty)


def _embed(params, tokens: torch.Tensor, positions, cfg: ViTConfig):
    """wte rows (dequantized with their scales where wte is int8), + wpe
    rows at `positions` unless rope, in cfg.dtype."""
    dtype = getattr(torch, cfg.dtype)
    x = params["wte"][tokens].to(dtype)
    if "wte_scale" in params:
        x = x * params["wte_scale"][tokens][..., None].to(dtype)
    if cfg.pos_emb == "rope":
        return x
    return x + params["wpe"][positions].to(dtype)


def _head(params, x: torch.Tensor) -> torch.Tensor:
    """Final LayerNorm and the tied head -> fp32 logits; an int8 wte is
    read with its scales (weight-only)."""
    lnf = basic.layernorm(x, params["lnfw"], params["lnfb"])[0]
    if "wte_scale" in params:
        return quant.linear_w8(lnf, params["wte"], params["wte_scale"]).float()
    return basic.linear(lnf, params["head"]).float()


def forward_with_cache(params: Mapping[str, torch.Tensor],
                       tokens: torch.Tensor, caches, pos: int,
                       cfg: ViTConfig, last_only: bool = False):
    """Run tokens (B, S) from position `pos` through the stack, writing the
    caches in place.  Returns (logits (B, S, V) fp32, caches), or (B, 1, V)
    logits when last_only.  params from `model.prepare_params`; caches from
    `init_kv_cache` (raw or int8)."""
    k_caches, v_caches = caches
    S = tokens.shape[-1]
    x = _embed(params, tokens, slice(pos, pos + S), cfg)
    for i in range(cfg.num_layers):
        x = _block_with_kv(x, M.layer(params, i), cfg,
                           _layer_cache(k_caches, i),
                           _layer_cache(v_caches, i), pos)
    if last_only:
        x = x[:, -1:]
    return _head(params, x), caches


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
    output is comparable across the two packages.

    prefill_chunk > 0 with T0 > prefill_chunk prefills in chunks of that
    many tokens, each writing its K/V into the cache before the next
    attends it; only the last chunk's last-position logits are computed,
    and they seed the first sampled token, so the math is the whole-prompt
    prefill's.  T0 must be a multiple of prefill_chunk (ValueError
    otherwise).  The cache is then allocated rounded up to PREFILL_BLOCK
    slots, as in the JAX package, so that every continuation chunk can take
    K4; the extra slots are never read."""
    B, T0 = prompt.shape
    Tmax = T0 + max_new
    if Tmax > cfg.max_seq_len:
        raise ValueError(f"{T0} + {max_new} tokens exceed max_seq_len "
                         f"{cfg.max_seq_len}")
    chunked = bool(prefill_chunk) and T0 > prefill_chunk
    if chunked and T0 % prefill_chunk:
        raise ValueError(f"prompt length {T0} is not a multiple of "
                         f"prefill_chunk {prefill_chunk}")
    cache_len = (-(-Tmax // PREFILL_BLOCK) * PREFILL_BLOCK if chunked
                 else Tmax)
    caches = init_kv_cache(cfg, B, cache_len, int8=kv_int8,
                           device=prompt.device)
    for off in range(0, T0, prefill_chunk if chunked else T0):
        end = off + prefill_chunk if chunked else T0
        logits, caches = forward_with_cache(params, prompt[:, off:end],
                                            caches, off, cfg, last_only=True)
    tok = _sample(logits[:, -1], generator, temperature, top_k, top_p)
    out = [tok]
    for pos in range(T0, T0 + max_new - 1):
        logits, caches = forward_with_cache(params, tok[:, None], caches, pos,
                                            cfg)
        tok = _sample(logits[:, -1], generator, temperature, top_k, top_p)
        out.append(tok)
    return torch.cat([prompt, torch.stack(out, dim=1).to(prompt.dtype)], dim=1)


def _top(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, the lower
    index first among equal values, as `jax.lax.top_k` orders them (a
    stable descending sort; `torch.topk` promises no order for ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def generate_beam(params: Mapping[str, torch.Tensor], prompt: torch.Tensor,
                  cfg: ViTConfig, max_new: int, beams: int = 4
                  ) -> torch.Tensor:
    """Beam search: prompt (B, T0) -> (B, T0 + max_new), each example's
    beam of highest cumulative log-prob.  The prompt prefills once at beam
    width 1 (K1-fwd / K3-fwd), the caches are tiled to B * beams rows
    (example-major), and every step takes the top `beams` of the
    beams * V continuations and gathers the winners' parent rows of the
    caches and histories.  Every beam runs max_new steps (no EOS), so the
    score is the plain cumulative log-prob; beams=1 is greedy decoding."""
    B, T0 = prompt.shape
    if T0 + max_new > cfg.max_seq_len and cfg.pos_emb != "rope":
        raise ValueError(f"{T0} + {max_new} tokens exceed max_seq_len "
                         f"{cfg.max_seq_len}")
    V = cfg.vocab_size
    dev = prompt.device
    caches = init_kv_cache(cfg, B, T0 + max_new, device=dev)
    logits, caches = forward_with_cache(params, prompt, caches, 0, cfg,
                                        last_only=True)
    cum, tok = _top(torch.log_softmax(logits[:, -1], dim=-1), beams)
    caches = tuple(c.repeat_interleave(beams, dim=1) for c in caches)
    cum, tok = cum.reshape(-1), tok.reshape(-1)
    gen = torch.zeros(B * beams, max_new, dtype=torch.long, device=dev)
    gen[:, 0] = tok
    base = torch.arange(B, device=dev)[:, None] * beams
    for pos in range(T0, T0 + max_new - 1):
        lg, caches = forward_with_cache(params, tok[:, None], caches, pos,
                                        cfg)
        cand = cum[:, None] + torch.log_softmax(lg[:, 0], dim=-1)
        cum, flat = _top(cand.reshape(B, beams * V), beams)
        rows = (base + flat // V).reshape(-1)
        caches = tuple(c[:, rows] for c in caches)
        gen = gen[rows]
        tok = (flat % V).reshape(-1)
        gen[:, pos - T0 + 1] = tok
        cum = cum.reshape(-1)
    best = torch.argmax(cum.reshape(B, beams), dim=-1)
    gen = gen.reshape(B, beams, max_new)[torch.arange(B, device=dev), best]
    return torch.cat([prompt, gen.to(prompt.dtype)], dim=1)


# --------------------------------------------------------------------------
# Streaming decode: a ring KV cache for sliding-window models (the JAX
# package's l.450-578).  A window-W model never attends more than W
# positions back, so the cache holds a rolling band of R = W + chunk rows
# per layer, written at row pos % R; a row's absolute position is
# reconstructed arithmetically (the latest p <= pos_end with p = j mod R).
# With rope positions the generated length is unbounded.
# --------------------------------------------------------------------------

def init_ring_kv(cfg: ViTConfig, B: int, chunk: int, device="cuda"):
    """Zeroed ring caches (L, B, window + chunk, kv_dim) in cfg.dtype: a
    chunk of S <= chunk new positions never evicts a key still inside some
    query's window.  On the card unless the caller asks for the CPU."""
    if cfg.window <= 0:
        raise ValueError("a ring cache needs a sliding-window config")
    device = resolve_device(device)
    shape = (cfg.num_layers, B, cfg.window + chunk, cfg.kv_dim)
    dtype = getattr(torch, cfg.dtype)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _block_with_kv_ring(x, p, cfg: ViTConfig, k_cache, v_cache, pos: int):
    """One block over S tokens at positions pos.. against (B, R, kv_dim)
    ring caches, written in place."""
    B, S, C = x.shape
    NH, KH = cfg.num_heads, cfg.kv_heads
    R = k_cache.shape[1]
    positions = pos + torch.arange(S, device=x.device)
    _, q, k, v = _qkv_rotated(x, p, cfg, positions)
    rows = positions % R
    k_cache[:, rows] = k
    v_cache[:, rows] = v
    # the absolute position ring row j holds after this write: the latest
    # p <= pos_end with p = j (mod R); negative = never written
    pos_end = pos + S - 1
    j = torch.arange(R, device=x.device)
    stored = pos_end - torch.remainder(pos_end - j, R)
    mask = _window_mask(stored[None, :], positions[:, None], cfg.window)
    mask &= stored[None, :] >= 0
    atty = _cache_attention(_heads(q, NH), _heads(k_cache, KH),
                            _heads(v_cache, KH), mask[None], x.dtype)
    return _residuals(x, p, cfg, atty.transpose(1, 2).reshape(B, S, C))


def forward_with_ring(params: Mapping[str, torch.Tensor],
                      tokens: torch.Tensor, caches, pos: int,
                      cfg: ViTConfig):
    """The ring twin of `forward_with_cache`: tokens (B, S), S no more than
    the chunk the ring was sized for.  Returns (logits (B, S, V) fp32,
    caches)."""
    k_caches, v_caches = caches
    S = tokens.shape[-1]
    x = _embed(params, tokens, slice(pos, pos + S), cfg)
    for i in range(cfg.num_layers):
        x = _block_with_kv_ring(x, M.layer(params, i), cfg, k_caches[i],
                                v_caches[i], pos)
    return _head(params, x), caches


def generate_streaming(params: Mapping[str, torch.Tensor],
                       prompt: torch.Tensor, cfg: ViTConfig, max_new: int,
                       generator: Optional[torch.Generator] = None,
                       temperature: float = 1.0, top_k: int = 0,
                       top_p: float = 0.0) -> torch.Tensor:
    """Windowed generation with O(window) cache memory, whatever the total
    length: prompt (B, T0) -> (B, T0 + max_new).  The prompt prefills in
    chunks of min(T0, window) through the ring, then one token per step.
    With cfg.pos_emb == "rope" the length is unbounded; with learned
    positions max_seq_len still caps it.  params from
    `model.prepare_params`."""
    B, T0 = prompt.shape
    if cfg.window <= 0:
        raise ValueError("generate_streaming needs a sliding-window config")
    if cfg.pos_emb != "rope" and T0 + max_new > cfg.max_seq_len:
        raise ValueError(f"{T0} + {max_new} tokens exceed max_seq_len "
                         f"{cfg.max_seq_len}")
    chunk = min(T0, cfg.window)
    caches = init_ring_kv(cfg, B, chunk, device=prompt.device)
    for off in range(0, T0, chunk):
        logits, caches = forward_with_ring(params, prompt[:, off:off + chunk],
                                           caches, off, cfg)
    tok = _sample(logits[:, -1], generator, temperature, top_k, top_p)
    out = [tok]
    for pos in range(T0, T0 + max_new - 1):
        logits, caches = forward_with_ring(params, tok[:, None], caches, pos,
                                           cfg)
        tok = _sample(logits[:, -1], generator, temperature, top_k, top_p)
        out.append(tok)
    return torch.cat([prompt, torch.stack(out, dim=1).to(prompt.dtype)], dim=1)


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
    _, q, k, v = _qkv_rotated(x, p, cfg, pos[:, None])
    bidx = torch.arange(B, device=x.device)
    k_cache[bidx, pos] = k[:, 0]
    v_cache[bidx, pos] = v[:, 0]
    mask = _window_mask(torch.arange(Tmax, device=x.device)[None, :],
                        pos[:, None], cfg.window)
    atty = _cache_attention(_heads(q, NH), _heads(k_cache, KH),
                            _heads(v_cache, KH), mask[:, None, :], x.dtype)
    return _residuals(x, p, cfg, atty.transpose(1, 2).reshape(B, 1, C))


def decode_step_multi(params: Mapping[str, torch.Tensor],
                      tokens: torch.Tensor, caches, pos: torch.Tensor,
                      cfg: ViTConfig):
    """tokens (B,) at per-slot positions pos (B,) -> (logits (B, V) fp32,
    caches).  Inactive slots decode too; the engine discards their logits."""
    k_caches, v_caches = caches
    x = _embed(params, tokens, pos, cfg)[:, None, :]
    for i in range(cfg.num_layers):
        x = _block_decode_multi(x, M.layer(params, i), cfg, k_caches[i],
                                v_caches[i], pos)
    return _head(params, x)[:, 0], caches


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


def _decode_ticks(step, tokens, pos, n: int, temps, top_k: int,
                  top_p: float, generator):
    """n ticks of `step(tokens, pos) -> logits (B, V)` with per-slot
    sampling on the device.  Returns (tokens (n, B), final pos)."""
    sampled = bool((temps > 0).any())
    toks = []
    for _ in range(n):
        logits = step(tokens, pos)
        nxt = torch.argmax(logits, dim=-1)
        if sampled:
            lg = _filter_logits(logits / temps.clamp_min(1e-6)[:, None],
                                top_k, top_p)
            nxt = torch.where(temps == 0.0, nxt, _categorical(lg, generator))
        toks.append(nxt)
        tokens, pos = nxt, pos + 1
    return torch.stack(toks), pos


def decode_ticks_multi(params: Mapping[str, torch.Tensor],
                       tokens: torch.Tensor, caches, pos: torch.Tensor,
                       n: int, temps: torch.Tensor, cfg: ViTConfig,
                       top_k: int, top_p: float = 0.0,
                       generator: Optional[torch.Generator] = None):
    """n decode ticks for all slots with sampling on the device, so the
    host reads the tokens once per chunk.  temps (B,) per-slot temperature,
    0 = greedy; top_k/top_p engine-wide.  Returns (tokens (n, B), caches,
    final pos)."""
    toks, pos = _decode_ticks(
        lambda t, p: decode_step_multi(params, t, caches, p, cfg)[0],
        tokens, pos, n, temps, top_k, top_p, generator)
    return toks, caches, pos


# --------------------------------------------------------------------------
# Paged KV cache (the JAX package's l.683-846): a pool of PAGE-token pages
# shared by all slots and a host-managed page table (slot, page index) ->
# pool page, so that memory follows the live tokens, not max_slots x
# max_len.  Decode gathers each slot's pages (B, MAX_PP, PAGE, kv_dim) and
# masks by position.  Page 0 is the engine's write sink.
# --------------------------------------------------------------------------

PAGE = 16                   # tokens per page


def init_paged_kv(cfg: ViTConfig, n_pages: int, device="cuda"):
    """Zeroed page pools (L, n_pages, PAGE, kv_dim) in cfg.dtype for K and
    V, on the card unless the caller asks for the CPU."""
    device = resolve_device(device)
    shape = (cfg.num_layers, n_pages, PAGE, cfg.kv_dim)
    dtype = getattr(torch, cfg.dtype)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _block_decode_paged(x, p, cfg: ViTConfig, kp, vp, table: torch.Tensor,
                        pos: torch.Tensor):
    """One block for one new token per slot: kp/vp (n_pages, PAGE,
    kv_dim) written in place at each slot's page and offset; table
    (B, MAX_PP) page ids; pos (B,)."""
    B, _, C = x.shape
    NH, KH = cfg.num_heads, cfg.kv_heads
    Tv = table.shape[1] * PAGE                  # the virtual max length
    _, q, k, v = _qkv_rotated(x, p, cfg, pos[:, None])
    page = table[torch.arange(B, device=x.device), pos // PAGE]
    kp[page, pos % PAGE] = k[:, 0]
    vp[page, pos % PAGE] = v[:, 0]
    kh = _heads(kp[table].reshape(B, Tv, -1), KH)
    vh = _heads(vp[table].reshape(B, Tv, -1), KH)
    mask = _window_mask(torch.arange(Tv, device=x.device)[None, :],
                        pos[:, None], cfg.window)
    atty = _cache_attention(_heads(q, NH), kh, vh, mask[:, None, :], x.dtype)
    return _residuals(x, p, cfg, atty.transpose(1, 2).reshape(B, 1, C))


def decode_step_paged(params: Mapping[str, torch.Tensor],
                      tokens: torch.Tensor, caches, table: torch.Tensor,
                      pos: torch.Tensor, cfg: ViTConfig):
    """The paged twin of `decode_step_multi`: table (B, MAX_PP), pos (B,)
    -> (logits (B, V) fp32, caches)."""
    kps, vps = caches
    x = _embed(params, tokens, pos, cfg)[:, None, :]
    for i in range(cfg.num_layers):
        x = _block_decode_paged(x, M.layer(params, i), cfg, kps[i], vps[i],
                                table, pos)
    return _head(params, x)[:, 0], caches


def prefill_into_pages(params: Mapping[str, torch.Tensor],
                       prompt: torch.Tensor, caches, page_ids: torch.Tensor,
                       cfg: ViTConfig):
    """A (T0,) prompt (T0 a multiple of PAGE) through the stack, its K/V
    rows scattered into pool pages `page_ids` (T0 // PAGE,), in sequence
    order.  Returns (last-token logits (V,), caches)."""
    logits, caches = prefill_into_pages_multi(params, prompt[None], caches,
                                              page_ids[None], cfg)
    return logits[0], caches


def prefill_into_pages_multi(params: Mapping[str, torch.Tensor],
                             prompts: torch.Tensor, caches,
                             page_ids: torch.Tensor, cfg: ViTConfig):
    """Coalesced paged prefill: K same-bucket prompts (K, T0), T0 a
    multiple of PAGE, in one pass through `forward_with_cache` at position
    0 (K1-fwd, or K3-fwd under GQA); page_ids (K, T0 // PAGE).  Duplicate
    page-id rows (group padding) write identical content.  Returns
    (last-row logits (K, V), caches)."""
    kps, vps = caches
    K, T0 = prompts.shape
    if T0 % PAGE:
        raise ValueError(f"prompt length {T0} is not a multiple of {PAGE}")
    tmp = init_kv_cache(cfg, K, T0, device=prompts.device)
    logits, (kc, vc) = forward_with_cache(params, prompts, tmp, 0, cfg,
                                          last_only=True)
    flat = page_ids.reshape(-1)
    L = cfg.num_layers
    kps[:, flat] = kc.reshape(L, -1, PAGE, kc.shape[-1])
    vps[:, flat] = vc.reshape(L, -1, PAGE, vc.shape[-1])
    return logits[:, -1], caches


def decode_ticks_paged(params: Mapping[str, torch.Tensor],
                       tokens: torch.Tensor, caches, table: torch.Tensor,
                       pos: torch.Tensor, n: int, temps: torch.Tensor,
                       cfg: ViTConfig, top_k: int, top_p: float = 0.0,
                       generator: Optional[torch.Generator] = None):
    """The paged twin of `decode_ticks_multi`: every page the n ticks
    write must already be in `table` (the engine allocates before the
    call).  Returns (tokens (n, B), caches, final pos)."""
    toks, pos = _decode_ticks(
        lambda t, p: decode_step_paged(params, t, caches, table, p, cfg)[0],
        tokens, pos, n, temps, top_k, top_p, generator)
    return toks, caches, pos
