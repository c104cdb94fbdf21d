"""PyTorch port: the flash kernels' rectangle with a query offset past the
keys' end, the block the ring's cut hop hands them
(parallel/ring_attention.py `_band_window`), against the JAX ring's block
(`vitrs_tpu/parallel/ring_attention.py` `_block_attend`).

q rows 0..Tq-1 sit at positions q_offset + i against keys 0..Tk-1
(causal, with or without a window).  The port's side is what the ring
calls, `ring_attention._kernel_fwd` / `_kernel_bwd` (the `vitrs::` ops,
whose CPU implementations are `flash_fwd_plain` / `flash_bwd_plain`), the
backward from the forward's out and lse.  The JAX side runs `_block_attend`
from the empty state (m -inf, l 0, acc 0) with K/V expanded to the query
heads, normalised (out = acc / l, lse = m + log l; 0 and -inf where a row
sees no key), and its gradients are `jax.vjp` of that normalised block, so
that dk and dv come summed over each kv head's group.

Geometries: the ring's cut hops as `_band_window` computes them (the 8K
window's shape scaled down, rows and offsets off every tile grid; W above
T/cp, where two hops are cut), a causal frontier inside the block's rows
without a window, rows that see no key (out 0, lse -inf, zero gradients)
and keys past the frontier (zero dk and dv, never read: a NaN there stays
out of every result).  Tolerances, fp32 throughout (the ring tests'):
out and lse rtol 2e-5 atol 2e-5, gradients rtol 3e-4 atol 3e-5."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitrs_tpu.parallel import ring_attention as JRA
from vitrs_tpu_torch.ops import flash_attention as TFA
from vitrs_tpu_torch.parallel import ring_attention as TRA

B, D = 2, 64
SCALE = 1.0 / math.sqrt(D)
OUT_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=3e-4, atol=3e-5)
HEADS = {"mha": (2, 2), "gqa": (4, 2), "mqa": (4, 1)}


def _ring_cut(T, window, d):
    """(Tq, Tk, q_offset, window) of the rectangle the ring hands the
    kernels on the hop d blocks back, blocks of T rows (`_band_window`)."""
    rows, first = TRA._band_window(T, T, d * T, 0, window)
    return rows, T - first, d * T - first, window


# name -> (Tq, Tk, q_offset, window)
GEOMS = {
    # the 8K window's cut hop (T/cp=4096, W=1024: 1023 rows at offset 1023
    # against 1023 keys), at T/cp=40, W=24: 23 rows at 23 against 23 keys
    "ring_cut": _ring_cut(40, 24, 1),
    # W=45 above T/cp=16: the hops 2 and 3 blocks back are both cut
    "ring_two_cuts_near": _ring_cut(16, 45, 2),
    "ring_two_cuts_far": _ring_cut(16, 45, 3),
    # no window: the frontier (Tk) falls inside the rows
    "frontier_in_rows": (37, 29, 13, 0),
    # rows 24..29 see no key
    "rows_see_nothing": (30, 20, 10, 15),
    # keys 15..39 past the frontier q_offset + Tq
    "keys_past_frontier": (10, 40, 5, 7),
}
CASES = [(g, h) for g in GEOMS for h in HEADS]


def test_ring_geometries_are_off_the_grid():
    """The ring cases cut rows and keys off the 64 grid and the CPU
    block, with the queries past the keys' end."""
    for name in ("ring_cut", "ring_two_cuts_near", "ring_two_cuts_far"):
        Tq, Tk, off, W = GEOMS[name]
        assert off + Tq > Tk and Tq % 64 and Tk % 64, name
    assert GEOMS["ring_cut"] == (23, 23, 23, 24)
    assert GEOMS["ring_two_cuts_near"] == (16, 16, 32, 45)
    assert GEOMS["ring_two_cuts_far"] == (12, 12, 44, 45)
    assert TRA._band_window(4096, 4096, 4096, 0, 1024) == (1023, 3073)


def _inputs(geom, heads, seed=0):
    Tq, Tk, _, _ = GEOMS[geom]
    H, KH = HEADS[heads]
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((B, Tq, H * D), dtype=np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, Tk, KH * D), dtype=np.float32)
            for _ in range(2))
    return q, k, v, do


def _jax_heads(a, h):
    """(B, T, h*D) -> (B, h, T, D), the JAX ring's layout."""
    return jnp.asarray(a.reshape(a.shape[0], a.shape[1], h, D)
                       .transpose(0, 2, 1, 3))


def _packed(a):
    """(B, h, T, D) -> (B, T, h*D)."""
    a = np.asarray(a)
    return a.transpose(0, 2, 1, 3).reshape(a.shape[0], a.shape[2], -1)


def _jax_block(geom, heads, q, k, v, do):
    """The JAX ring's block from the empty state, normalised: (out, lse
    (B, NH, Tq), dq, dk, dv) in the port's layout."""
    H, KH = HEADS[heads]
    got = _jax_fn(geom, heads)(_jax_heads(q, H), _jax_heads(k, KH),
                               _jax_heads(v, KH), _jax_heads(do, H))
    return (_packed(got[0]), np.asarray(got[1]),
            *(_packed(g) for g in got[2:]))


@functools.cache
def _jax_fn(geom, heads):
    """One jit a case: (q, k, v, do) in the JAX layout -> (out, lse, dq,
    dk, dv)."""
    Tq, _, off, W = GEOMS[geom]
    H, KH = HEADS[heads]
    G = H // KH

    def block(qh, kh, vh):
        m = jnp.full((B, H, Tq, 1), -jnp.inf, jnp.float32)
        l = jnp.zeros((B, H, Tq, 1), jnp.float32)
        acc = jnp.zeros((B, H, Tq, D), jnp.float32)
        m, l, acc = JRA._block_attend(qh, jnp.repeat(kh, G, axis=1),
                                      jnp.repeat(vh, G, axis=1), m, l, acc,
                                      off, 0, SCALE, True, W)
        seen = l > 0
        out = jnp.where(seen, acc / jnp.where(seen, l, 1.0), 0.0)
        lse = jnp.where(seen, m + jnp.log(jnp.where(seen, l, 1.0)),
                        -jnp.inf)
        return out, lse[..., 0]

    def fn(qh, kh, vh, doh):
        (out, lse), vjp = jax.vjp(block, qh, kh, vh)
        return (out, lse, *vjp((doh, jnp.zeros_like(lse))))
    return jax.jit(fn)


def _port(geom, heads, q, k, v, do):
    """The ring's kernel route on the rectangle: (out, lse, dq, dk, dv)."""
    _, _, off, W = GEOMS[geom]
    H, KH = HEADS[heads]
    q, k, v, do = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = TRA._kernel_fwd(q, k, v, H, KH, True, SCALE, W, off)
    grads = TRA._kernel_bwd(q, k, v, out, lse, do, H, KH, True, SCALE, W,
                            off)
    return [t.numpy() for t in (out, lse, *grads)]


@pytest.mark.parametrize("geom,heads", CASES)
def test_rectangle_forward_matches_jax_block(geom, heads):
    args = _inputs(geom, heads)
    want = _jax_block(geom, heads, *args)
    got = _port(geom, heads, *args)
    for name, g, w in zip(("out", "lse"), got[:2], want[:2]):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        np.testing.assert_allclose(g, w, err_msg=name, **OUT_TOL)


@pytest.mark.parametrize("geom,heads", CASES)
def test_rectangle_backward_matches_jax_vjp(geom, heads):
    args = _inputs(geom, heads, seed=1)
    want = _jax_block(geom, heads, *args)
    got = _port(geom, heads, *args)
    for name, g, w in zip(("dq", "dk", "dv"), got[2:], want[2:]):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        np.testing.assert_allclose(g, w, err_msg=name, **GRAD_TOL)


def test_rows_that_see_no_key_give_zeros():
    Tq, Tk, off, W = GEOMS["rows_see_nothing"]
    out, lse, dq, dk, dv = _port("rows_see_nothing", "gqa",
                                 *_inputs("rows_see_nothing", "gqa"))
    blind = np.arange(Tq) + off - W >= Tk - 1      # band starts past the keys
    assert blind.sum() == 6
    assert (out[:, blind] == 0).all() and (dq[:, blind] == 0).all()
    assert np.isneginf(lse[..., blind]).all()
    assert np.isfinite(lse[..., ~blind]).all()
    assert np.isfinite(dk).all() and np.isfinite(dv).all()


def test_keys_past_the_frontier_are_never_read():
    """NaN keys past min(Tk, q_offset + Tq) reach no result; their dk and
    dv are 0."""
    Tq, Tk, off, W = GEOMS["keys_past_frontier"]
    q, k, v, do = _inputs("keys_past_frontier", "mqa")
    k[:, off + Tq:] = np.nan
    v[:, off + Tq:] = np.nan
    out, lse, dq, dk, dv = _port("keys_past_frontier", "mqa", q, k, v, do)
    for t in (out, lse, dq, dk[:, :off + Tq], dv[:, :off + Tq]):
        assert np.isfinite(t).all()
    assert (dk[:, off + Tq:] == 0).all() and (dv[:, off + Tq:] == 0).all()

