"""The bound chip_smoke.py holds the flash forwards to (`out_errors`, shared
with the card-only tests through tests/flash_tolerance.py), on the CPU at
K4's 8K shape: softmax rows over 7680 keys with scores of unit variance,
as the smoke's random q and k give, so the output's rms is about
sqrt(e / 7680) = 0.019.

  * the kernel's own rounding passes: p rounded to bf16 against another
    max (a relative error of up to 2^-9 before rounding) and the output
    rounded to bf16 on both sides;
  * faults that move the output by a few percent of its rms fail: a
    dropped 64-key tile, and a causal frontier moved by 4 keys;
  * rows that see few keys (a causal tensor's first rows) are held to
    their own size: their rounding passes, which the tensor's rms alone
    would reject, and a frontier moved in them fails;
  * fp32: other summation orders pass at 1e-5, an error of 1e-4 fails.

The sliding window's edge is a finer fault: a band that ends one key early
or late at W=1024 moves a random input's output by about 1/W of its rms,
under the bf16 bound, so the bound alone cannot see it.  The smoke's
band-edge inputs (`band_edge_qk`) make every query's scores peak at the
band's last key and the first key outside it, and there a band moved by one
key fails the same bound, with and without rope; at W=1 the output is v
exactly.

The ring hops' gradient bound (`grad_errors`, the kernels-cp phase), on
the CPU at two ring blocks of 1024 (MHA) and 2048 (one kv head): the hops'
summed bf16 gradients pass against the plain gradient of the whole
sequence, and the sum with rank 1's past hop dropped, halved or scaled by
0.95 fails in dq, dk and dv alike.

The one-term allowance of the head-dim checks (`bwd_term_norms`): per
element of dq, dk and dv, the L2 norm of its sum's terms, against the
terms written out one head and one element at a time (GQA groups, the
band, rope's pairs)."""

import numpy as np
import pytest
import torch

from flash_tolerance import (band_edge_qk, bwd_term_norms, grad_errors,
                             out_errors, summed_hops)
from vitrs_tpu_torch.ops import flash_attention as FA
from vitrs_tpu_torch.ops.flash_attention import flash_bwd_plain, flash_fwd_plain
from vitrs_tpu_torch.parallel import ring_attention as RA

B, S, N, D = 2, 64, 7680, 64


def _case(fault):
    rng = np.random.default_rng(0)
    s = torch.from_numpy(rng.standard_normal((B, S, N), dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((N, D), dtype=np.float32))
    v = v.bfloat16().float()
    p = torch.softmax(s, dim=-1)
    want = (p.bfloat16().float() @ v) / p.bfloat16().float().sum(-1, True)
    if fault == "rounding":
        eps = torch.from_numpy(rng.uniform(-2.0 ** -9, 2.0 ** -9, p.shape)
                               .astype(np.float32))
        pk = (p * (1 + eps)).bfloat16().float()
    elif fault == "dropped_tile":
        pk = p.clone()
        pk[..., 4096:4160] = 0.0
    else:                                   # frontier 4 keys short
        pk = p.clone()
        pk[..., -4:] = 0.0
    got = (pk @ v) / pk.sum(-1, keepdim=True)
    return got.bfloat16(), want.bfloat16()


@pytest.mark.parametrize("fault,caught", [("rounding", False),
                                          ("dropped_tile", True),
                                          ("frontier_4", True)])
def test_bf16_bound_passes_rounding_and_fails_faults(fault, caught):
    bad, err, rms = out_errors(*_case(fault))
    assert 0.015 < rms < 0.025
    assert (bad > 0) == caught, (fault, bad, err, rms)
    if caught:
        assert bad > 100


def _few_keys_case(seed, fault, few=68, many=1024, D=64):
    """64 rows that see `few` keys (a causal or banded tensor's first rows)
    above 960 rows that see `many`: p rounded against another max, and
    with `fault` the few-key rows' last 4 keys dropped."""
    rng = np.random.default_rng(seed)
    v = torch.from_numpy(rng.standard_normal((many, D), dtype=np.float32))
    v = v.bfloat16().float()
    gots, wants = [], []
    for rows, n in ((64, few), (960, many)):
        p = torch.softmax(torch.from_numpy(
            rng.standard_normal((rows, n), dtype=np.float32)), dim=-1)
        pw = p.bfloat16().float()
        wants.append((pw @ v[:n]) / pw.sum(-1, keepdim=True))
        eps = torch.from_numpy(rng.uniform(-2.0 ** -9, 2.0 ** -9, p.shape)
                               .astype(np.float32))
        pk = (p * (1 + eps)).bfloat16().float()
        if fault and n == few:
            pk[:, -4:] = 0.0
        gots.append((pk @ v[:n]) / pk.sum(-1, keepdim=True))
    return (torch.cat(gots)[None].bfloat16(),
            torch.cat(wants)[None].bfloat16())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_bound_follows_the_size_of_rows_with_few_keys(seed):
    """Rows with few keys have outputs several times the tensor's rms, and
    p's rounding moves them in proportion: the row-rms term passes it
    where the tensor's rms alone rejects a few values (as one draw on the
    card did, a row with 68 keys at T=8192), and a frontier 4 keys short
    in those rows still fails most of their values."""
    got, want = _few_keys_case(seed, fault=False)
    assert out_errors(got, want)[0] == 0
    assert out_errors(got, want, rows=False)[0] > 0
    got, want = _few_keys_case(seed, fault=True)
    assert out_errors(got, want)[0] > 64 * 64 // 2


def test_fp32_bound():
    rng = np.random.default_rng(1)
    want = torch.from_numpy(rng.standard_normal((4, 100), dtype=np.float32))
    assert out_errors(want + 1e-6, want)[0] == 0
    assert out_errors(want + 1e-4, want)[0] == want.numel()


def _band_out(q, k, v, nh, window, rope):
    return flash_fwd_plain(q, k, v, nh, True, 0.125,
                           kv_heads=k.shape[-1] // 64, window=window,
                           rope=rope)[0]


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("window", [1, 5, 63, 64, 65])
@pytest.mark.parametrize("kh", [2, 1])
def test_band_edge_inputs_catch_a_band_moved_by_one_key(kh, window, rope):
    nh, T = 2, 200
    q, k = band_edge_qk(1, T, T, nh, kh, window, rope=rope, device="cpu")
    v = torch.from_numpy(np.random.default_rng(window).standard_normal(
        (1, T, kh * 64), dtype=np.float32))
    q, k, v = (t.bfloat16() for t in (q, k, v))
    want = _band_out(q, k, v, nh, window, rope)
    if window == 1:        # p = 1 on the query's own key: out is v exactly
        own = v.unflatten(-1, (kh, 1, 64)).expand(1, T, kh, nh // kh, 64)
        assert torch.equal(want, own.reshape(1, T, nh * 64))
    for moved in (window - 1, window + 1):
        got = _band_out(q, k, v, nh, moved, rope)     # 0: full causal
        bad, err, rms = out_errors(got, want)
        assert bad > (T - window) * nh * 64 // 4, (moved, bad, err, rms)


def test_random_inputs_see_a_band_moved_by_one_key_only_faintly():
    """W=1024 against W=1025 on random inputs (T=2048, one head): the extra
    key carries about 1/W of the weight, so only the rows where its score
    happens to be high cross the bound: about a tenth of the elements of
    the rows past the band's start at this seed, where the band-edge
    inputs move most of them."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2048, 64),
                                                    dtype=np.float32))
               .bfloat16() for _ in range(3))
    want = _band_out(q, k, v, 1, 1024, False)
    bad, err, rms = out_errors(_band_out(q, k, v, 1, 1025, False), want)
    assert 0 < bad < 0.2 * (2048 - 1024) * 64, (bad, err, rms)
    q, k = band_edge_qk(1, 2048, 2048, 1, 1, 1024, device="cpu")
    q, k = q.bfloat16(), k.bfloat16()
    want = _band_out(q, k, v, 1, 1024, False)
    bad, err, rms = out_errors(_band_out(q, k, v, 1, 1025, False), want)
    assert bad > 0.5 * (2048 - 1024) * 64, (bad, err, rms)


def _ring_grads(T, kh, nh=2):
    """Two ring blocks of T (bf16, causal): each hop's plain backward from
    the merged out and lse, and the plain backward of the whole sequence."""
    torch.manual_seed(0)
    rnd = lambda w: torch.randn(1, 2 * T, w).bfloat16()  # noqa: E731
    q2, k2, v2, do2 = rnd(nh * 64), rnd(kh * 64), rnd(kh * 64), rnd(nh * 64)
    q0, q1, k0, k1, v0, v1, do0, do1 = (t[:, r * T:(r + 1) * T].contiguous()
                                        for t in (q2, k2, v2, do2)
                                        for r in (0, 1))

    def fwd(q, k, v, causal):
        return flash_fwd_plain(q, k, v, nh, causal, 0.125, kv_heads=kh)

    def bwd(q, k, v, o, lse, do, causal):
        return flash_bwd_plain(q, k, v, o, lse, do, nh, causal, 0.125,
                               kv_heads=kh)
    o0, l0 = fwd(q0, k0, v0, True)
    acc, lse1 = RA._merge(*RA._merge(None, None, *fwd(q1, k1, v1, True)),
                          *fwd(q1, k0, v0, False))
    out1 = acc.to(torch.bfloat16)
    hops = (bwd(q0, k0, v0, o0, l0, do0, True),
            bwd(q1, k1, v1, out1, lse1, do1, True),
            bwd(q1, k0, v0, out1, lse1, do1, False))
    want = flash_bwd_plain(q2, k2, v2, torch.cat([o0, out1], 1),
                           torch.cat([l0, lse1], 2), do2, nh, True, 0.125,
                           kv_heads=kh)
    return hops, want


@pytest.mark.parametrize("scale", [1.0, 0.0, 0.5, 0.95])
@pytest.mark.parametrize("T,kh", [(1024, 2), (2048, 1)])
def test_ring_grad_bound_passes_the_summed_hops_and_fails_a_past_hop_fault(
        T, kh, scale):
    (g0, g1, gp), want = _ring_grads(T, kh)
    got, parts = summed_hops(g0, g1, [scale * t for t in gp])
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, parts):
        bad, err, rms = grad_errors(a, b, c)
        if scale == 1.0:
            assert bad == 0, (name, bad, err, rms)
        else:       # thousands of values of the past hop's block move
            assert bad > 1000, (name, scale, bad, err, rms)


@pytest.mark.parametrize("rope,kh", [(False, 2), (True, 2), (True, 1)])
def test_bwd_term_norms_are_the_norms_of_each_sums_terms(rope, kh):
    T, nh, D, W = 12, 2, 8, 5
    sm = 1.0 / np.sqrt(D)                  # not a power of two: q^ rounds
    rng = np.random.default_rng(kh + 2 * rope)
    q, do = (torch.from_numpy(rng.standard_normal((1, T, nh * D), dtype=np.float32))
             .bfloat16() for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((1, T, kh * D), dtype=np.float32))
            .bfloat16() for _ in range(2))
    out, lse = flash_fwd_plain(q, k, v, nh, True, sm, kv_heads=kh, window=W,
                               rope=rope)
    got = bwd_term_norms(q, k, v, out, lse, do, nh, kh, True, sm, W, rope)
    qr, kr = FA._rotated(q, nh, 0, rope)[0].float(), FA._rotated(k, kh, 0, rope)[0].float()
    sq = [np.zeros((T, nh * D)), np.zeros((T, kh * D)), np.zeros((T, kh * D))]
    for h in range(nh):
        g = h // (nh // kh)
        qh, dh, oh = (t[:, h * D:(h + 1) * D] for t in (qr, do[0].float(), out[0].float()))
        kg, vg = kr[:, g * D:(g + 1) * D], v[0, :, g * D:(g + 1) * D].float()
        di = (oh * dh).sum(-1)
        for i in range(T):
            for j in range(max(0, i - W + 1), i + 1):
                s = ((qh[i] * sm).bfloat16().float() * kg[j]).sum()
                p = torch.exp(s - lse[0, h, i])
                ds = p * ((dh[i] * vg[j]).sum() - di[i]) * sm
                p, ds = p.bfloat16().float(), ds.bfloat16().float()
                for c in range(D):
                    sq[0][i, h * D + c] += float(ds * kg[j, c]) ** 2
                    sq[1][j, g * D + c] += float(ds * qh[i, c]) ** 2
                    sq[2][j, g * D + c] += float(p * dh[i, c]) ** 2
    for n in (0, 1):                     # rope: the pair (c, c + D/2)
        if rope:
            x = sq[n].reshape(T, -1, 2, D // 2)
            sq[n] = np.broadcast_to(x.sum(2, keepdims=True), x.shape).reshape(T, -1)
    for name, a, w in zip(("dq", "dk", "dv"), got, sq):
        assert a.shape == (1,) + w.shape and a.dtype == torch.float32, name
        np.testing.assert_allclose(a[0].numpy(), np.sqrt(w), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
