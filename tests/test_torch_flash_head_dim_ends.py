"""PyTorch port: the flash kernels' plain versions at the ends of the head
dims the JAX kernels tile, D <= 16 and D >= 384, against the JAX package on
the CPU, fp32, from the same numpy inputs; the port's routing rule against
the JAX package's over every head dim it tiles up to 1024; gpt-nano (2
heads of 8) through the port's flash route.

  * K1-fwd / K2 (`flash_fwd_plain`, `flash_bwd_plain`) against the Pallas
    forward and backward (`_fwd`, `_bwd_parts`) in interpret mode at D = 8
    (16 heads: one 128-lane block), D = 16 (8 heads), D = 2 and 4, D = 384
    (2 heads) and D = 512 (1 head); and gpt-nano's 2 heads of 8 against the
    Pallas kernels over the 16 heads the JAX package pads them to
    (`padded_num_heads`: 14 zero phantom heads);
  * rope + sliding window inside the kernels at D = 8 and 16;
  * K3 (`flash_gqa_fwd_plain` / `_bwd_plain`) at D = 16 against the Pallas
    GQA forward (one zero-padded kv block) and at D = 384 against the JAX
    package's expanded route (the Pallas MHA forward over expanded K/V:
    `supports_gqa` takes D <= 128 only), both backwards against jax.grad of
    dense attention over the expanded K/V;
  * K4 (`flash_prefill_qkv`) at D = 8 against the JAX kernel in interpret
    mode and at D = 384 (which the JAX kernel does not tile) against the
    JAX package's dense cache attention, with a poisoned cache tail;
  * `supports` / `supports_prefill` against `padded_num_heads`,
    `supports_gqa` and `supports_prefill` over every divisor of 128 and
    every multiple of 128 up to 1024, rope on the kernels exactly at the
    even D <= 128, where the JAX kernels' rope table exists (it asserts at
    384 and 512);
  * gpt-nano's loss and 16 gradients through the port's flash route
    against jax.value_and_grad of the JAX model, and two steps of
    train/loop.train at gpt-nano, every layer on the flash route;
  * the ops' schemas and fake versions at each new head dim, and the build
    rule: one library for every D <= 16, one per D >= 32.

Tolerances: kernel functions 2e-5 (fp32, the same rounding points, another
summation order; the JAX suite's flash tolerance), K4 1e-5; the model as
BASELINE's gpt-nano parity: loss rtol 2e-5, grads rtol 5e-4 with atol
1e-6."""

import json
import math
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitrs_tpu.config import get_config as jax_config
from vitrs_tpu.models import generate as JG
from vitrs_tpu.models import model as JM
from vitrs_tpu.ops import attention as JA
from vitrs_tpu.ops import basic as JB
from vitrs_tpu.ops import flash_attention as JFA
from vitrs_tpu.ops import flash_attention_gqa as JFG
from vitrs_tpu.ops import flash_prefill as JP
from vitrs_tpu_torch import params as TP
from vitrs_tpu_torch.config import get_config as torch_config
from vitrs_tpu_torch.models import model as TM
from vitrs_tpu_torch.ops import _build
from vitrs_tpu_torch.ops import attention as TA
from vitrs_tpu_torch.ops import flash_attention as TFA
from vitrs_tpu_torch.ops import flash_attention_gqa as TFG
from vitrs_tpu_torch.ops import flash_prefill as TFP
from vitrs_tpu_torch.train import loop as TL

from test_torch_helpers import both_params, np_params

TOL = dict(rtol=2e-5, atol=2e-5)
B = 2
NEW_DIMS = (1, 2, 4, 8, 16, 384, 512)


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _pallas(qkv, do, nh, d, T, block, causal, window=0, rope=False):
    """(out, lse, dq, dk, dv) of the Pallas kernels, interpreted."""
    scale = 1.0 / math.sqrt(d)
    x, bq, bk = JFA.prep_blocks(jnp.asarray(qkv), block, block)
    out, lse = JFA._fwd(x, nh, scale, causal, T, bq, bk, interpret=True,
                        window=window, rope=rope)
    pad = x.shape[1] - T
    do_k = jnp.pad(jnp.asarray(do), ((0, 0), (0, pad), (0, 0)))
    grads = JFA._bwd_parts(x, nh, out, lse, do_k, scale, causal, T, bq, bk,
                           True, window=window, rope=rope)
    return ([np.array(out)[:, :T], np.array(lse)[:, :, :T, 0]]
            + [np.array(g)[:, :T] for g in grads])


def _port(qkv, do, nh, d, causal, window=0, rope=False):
    C = nh * d
    q, k, v = torch.from_numpy(qkv).split(C, dim=-1)
    scale = 1.0 / math.sqrt(d)
    out, lse = TFA.flash_fwd_plain(q, k, v, nh, causal, scale, window=window,
                                   rope=rope)
    grads = TFA.flash_bwd_plain(q, k, v, out, lse, torch.from_numpy(do), nh,
                                causal, scale, window=window, rope=rope)
    return [t.numpy() for t in (out, lse, *grads)]


def _close(got, want):
    for name, g, w in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


@pytest.mark.parametrize("d,nh,T,block,causal", [
    (8, 16, 64, 64, False), (16, 8, 130, 128, True), (2, 64, 64, 64, True),
    (4, 32, 64, 64, False), (384, 2, 130, 128, True), (512, 1, 64, 64, False)])
def test_plain_matches_pallas(d, nh, T, block, causal):
    assert TA.supports(nh, d) and JFA.supports(nh, d)
    rng = _rng("mha", d, causal, T)
    qkv = rng.standard_normal((B, T, 3 * nh * d), dtype=np.float32)
    do = rng.standard_normal((B, T, nh * d), dtype=np.float32)
    _close(_port(qkv, do, nh, d, causal),
           _pallas(qkv, do, nh, d, T, block, causal))


def _phantom(x, nh, d, n_pad, parts):
    """(B, T, parts * nh * d) -> the same with each part's heads padded by
    zero heads to n_pad (the JAX package's phantom heads)."""
    z = np.zeros(x.shape[:2] + ((n_pad - nh) * d,), np.float32)
    return np.concatenate([y for p in np.split(x, parts, axis=-1)
                           for y in (p, z)], axis=-1)


def test_nano_heads_match_pallas_over_phantom_heads():
    """gpt-nano's 2 heads of 8: the port's 2-head plain versions against
    the Pallas kernels over the 16 heads the JAX package pads them to; the
    phantom heads' outputs and gradients are zeros there."""
    nh, d, T = 2, 8, 16
    n_pad = JFA.padded_num_heads(nh, d)
    assert n_pad == 16 and not JFA.supports(nh, d) and TA.supports(nh, d)
    rng = _rng("nano", d)
    qkv = rng.standard_normal((B, T, 3 * nh * d), dtype=np.float32)
    do = rng.standard_normal((B, T, nh * d), dtype=np.float32)
    want = _pallas(_phantom(qkv, nh, d, n_pad, 3), _phantom(do, nh, d, n_pad, 1),
                   n_pad, d, T, 64, True)
    got = _port(qkv, do, nh, d, True)
    C = nh * d
    for name, g, w in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        if name == "lse":
            np.testing.assert_allclose(g, w[:, :nh], err_msg=name, **TOL)
            continue
        np.testing.assert_allclose(g, w[..., :C], err_msg=name, **TOL)
        if name != "out":
            assert not w[..., C:].any(), name


@pytest.mark.parametrize("d,nh,T,block,window", [(8, 16, 64, 64, 5),
                                                 (16, 8, 130, 128, 64)])
def test_rope_window_matches_pallas(d, nh, T, block, window):
    rng = _rng("rope", d, window)
    qkv = rng.standard_normal((B, T, 3 * nh * d), dtype=np.float32)
    do = rng.standard_normal((B, T, nh * d), dtype=np.float32)
    _close(_port(qkv, do, nh, d, True, window, rope=True),
           _pallas(qkv, do, nh, d, T, block, True, window, rope=True))


def _gqa_padded(small, H, KVH, d):
    """The JAX GQA kernels' layout: k/v parts zero-padded to kvd_padded."""
    C, kvd = H * d, KVH * d
    kp = JFG.kvd_padded(KVH, d)
    if kp == kvd:
        return jnp.asarray(small)
    z = np.zeros(small.shape[:2] + (kp - kvd,), np.float32)
    q, k, v = small[..., :C], small[..., C:C + kvd], small[..., C + kvd:]
    return jnp.asarray(np.concatenate([q, k, z, v, z], axis=-1))


@pytest.mark.parametrize("d,H,KVH", [(16, 16, 2), (384, 2, 1)])
def test_gqa_matches_jax(d, H, KVH):
    """K3 at D = 16 against the Pallas GQA forward; at D = 384, which
    `supports_gqa` refuses, against the Pallas MHA forward over the
    expanded K/V (the JAX package's route there); both backwards against
    jax.grad of dense attention over the expanded K/V."""
    assert TA.supports(H, d, KVH)
    assert JFG.supports_gqa(H, KVH, d) == (d <= 128)
    T, scale, C = 96, 1.0 / math.sqrt(d), H * d
    rng = _rng("gqa", d)
    small = rng.standard_normal((B, T, (H + 2 * KVH) * d), dtype=np.float32)
    do = rng.standard_normal((B, T, C), dtype=np.float32)
    if d <= 128:
        out, lse = JFG._fwd(_gqa_padded(small, H, KVH, d), H, KVH, d, scale,
                            True, T, 128, 128, interpret=True)
    else:
        x, bq, bk = JFA.prep_blocks(JA.expand_packed(jnp.asarray(small), H,
                                                     KVH), 128, 128)
        out, lse = JFA._fwd(x, H, scale, True, T, bq, bk, interpret=True)
    q, k, v = TFG.split_gqa(torch.from_numpy(small), H, KVH)
    got, got_lse = TFG.flash_gqa_fwd_plain(q, k, v, H, KVH, True, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(out)[:, :T], **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse)[:, :, :T, 0],
                               **TOL)

    def f(s):
        o, _ = JB.attention_dense(JA.expand_packed(s, H, KVH), H, causal=True)
        return jnp.vdot(o, jnp.asarray(do))
    want = np.asarray(jax.jit(jax.grad(f))(jnp.asarray(small)))
    dq, dk, dv = TFG.flash_gqa_bwd_plain(q, k, v, got, got_lse,
                                         torch.from_numpy(do), H, KVH, True,
                                         scale)
    assert dk.shape == dv.shape == (B, T, KVH * d)
    np.testing.assert_allclose(torch.cat([dq, dk, dv], -1).numpy(), want,
                               **TOL)


@pytest.mark.parametrize("d,nh,kh", [(8, 16, 16), (384, 2, 1)])
def test_prefill_rectangle_matches_jax(d, nh, kh):
    """K4: S = 37 queries at q_offset 133 against a 256-slot cache whose
    tail past the frontier is poisoned; D = 8 against the JAX kernel in
    interpret mode, D = 384 (no JAX kernel) against its dense cache
    attention."""
    S, q_off, Tk = 37, 133, 256
    assert TFP.supports_prefill(nh, kh, d)
    assert JP.supports_prefill(nh, kh, d) == (d <= 128)
    rng = _rng("k4", d)
    q = rng.standard_normal((B, S, nh * d), dtype=np.float32)
    k, v = (rng.standard_normal((B, Tk, kh * d), dtype=np.float32)
            for _ in range(2))
    got = TFP.flash_prefill_qkv(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), nh, kh, q_off)
    if d <= 128:
        k[:, q_off + S:] = v[:, q_off + S:] = 1e9   # never read
        want = JP.flash_prefill_qkv(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), nh, kh, q_off,
                                    interpret=True)
    else:
        mask = (jnp.arange(Tk)[None, :] <= q_off + jnp.arange(S)[:, None])

        def heads(a, n):
            return jnp.asarray(a).reshape(B, -1, n, d).transpose(0, 2, 1, 3)
        want = JG._cache_attention(heads(q, nh), heads(k, kh), heads(v, kh),
                                   mask[None], jnp.float32)
        want = want.transpose(0, 2, 1, 3).reshape(B, S, nh * d)
    k[:, q_off + S:] = v[:, q_off + S:] = np.nan
    again = TFP.flash_prefill_qkv(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), nh, kh, q_off)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(again, got)


def test_routing_table_against_jax():
    """Every divisor of 128 and every multiple of 128 up to 1024: the port
    takes every (heads, D, kv heads) that the JAX package tiles (MHA with
    phantom heads, native GQA, K4); under rope exactly the even D <= 128,
    the head dims the JAX kernels' rope table takes (it asserts at 384 and
    512, where both packages compute rope densely)."""
    dims = (1, 2, 4, 8, 16, 32, 64, 128) + tuple(range(256, 1025, 128))
    assert tuple(sorted(TFA.HEAD_DIMS)) == tuple(sorted(set(dims)))
    for nh in (1, 2, 3, 4, 6, 8, 12, 16, 24, 25):
        for kh in [k for k in range(1, nh + 1) if nh % k == 0]:
            for d in dims:
                port = TA.supports(nh, d, kh)
                assert port, (nh, kh, d)
                assert JFA.padded_num_heads(nh, d) is not None, (nh, d)
                assert TFP.supports_prefill(nh, kh, d)
                if JFG.supports_gqa(nh, kh, d) or JP.supports_prefill(nh, kh, d):
                    assert port
                assert TA.supports(nh, d, kh, rope=True) == (
                    d % 2 == 0 and d <= 128), (nh, kh, d)
    assert not TA.supports(2, 1152) and JFA.padded_num_heads(2, 1152) == 2
    for d in (2, 8, 16, 128):
        JFA._rope_table(64, d, 10000.0, jnp.float32)
    for d in (384, 512):
        with pytest.raises(AssertionError):
            JFA._rope_table(64, d, 10000.0, jnp.float32)


def _nano():
    return (jax_config("gpt-nano").replace(dtype="float32").validate(),
            torch_config("gpt-nano").replace(dtype="float32").validate())


def test_nano_loss_and_grads_match_jax(monkeypatch):
    """gpt-nano (2 heads of 8) through the port's flash route (its plain
    versions on the CPU: K1-fwd and K2 once a layer) against
    jax.value_and_grad of the JAX model."""
    jcfg, tcfg = _nano()
    assert TA.supports(tcfg.num_heads, tcfg.head_size) and tcfg.use_flash
    calls = []
    plain = TFA.flash_bwd_plain
    monkeypatch.setattr(TFA, "flash_bwd_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    rng = np.random.default_rng(8)
    x = rng.integers(0, tcfg.vocab_size, (4, tcfg.max_seq_len)).astype(np.int32)
    y = rng.integers(0, tcfg.vocab_size, (4, tcfg.max_seq_len)).astype(np.int32)
    jp, _ = both_params(jcfg, tcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(JM.loss_fn), static_argnums=3)(
        jp, jnp.asarray(x), jnp.asarray(y), jcfg)
    params = {k: v.requires_grad_(True) for k, v in
              TP.from_numpy(np_params(tcfg), tcfg, "cpu").items()}
    loss = TM.loss_fn(params, torch.from_numpy(x), torch.from_numpy(y), tcfg)
    loss.backward()
    assert len(calls) == tcfg.num_layers
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-5)
    jgrads = jax.device_get(jgrads)
    assert set(jgrads) == set(params) and len(params) == 16
    for k, w in jgrads.items():
        g = params[k].grad
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(w), rtol=5e-4, atol=1e-6,
                                   err_msg=k)


def test_nano_train_loop(tmp_path, monkeypatch):
    """Two steps of train/loop.train at gpt-nano: finite losses, every
    layer's attention on the flash route."""
    calls = []
    plain = TFA.flash_fwd_plain
    monkeypatch.setattr(TFA, "flash_fwd_plain",
                        lambda *a, **k: calls.append(a[3]) or plain(*a, **k))
    tc = TL.TrainConfig(preset="gpt-nano", steps=2, batch_size=4,
                        device="cpu", dataset="", dtype="float32",
                        log_every=1, workdir=str(tmp_path))
    summary = TL.train(tc)
    losses = [json.loads(line)["loss"]
              for line in open(tmp_path / "metrics.jsonl")]
    assert len(losses) == 2 and np.isfinite(losses).all(), summary
    assert np.isfinite(summary["final_loss"])
    assert len(calls) >= 2 * 2 and set(calls) == {2}   # 2 layers, 2 steps


@pytest.mark.parametrize("d", NEW_DIMS)
def test_ops_trace_at_the_head_dim(d):
    """The `vitrs::` ops' schemas and fake versions carry the head dim
    (torch.library.opcheck against the plain versions)."""
    nh, kh, T = 2, 1, 9
    rng = _rng("ops", d)
    q, do = (torch.from_numpy(rng.standard_normal((B, T, nh * d),
                                                  dtype=np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, T, kh * d),
                                                 dtype=np.float32))
            for _ in range(2))
    s = 1.0 / math.sqrt(d)
    rope = d % 2 == 0 and d <= 128
    out, lse = TFG.flash_gqa_fwd_plain(q, k, v, nh, kh, True, s, rope=rope)
    checks = ("test_schema", "test_faketensor")
    for op, args in ((TFG.flash_gqa_fwd_op, (q, k, v, nh, kh, True, s, 0,
                                             rope)),
                     (TFG.flash_gqa_bwd_op, (q, k, v, out, lse, do, nh, kh,
                                             True, s, 0, rope))):
        assert torch.library.opcheck(op, args, test_utils=checks) == {
            c: "SUCCESS" for c in checks}


@pytest.mark.parametrize("d", NEW_DIMS)
def test_build_key_at_the_head_dim(d):
    """Every D <= 16 loads the D = 16 library (one build; the kernels read
    the true D at run time), every D >= 32 its own: the define enters the
    library's hash and name."""
    built = TFA.build_dim(d)
    assert built == (16 if d <= 16 else d)
    src = _build.CSRC_DIR + "/flash_bwd.cu"
    others = {TFA.build_dim(x) for x in TFA.HEAD_DIMS} - {built}
    mine = _build._digest(src, _build.flags_for(built))
    assert mine not in {_build._digest(src, _build.flags_for(x))
                        for x in others}
    assert f"-DVITRS_HEAD_DIM={built}" in _build.flags_for(built)
