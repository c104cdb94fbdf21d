"""PyTorch port: the flash kernels' plain versions at head dims 32, 128 and
256 against the JAX package on the CPU, fp32, from the same numpy inputs,
and the port's routing rule against the JAX package's.

  * K1-fwd / K2 (`flash_fwd_plain`, `flash_bwd_plain`) against the Pallas
    forward and backward (`_fwd`, `_bwd_parts`) in interpret mode, causal
    and full, one tile (T=64) and several (T=200, 128-wide blocks, ragged),
    at D = 32 (4 heads: the JAX kernel tiles 4 heads of 32 a lane block),
    128 (2 heads) and 256 (1 head);
  * rope + sliding window inside the kernels at D = 32 and 128 (the pairs
    (c, c + D/2), the (T, D/2) table) against the Pallas kernels with
    `rope=True, window=W`;
  * K3 (`flash_gqa_fwd_plain`) against the Pallas GQA forward at D = 32
    (8 heads, 2 kv heads: one zero-padded kv block) and 128 (4 heads, 2 kv
    heads), and its backward against jax.vjp of dense attention over the
    expanded K/V, the oracle the JAX suite holds its GQA kernels to;
  * K4 (`flash_prefill_qkv`) against the JAX kernel in interpret mode at
    D = 32 and 128, with a poisoned cache tail;
  * `supports` / `supports_prefill` against `padded_num_heads`,
    `supports_gqa` and `supports_prefill` over a table of geometries, with
    rope at D >= 256 dense in the port (the JAX kernels assert there:
    `_rope_table`);
  * a 2-layer model at C = 256 with 2, 8 and 1 heads (D = 128, 32, 256):
    loss and all 16 gradients against jax.value_and_grad of the JAX model
    (whose CPU route is dense attention), and two steps of
    train/loop.train with `model_overrides` through the flash route;
  * the ops' schemas and fake versions at each head dim, and torch.export
    of a D = 128 model (`serving.export_forward`);
  * the build rule: one library key per built head dim for the flash
    sources (`_build.load` refuses a flash source without a head dim).

Tolerances: kernel functions 2e-5 (fp32, the same rounding points, another
summation order; the JAX suite's flash tolerance), the GQA backward
against the dense oracle 2e-5, K4 1e-5; the model as BASELINE's gpt-nano
parity: loss rtol 2e-5, grads rtol 5e-4 with atol 1e-6."""

import json
import math
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitrs_tpu.models import model as JM
from vitrs_tpu.ops import attention as JA
from vitrs_tpu.ops import basic as JB
from vitrs_tpu.ops import flash_attention as JFA
from vitrs_tpu.ops import flash_attention_gqa as JFG
from vitrs_tpu.ops import flash_prefill as JP
from vitrs_tpu_torch import params as TP
from vitrs_tpu_torch.models import model as TM
from vitrs_tpu_torch.ops import attention as TA
from vitrs_tpu_torch.ops import flash_attention as TFA
from vitrs_tpu_torch.ops import flash_attention_gqa as TFG
from vitrs_tpu_torch.ops import flash_prefill as TFP
from vitrs_tpu_torch.train import loop as TL

from test_torch_helpers import both_params, np_params, small_cfgs

TOL = dict(rtol=2e-5, atol=2e-5)
B = 2
HEADS = {32: 4, 128: 2, 256: 1}   # per head dim: the fewest the JAX kernel tiles


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


@pytest.mark.parametrize("T,block", [(64, 64), (200, 128)],
                         ids=["one_tile", "multi_tile"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 128, 256])
def test_plain_matches_pallas(d, causal, T, block):
    nh = HEADS[d]
    rng = _rng("mha", d, causal, T)
    qkv = rng.standard_normal((B, T, 3 * nh * d), dtype=np.float32)
    do = rng.standard_normal((B, T, nh * d), dtype=np.float32)
    want = _pallas(qkv, do, nh, d, T, block, causal)
    got = _port(qkv, do, nh, d, causal)
    for name, g, w in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


@pytest.mark.parametrize("window", [5, 64])
@pytest.mark.parametrize("d", [32, 128])
def test_rope_window_matches_pallas(d, window):
    nh, T = HEADS[d], 200
    rng = _rng("rope", d, window)
    qkv = rng.standard_normal((B, T, 3 * nh * d), dtype=np.float32)
    do = rng.standard_normal((B, T, nh * d), dtype=np.float32)
    want = _pallas(qkv, do, nh, d, T, 128, True, window, rope=True)
    got = _port(qkv, do, nh, d, True, window, rope=True)
    for name, g, w in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


def _gqa_padded(small, H, KVH, d):
    """The JAX GQA kernels' layout: k/v parts zero-padded to kvd_padded."""
    C, kvd = H * d, KVH * d
    kp = JFG.kvd_padded(KVH, d)
    if kp == kvd:
        return jnp.asarray(small)
    z = np.zeros(small.shape[:2] + (kp - kvd,), np.float32)
    q, k, v = small[..., :C], small[..., C:C + kvd], small[..., C + kvd:]
    return jnp.asarray(np.concatenate([q, k, z, v, z], axis=-1))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,H,KVH", [(32, 8, 2), (128, 4, 2)])
def test_gqa_matches_pallas_and_dense_vjp(d, H, KVH, causal):
    assert JFG.supports_gqa(H, KVH, d) and TA.supports(H, d, KVH)
    T, scale, C = 96, 1.0 / math.sqrt(d), H * d
    rng = _rng("gqa", d, causal)
    small = rng.standard_normal((B, T, (H + 2 * KVH) * d), dtype=np.float32)
    do = rng.standard_normal((B, T, C), dtype=np.float32)
    out, lse = JFG._fwd(_gqa_padded(small, H, KVH, d), H, KVH, d, scale,
                        causal, T, 128, 128, interpret=True)
    q, k, v = TFG.split_gqa(torch.from_numpy(small), H, KVH)
    got, got_lse = TFG.flash_gqa_fwd_plain(q, k, v, H, KVH, causal, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(out)[:, :T], **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse)[:, :, :T, 0],
                               **TOL)

    def f(s):
        o, _ = JB.attention_dense(JA.expand_packed(s, H, KVH), H,
                                  causal=causal)
        return jnp.vdot(o, jnp.asarray(do))
    want = np.asarray(jax.jit(jax.grad(f))(jnp.asarray(small)))
    dq, dk, dv = TFG.flash_gqa_bwd_plain(q, k, v, got, got_lse,
                                         torch.from_numpy(do), H, KVH,
                                         causal, scale)
    assert dk.shape == dv.shape == (B, T, KVH * d)
    np.testing.assert_allclose(torch.cat([dq, dk, dv], -1).numpy(), want,
                               **TOL)


@pytest.mark.parametrize("s,q_off", [(64, 0), (200, 133)])
@pytest.mark.parametrize("d,nh,kh", [(32, 8, 8), (32, 8, 4), (128, 4, 2)])
def test_prefill_rectangle_matches_pallas(d, nh, kh, s, q_off):
    assert JP.supports_prefill(nh, kh, d) and TFP.supports_prefill(nh, kh, d)
    rng = _rng("k4", d, nh, kh, s)
    q = rng.standard_normal((B, s, nh * d), dtype=np.float32)
    k, v = (rng.standard_normal((B, 512, kh * d), dtype=np.float32)
            for _ in range(2))
    k[:, q_off + s:] = v[:, q_off + s:] = 1e9   # past the frontier: never read
    want = JP.flash_prefill_qkv(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), nh, kh, q_off, interpret=True)
    got = TFP.flash_prefill_qkv(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), nh, kh, q_off)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_routing_table_against_jax():
    """The port's kernels take every geometry that the JAX package tiles
    (MHA with phantom heads, native GQA, K4) at D = 8 to 384, D <= 16 and
    D = 384 included; rope at D >= 256 only on the dense route, as the JAX
    package computes it on the CPU (its kernels' table asserts there).
    The full table, every divisor of 128 and every multiple of 128 up to
    1024, is tests/test_torch_flash_head_dim_ends.py's."""
    for nh in (1, 2, 3, 4, 6, 8, 12, 16, 24, 25):
        for kh in [k for k in range(1, nh + 1) if nh % k == 0]:
            for d in (8, 16, 32, 64, 128, 256, 384):
                port = TA.supports(nh, d, kh)
                assert port, (nh, kh, d)
                assert TFP.supports_prefill(nh, kh, d) == port
                assert TA.supports(nh, d, kh, rope=True) == (d <= 128), \
                    (nh, kh, d)
                assert JFA.padded_num_heads(nh, d) is not None
                if kh != nh and JFG.supports_gqa(nh, kh, d):
                    assert port
                if JP.supports_prefill(nh, kh, d):
                    assert port
    assert JFA.padded_num_heads(2, 8) == 16       # gpt-nano: phantom heads
    assert JFA.padded_num_heads(2, 384) == 2
    assert JFG.supports_gqa(6, 2, 128) and JFG.supports_gqa(8, 4, 32)
    assert JP.supports_prefill(6, 2, 128) and JP.supports_prefill(24, 8, 32)
    assert not JFG.supports_gqa(4, 2, 256)
    assert not JP.supports_prefill(3, 3, 256)
    with pytest.raises(AssertionError):
        JFA._rope_table(64, 256, 10000.0, jnp.float32)


@pytest.mark.parametrize("nh", [2, 8, 1], ids=["d128", "d32", "d256"])
@pytest.mark.parametrize("rope", [False, True])
def test_model_loss_and_grads_match_jax(nh, rope, monkeypatch):
    """C = 256, 2 layers: the port's flash route (plain versions on the
    CPU; rope at D = 256 dense) against the JAX model's dense route."""
    over = dict(num_heads=nh, channels=256)
    if rope:
        over.update(pos_emb="rope", window=16)
    jcfg, tcfg = (c.validate() for c in small_cfgs(**over))
    d = tcfg.channels // tcfg.num_heads
    flash = TA.supports(nh, d, rope=rope)
    assert flash == (not rope or d != 256)
    calls = []
    plain = TFA.flash_bwd_plain
    monkeypatch.setattr(TFA, "flash_bwd_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    rng = np.random.default_rng(nh)
    x = rng.integers(0, tcfg.vocab_size, (B, 48)).astype(np.int32)
    y = rng.integers(0, tcfg.vocab_size, (B, 48)).astype(np.int32)
    jp, _ = both_params(jcfg, tcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(JM.loss_fn), static_argnums=3)(
        jp, jnp.asarray(x), jnp.asarray(y), jcfg)
    params = {k: v.requires_grad_(True) for k, v in
              TP.from_numpy(np_params(tcfg), tcfg, "cpu").items()}
    loss = TM.loss_fn(params, torch.from_numpy(x), torch.from_numpy(y), tcfg)
    loss.backward()
    assert len(calls) == (tcfg.num_layers if flash else 0)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-5)
    for k, w in jax.device_get(jgrads).items():
        g = params[k].grad
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(w), rtol=5e-4, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("nh", [2, 8, 1], ids=["d128", "d32", "d256"])
def test_train_loop_with_model_overrides(nh, tmp_path, monkeypatch):
    """Two steps of train/loop.train at another head dim, the way a user
    asks for one (`model_overrides`): finite losses, every layer's
    attention on the flash route."""
    calls = []
    plain = TFA.flash_fwd_plain
    monkeypatch.setattr(TFA, "flash_fwd_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    tc = TL.TrainConfig(preset="gpt-nano", steps=2, batch_size=4,
                        device="cpu", dataset="", dtype="float32",
                        log_every=1, workdir=str(tmp_path),
                        model_overrides=dict(num_layers=2, channels=256,
                                             num_heads=nh, max_seq_len=32))
    summary = TL.train(tc)
    losses = [json.loads(line)["loss"]
              for line in open(tmp_path / "metrics.jsonl")]
    assert len(losses) == 2 and np.isfinite(losses).all(), summary
    assert np.isfinite(summary["final_loss"])
    assert len(calls) >= 2 * 2      # two layers, two steps


@pytest.mark.parametrize("d", [32, 128, 256])
def test_ops_trace_at_the_head_dim(d):
    """The `vitrs::` ops' schemas and fake versions carry any head dim
    (torch.library.opcheck against the plain versions)."""
    nh, kh, T = HEADS[d], 1, 9
    rng = _rng("ops", d)
    q, do = (torch.from_numpy(rng.standard_normal((B, T, nh * d),
                                                  dtype=np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, T, kh * d),
                                                 dtype=np.float32))
            for _ in range(2))
    s = 1.0 / math.sqrt(d)
    out, lse = TFG.flash_gqa_fwd_plain(q, k, v, nh, kh, True, s)
    checks = ("test_schema", "test_faketensor")
    for op, args in ((TFG.flash_gqa_fwd_op, (q, k, v, nh, kh, True, s, 0,
                                             False)),
                     (TFG.flash_gqa_bwd_op, (q, k, v, out, lse, do, nh, kh,
                                             True, s, 0, False))):
        assert torch.library.opcheck(op, args, test_utils=checks) == {
            c: "SUCCESS" for c in checks}


def test_export_at_head_dim_128(tmp_path):
    """torch.export of a model with heads of 128: one K1-fwd op a layer in
    the graph, logits equal to the eager forward's bit for bit."""
    from vitrs_tpu_torch import serving as TS
    _, tcfg = small_cfgs(num_heads=2, channels=256, dtype="float32")
    params = TP.from_numpy(np_params(tcfg, seed=4), tcfg, "cpu")
    path = str(tmp_path / "d128.vitrs")
    TS.export_forward(params, tcfg, 2, path)
    served = TS.ServedModel(path)
    targets = [n.target for n in served._module.graph.nodes
               if n.op == "call_function"]
    assert targets.count(torch.ops.vitrs.flash_fwd.default) == \
        tcfg.num_layers
    tok = np.random.default_rng(4).integers(0, tcfg.vocab_size,
                                            (2, tcfg.max_seq_len))
    want = TM.gpt_forward(TM.prepare_params(params, tcfg),
                          torch.as_tensor(tok).long(), tcfg)
    torch.testing.assert_close(served(tok), want, rtol=0, atol=0)


@pytest.mark.parametrize("name,head_dim", [
    ("flash_fwd", None), ("flash_bwd", None), ("fused_ce", 64),
    ("fused_adamw", 128)])
def test_build_key_is_one_per_head_dim(name, head_dim):
    """A flash source builds only for a named head dim, and any other
    source for none: the refusal comes before nvcc is looked for, and each
    built head dim's flags (the define) enter the library's hash: one
    library per head dim, the D = 16 one serving every D <= 16."""
    from vitrs_tpu_torch.ops import _build
    with pytest.raises(ValueError, match="head_dim"):
        _build.load(name, head_dim)
    src = _build.CSRC_DIR + "/flash_fwd.cu"
    built = {TFA.build_dim(d) for d in TFA.HEAD_DIMS}
    digests = {_build._digest(src, _build.flags_for(d)) for d in built}
    assert len(digests) == len(built) == len(TFA.HEAD_DIMS) - 4
    assert _build.flags_for(None) == _build.NVCC_FLAGS
