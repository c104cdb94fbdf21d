"""PyTorch port: rotary embeddings and sliding-window attention against the
JAX package on the CPU, fp32, from the same numpy inputs.

  * `apply_rope` / `rope_qk` against vitrs_tpu/ops/rope.py for every
    position form (scalar, (T,), (B, 1), (B, T)) and inverse=True; the
    kernels' compact table (`rope_table` + `rotate`) against `apply_rope`;
  * attention with window in {1, 3, 8, >= T} and rope on and off, MHA,
    kv=2 and MQA, T=37 (no multiple of 64): the flash route (the plain
    versions of K1/K2 and K3, D=64) and the dense route (D=16), forward and
    gradient, against the JAX `attention` / `attention_gqa` on the CPU (its
    dense + `rope_qk` path);
  * K4's plain version with a window against the JAX dense cache path;
  * the model: loss and all 16 gradients with rope + window, against
    jax.value_and_grad(loss_fn), on both routes; wpe's gradient is exactly 0
    in both packages;
  * generation: greedy `generate` (whole and chunked) and
    `generate_streaming` against JAX and against each other, and the engine
    against per-request `generate`;
  * the trainer CLI with --pos-emb rope --window 4.

Tolerances: outputs and logits 1e-5, loss rtol 2e-5, grads rtol 5e-4 with
atol 1e-6 (ROADMAP.md's CPU parity tolerances; attention grads atol 1e-5,
see the test); greedy tokens equal."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitrs_tpu.models import generate as JG
from vitrs_tpu.models import model as JM
from vitrs_tpu.ops import attention as JA
from vitrs_tpu.ops import rope as JR
from vitrs_tpu_torch import params as TP
from vitrs_tpu_torch.cli import train as cli
from vitrs_tpu_torch.models import generate as TG
from vitrs_tpu_torch.models import model as TM
from vitrs_tpu_torch.ops import attention as TA
from vitrs_tpu_torch.ops import flash_attention as TFA
from vitrs_tpu_torch.ops import flash_attention_gqa as TFG
from vitrs_tpu_torch.ops import flash_prefill as TFP
from vitrs_tpu_torch.ops import rope as TR
from vitrs_tpu_torch.serving_gen import GenerationEngine

from test_torch_helpers import both_params, np_params, small_cfgs

B, T, NH = 2, 37, 4


def _close(got, want, rtol=1e-5, atol=1e-5, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=msg)


@pytest.mark.parametrize("form", ["scalar", "seq", "start", "full"])
@pytest.mark.parametrize("inverse", [False, True])
def test_apply_rope_matches_jax(form, inverse):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, 5, 3 * 16), dtype=np.float32)
    pos = {"scalar": np.int32(7), "seq": np.arange(5) + 3,
           "start": np.array([[2], [9]]),
           "full": rng.integers(0, 100, (B, 5))}[form]
    got = TR.apply_rope(torch.from_numpy(x), torch.as_tensor(pos), 3,
                        inverse=inverse)
    want = JR.apply_rope(jnp.asarray(x), jnp.asarray(pos), 3, inverse=inverse)
    _close(got, want, rtol=1e-6, atol=1e-6)
    if inverse:        # R(-theta) undoes R(theta)
        back = TR.apply_rope(got, torch.as_tensor(pos), 3)
        _close(back, x, rtol=1e-5, atol=1e-5)


def test_rope_qk_at_kv_width_and_the_kernels_table():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, 6, 4 * 64), dtype=np.float32)
    k = rng.standard_normal((B, 6, 64), dtype=np.float32)
    pos = np.arange(6) + 100
    tq, tk = TR.rope_qk(torch.from_numpy(q), torch.from_numpy(k),
                        torch.as_tensor(pos), 4, 1)
    jq, jk = JR.rope_qk(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos), 4, 1)
    _close(tq, jq, rtol=1e-6, atol=1e-6)
    _close(tk, jk, rtol=1e-6, atol=1e-6)
    cos, sin = TR.rope_table(256, 64, "cpu")
    assert cos.shape == sin.shape == (256, 32) and cos.dtype == torch.float32
    assert TR.rope_table(256, 64, "cpu")[0] is cos        # cached
    rot = TR.rotate(torch.from_numpy(k), cos[100:106], sin[100:106], 1)
    _close(rot, jk, rtol=1e-6, atol=1e-6)
    back = TR.rotate(rot, cos[100:106], sin[100:106], 1, inverse=True)
    _close(back, k, rtol=1e-5, atol=1e-5)


def _jax_attention(qkv, kv, window, rope):
    """The JAX package's attention on the CPU (dense, explicit rope_qk)."""
    if kv == NH:
        return JA.attention(qkv, NH, causal=True, window=window, rope=rope)
    if rope:
        q, k, v = JA.split_gqa(qkv, NH, kv)
        q, k = JR.rope_qk(q, k, jnp.arange(qkv.shape[1]), NH, kv)
        qkv = jnp.concatenate([q, k, v], axis=-1)
    return JA.attention_gqa(qkv, NH, kv, causal=True, window=window)


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("window", [1, 3, 8, 40])
@pytest.mark.parametrize("kv", [NH, 2, 1])
@pytest.mark.parametrize("route", ["flash", "dense"])
def test_attention_matches_jax(route, kv, window, rope, monkeypatch):
    # the dense route: asked for (use_flash=False) at D = 16, which the
    # kernels take too since they tile every divisor of 128
    D = 64 if route == "flash" else 16
    assert TA.supports(NH, D)
    calls = []
    for mod, name in ((TFA, "flash_bwd_plain"), (TFG, "flash_gqa_bwd_plain")):
        plain = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=plain, **k:
                            calls.append(1) or _f(*a, **k))
    rng = np.random.default_rng(window + 10 * kv + rope)
    qkv = rng.standard_normal((B, T, (NH + 2 * kv) * D), dtype=np.float32)
    dout = rng.standard_normal((B, T, NH * D), dtype=np.float32)
    x = torch.from_numpy(qkv).requires_grad_(True)
    got = TA.attention_gqa(x, NH, kv, causal=True, window=window, rope=rope,
                           use_flash=route == "flash")
    got.backward(torch.from_numpy(dout))
    assert len(calls) == (route == "flash")

    def f(a):
        return jnp.sum(_jax_attention(a, kv, window, rope) * dout)
    want = _jax_attention(jnp.asarray(qkv), kv, window, rope)
    _close(got, want)
    # atol 1e-5: at window=1 dq and dk are exactly 0 (ds = p (dp - di) with
    # p = 1 and dp = di), and both sides hold fp32 noise there, since dp and
    # di sum the same products in other orders
    _close(x.grad, jax.grad(f)(jnp.asarray(qkv)), rtol=5e-4, atol=1e-5)
    if window == 1:        # each query sees only itself: out is its own v
        v = qkv[..., (NH + kv) * D:].reshape(B, T, kv, 1, D)
        v = np.broadcast_to(v, (B, T, kv, NH // kv, D)).reshape(B, T, NH * D)
        _close(got, v, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("window", [1, 5, 64, 100])
@pytest.mark.parametrize("nh,kh", [(4, 4), (4, 2), (4, 1)])
def test_prefill_plain_window_matches_jax_cache_path(nh, kh, window):
    rng = np.random.default_rng(window + kh)
    S, q_off, Tk, D = 40, 70, 256, 64
    q = rng.standard_normal((B, S, nh * D), dtype=np.float32)
    k = rng.standard_normal((B, Tk, kh * D), dtype=np.float32)
    v = rng.standard_normal((B, Tk, kh * D), dtype=np.float32)
    got = TFP.flash_prefill_qkv(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), nh, kh, q_off,
                                window=window)
    qp = q_off + jnp.arange(S)[:, None]
    tp = jnp.arange(Tk)[None, :]
    mask = (tp <= qp) & (tp > qp - window)

    def heads(a, n):
        return jnp.asarray(a).reshape(B, -1, n, D).transpose(0, 2, 1, 3)
    want = JG._cache_attention(heads(q, nh), heads(k, kh), heads(v, kh),
                               mask[None], jnp.float32)
    _close(got, want.transpose(0, 2, 1, 3).reshape(B, S, nh * D))


MODEL_CASES = {
    # gpt-nano (D=8): the flash route's plain versions (K1-fwd / K2, K3
    # under MQA), rotating at D = 8 as the kernels do
    "nano-mha": ("nano", 0), "nano-mqa": ("nano", 1),
    # D=64: the fused projection + flash route (K1/K2, K3 plain versions)
    "flash-mha": ("small", 0), "flash-kv2": ("small", 2),
}


def _model_cfgs(case, **kw):
    size, kv = MODEL_CASES[case]
    if size == "nano":
        from vitrs_tpu.config import get_config as jcfg
        from vitrs_tpu_torch.config import get_config as tcfg
        cfgs = (jcfg("gpt-nano"), tcfg("gpt-nano"))
    else:
        cfgs = small_cfgs(num_heads=4, channels=256)
    return tuple(c.replace(pos_emb="rope", window=4, num_kv_heads=kv, **kw)
                 .validate() for c in cfgs)


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_model_loss_and_grads_match_jax(case):
    jcfg, tcfg = _model_cfgs(case)
    Tm = tcfg.max_seq_len
    rng = np.random.default_rng(3)
    x = rng.integers(0, tcfg.vocab_size, (B, Tm)).astype(np.int32)
    y = rng.integers(0, tcfg.vocab_size, (B, Tm)).astype(np.int32)
    jp, _ = both_params(jcfg, tcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(JM.loss_fn), static_argnums=3)(
        jp, jnp.asarray(x), jnp.asarray(y), jcfg)
    params = {k: v.requires_grad_(True) for k, v in
              TP.from_numpy(np_params(tcfg), tcfg, "cpu").items()}
    loss = TM.loss_fn(params, torch.from_numpy(x), torch.from_numpy(y), tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-5)
    jgrads = jax.device_get(jgrads)
    assert set(jgrads) == set(params) and len(params) == 16
    # wpe is not read under rope: no gradient reaches it here (None), and
    # JAX's is all zeros
    assert params["wpe"].grad is None and not np.asarray(jgrads["wpe"]).any()
    # qkvb too at 1e-6: under rope the K third of its gradient is not 0
    # (q_i . R(j - i) b depends on j), so it is held like any other grad
    for k, w in jgrads.items():
        if k != "wpe":
            _close(params[k].grad, w, rtol=5e-4, atol=1e-6, msg=k)
    # the five-call API and the trainer's flat arena hand it exact zeros
    from vitrs_tpu_torch.vit import ViT
    m = ViT(tcfg, TP.from_numpy(np_params(tcfg), tcfg, "cpu"))
    m.forward(x, y)
    grads = m.backward()
    assert not grads["wpe"].any()
    np.testing.assert_allclose(m.mean_loss, float(jloss), rtol=2e-5)


def _gen_case(kv, seed=4):
    jcfg, tcfg = (c.replace(pos_emb="rope", window=8, num_kv_heads=kv)
                  .validate() for c in small_cfgs(num_heads=4, channels=256))
    jp, tp = both_params(jcfg, tcfg, seed=seed)
    prompt = np.random.default_rng(seed).integers(0, 97, (2, 48))
    return jcfg, tcfg, jp, TM.prepare_params(tp, tcfg), prompt


@pytest.mark.parametrize("kv", [0, 2, 1])
def test_generate_matches_jax_whole_and_chunked(kv, monkeypatch):
    jcfg, tcfg, jp, tp, prompt = _gen_case(kv)
    windows = []
    plain = TFP.flash_prefill_plain
    monkeypatch.setattr(TFP, "flash_prefill_plain",
                        lambda *a: windows.append(a[7]) or plain(*a))
    whole = TG.generate(tp, torch.as_tensor(prompt), tcfg, max_new=8,
                        temperature=0.0)
    chunked = TG.generate(tp, torch.as_tensor(prompt), tcfg, max_new=8,
                          temperature=0.0, prefill_chunk=16)
    assert windows == [8] * 4      # chunks at 16 and 32, two layers, K4 band
    want = JG.generate(jp, jnp.asarray(prompt), jcfg, 8, jax.random.PRNGKey(0),
                       temperature=0.0)
    np.testing.assert_array_equal(whole.numpy(), np.asarray(want))
    np.testing.assert_array_equal(chunked.numpy(), whole.numpy())


@pytest.mark.parametrize("kv", [0, 1])
def test_generate_streaming_matches_jax_and_dense_cache(kv):
    jcfg, tcfg, jp, tp, prompt = _gen_case(kv, seed=5)
    prompt = prompt[:, :20]           # ring chunks of 8, 8 and 4
    got = TG.generate_streaming(tp, torch.as_tensor(prompt), tcfg, max_new=12,
                                temperature=0.0)
    want = JG.generate_streaming(jp, jnp.asarray(prompt), jcfg, 12,
                                 jax.random.PRNGKey(0), temperature=0.0)
    dense = TG.generate(tp, torch.as_tensor(prompt), tcfg, max_new=12,
                        temperature=0.0)
    assert got.shape == (2, 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), dense.numpy())
    # rope positions: the ring runs past max_seq_len (64), the dense cache
    # cannot
    long = TG.generate_streaming(tp, torch.as_tensor(prompt), tcfg,
                                 max_new=50, temperature=0.0)
    assert long.shape == (2, 70)
    np.testing.assert_array_equal(long[:, :32].numpy(), got.numpy())
    ring = TG.init_ring_kv(tcfg, 2, 16, device="cpu")
    assert ring[0].shape == (2, 2, 8 + 16, tcfg.kv_dim)


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("kv", [0, 1])
def test_engine_matches_per_request_generate(kv, chunk):
    """Slots at different depths decode together, each rotated at its own
    position and masked to its own window; prefill is right-padded to a
    bucket."""
    jcfg, tcfg, _, tp, _ = _gen_case(kv, seed=6)
    _, raw = both_params(jcfg, tcfg, seed=6)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 97, n) for n in (5, 9, 30, 17)]
    news = (6, 4, 9, 5)
    eng = GenerationEngine(raw, tcfg, max_slots=2, max_len=48,
                           prompt_buckets=(16, 32), decode_chunk=chunk)
    for pr, n in zip(prompts, news):
        eng.submit(pr, max_new=n)
    outs = dict(eng.run())
    for rid, (pr, n) in enumerate(zip(prompts, news)):
        one = TG.generate(tp, torch.as_tensor(pr)[None], tcfg, max_new=n,
                          temperature=0.0)[0]
        np.testing.assert_array_equal(outs[rid], one.numpy())


def test_trainer_cli_trains_rope_window(tmp_path):
    work = str(tmp_path / "rw")
    cli.main(["--preset", "gpt-nano", "--pos-emb", "rope", "--window", "4",
              "--cpu", "--steps", "3", "--batch-size", "8", "--lr", "1e-2",
              "--warmup", "1", "--dtype", "float32", "--dataset", "",
              "--log-every", "1", "--workdir", work])
    losses = [json.loads(line)["loss"] for line in open(f"{work}/metrics.jsonl")]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    from vitrs_tpu_torch import checkpoint as TC
    last = sorted((tmp_path / "rw").glob("ckpt_*.bin"))[-1]
    cfg = TC.load_checkpoint(str(last))[1]
    assert (cfg.pos_emb, cfg.window) == ("rope", 4)
