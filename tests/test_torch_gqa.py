"""PyTorch port: the GQA model end to end against the JAX package on the
CPU, fp32, from the same numpy parameters and tokens.

The config: L=2, NH=4, KH=2, C=256 (D=64, so attention takes the flash
route: K3's and K4's plain versions here), T=64, vocab 97; and gpt-nano
with one kv head (D=8: the dense route with the expanded weight).

  * loss and all 16 gradients against jax.value_and_grad(loss_fn) on both
    routes, and one `make_dp_train_step` step against the JAX step;
  * chunked `generate(prefill_chunk=...)` against JAX's and against the
    port's whole-prompt prefill, at kv=2, MHA and MQA (continuation chunks
    through K4's plain version; the JAX package takes MQA's through dense
    cache attention), and the prefill's last-position logits;
  * the divisibility rule of chunked prefill;
  * GenerationEngine at kv=2 against the JAX engine;
  * kv=2 checkpoints in both directions, `params.from_numpy` of JAX
    weights, the GQA helpers of ops/attention.py, and the trainer's
    model overrides.

Tolerances: loss rtol 2e-5, grads rtol 5e-4 with atol 1e-6 (ROADMAP.md's
CPU parity tolerances), qkvb atol 2e-4 (its K part's gradient is exactly 0
in both packages, which hold fp32 noise there: ROADMAP.md Queue 3 #4);
prefill logits 1e-5, between the port's own routes and against the JAX
package (fp32, other summation orders); greedy tokens equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitrs_tpu.models import generate as JG
from vitrs_tpu.models import model as JM
from vitrs_tpu.ops import attention as JA
from vitrs_tpu.parallel import data_parallel as JDP
from vitrs_tpu.serving_gen import GenerationEngine as JaxEngine
from vitrs_tpu.vit import ViT as JaxViT
from vitrs_tpu_torch import params as TP
from vitrs_tpu_torch.models import generate as TG
from vitrs_tpu_torch.models import model as TM
from vitrs_tpu_torch.ops import attention as TA
from vitrs_tpu_torch.ops import flash_attention_gqa as TFG
from vitrs_tpu_torch.ops import flash_prefill as TFP
from vitrs_tpu_torch.parallel import data_parallel as TDP
from vitrs_tpu_torch.serving_gen import GenerationEngine
from vitrs_tpu_torch.train import loop as TL
from vitrs_tpu_torch.vit import ViT

from test_torch_helpers import both_params, np_params, small_cfgs

B, T, V = 2, 64, 97
GQA = dict(num_heads=4, num_kv_heads=2, channels=256)
JCFG, TCFG = small_cfgs(**GQA)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, (B, T)).astype(np.int32),
            rng.integers(0, V, (B, T)).astype(np.int32))


def _assert_grads(got, want):
    for k, w in want.items():
        atol = 2e-4 if k == "qkvb" else 1e-6
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(w),
                                   rtol=5e-4, atol=atol, err_msg=k)


@pytest.mark.parametrize("route", ["flash", "dense"])
def test_loss_and_all_grads_match_jax(route, monkeypatch):
    if route == "flash":
        jcfg, tcfg = JCFG, TCFG
    else:       # gpt-nano's D=8 with use_flash off: expanded weight
        jcfg, tcfg = (c.replace(num_kv_heads=1, max_seq_len=T)
                      for c in small_cfgs())
        jcfg, tcfg = (c.replace(num_heads=2, channels=16, use_flash=False)
                      for c in (jcfg, tcfg))
    calls = []
    bwd = TFG.flash_gqa_bwd_plain
    monkeypatch.setattr(TFG, "flash_gqa_bwd_plain",
                        lambda *a: calls.append(1) or bwd(*a))
    jp, _ = both_params(jcfg, tcfg)
    x, y = _batch(0)
    jloss, jgrads = jax.jit(jax.value_and_grad(JM.loss_fn), static_argnums=3)(
        jp, jnp.asarray(x), jnp.asarray(y), jcfg)
    params = {k: v.requires_grad_(True)
              for k, v in TP.from_numpy(np_params(tcfg), tcfg, "cpu").items()}
    assert params["qkvw"].shape == (2, tcfg.qkv_dim, tcfg.channels)
    loss = TM.loss_fn(params, torch.from_numpy(x), torch.from_numpy(y), tcfg)
    loss.backward()
    assert len(calls) == (tcfg.num_layers if route == "flash" else 0)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-5)
    assert set(params) == set(jgrads) and len(params) == 16
    _assert_grads({k: p.grad for k, p in params.items()},
                  jax.device_get(jgrads))


def test_dp_step_matches_jax():
    """One step from a non-zero AdamW state (a first step from zero state
    moves every value by about lr whatever |g| is, which turns fp32 noise
    in g into differences of up to lr)."""
    arrs = np_params(TCFG)
    x, y = _batch(1)
    n = TP.num_parameters(TCFG)
    rng = np.random.default_rng(2)
    m0 = 1e-3 * rng.standard_normal(n).astype(np.float32)
    v0 = 1e-5 * rng.random(n).astype(np.float32)
    jstep = JDP.make_dp_train_step(JCFG, JDP.make_mesh(1), clip_norm=1.0)
    jp, jm, jv, jloss = jstep({k: jnp.asarray(a) for k, a in arrs.items()},
                              jnp.asarray(m0), jnp.asarray(v0),
                              jnp.asarray(x), jnp.asarray(y), np.int32(3),
                              np.float32(1e-3), np.float32(0.1))
    flat = TP.flatten_params(TP.from_numpy(arrs, TCFG, "cpu"), TCFG)
    tstep = TDP.make_dp_train_step(TCFG, TDP.make_mesh(devices=["cpu"]),
                                   clip_norm=1.0)
    m, v = torch.from_numpy(m0.copy()), torch.from_numpy(v0.copy())
    params, _, _, loss = tstep(TP.unflatten_params(flat, TCFG), m, v, x, y,
                               3, 1e-3, 0.1)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-5)
    for k, w in jax.device_get(jp).items():
        np.testing.assert_allclose(params[k].detach().numpy(), np.asarray(w),
                                   rtol=2e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-4, atol=1e-8)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-4,
                               atol=1e-11)


def _prefill_logits(mod, params, prompt, cfg, chunk, cache_len):
    """Last-position logits of a (chunked) prefill through
    forward_with_cache, in `mod` (the JAX or the port's generate module)."""
    if mod is JG:
        caches = JG.init_kv_cache(cfg, prompt.shape[0], cache_len)
        prompt = jnp.asarray(prompt)
    else:
        caches = TG.init_kv_cache(cfg, prompt.shape[0], cache_len, device="cpu")
        prompt = torch.as_tensor(prompt)
    for off in range(0, prompt.shape[1], chunk):
        logits, caches = mod.forward_with_cache(
            params, prompt[:, off:off + chunk], caches, off, cfg,
            last_only=True)
    return np.asarray(logits)[:, -1]


def _chunk_case(kv):
    """(jax cfg, torch cfg, jax params, prepared torch params, prompt)."""
    jcfg, tcfg = {"gqa": (JCFG, TCFG), "mha": small_cfgs(),
                  "mqa": (c.replace(num_kv_heads=1) for c in (JCFG, TCFG))
                  }[kv]
    jp, tp = both_params(jcfg, tcfg, seed=4)
    prompt = np.random.default_rng(4).integers(0, V, (2, 48))
    return jcfg, tcfg, jp, TM.prepare_params(tp, tcfg), prompt


@pytest.mark.parametrize("kv", ["gqa", "mha", "mqa"])
def test_chunked_generate_matches_jax_and_whole(kv, monkeypatch):
    jcfg, tcfg, jp, tp, prompt = _chunk_case(kv)
    calls = []
    plain = TFP.flash_prefill_plain
    monkeypatch.setattr(TFP, "flash_prefill_plain",
                        lambda *a: calls.append(a[5]) or plain(*a))
    chunked = TG.generate(tp, torch.as_tensor(prompt), tcfg, max_new=8,
                          temperature=0.0, prefill_chunk=16)
    # continuation chunks at 16 and 32 through K4 in each of the 2 layers
    assert calls == [16, 16, 32, 32]
    whole = TG.generate(tp, torch.as_tensor(prompt), tcfg, max_new=8,
                        temperature=0.0)
    jax_chunked = JG.generate(jp, jnp.asarray(prompt), jcfg, 8,
                              jax.random.PRNGKey(0), temperature=0.0,
                              prefill_chunk=16)
    np.testing.assert_array_equal(chunked.numpy(), whole.numpy())
    np.testing.assert_array_equal(chunked.numpy(), np.asarray(jax_chunked))


@pytest.mark.parametrize("kv", ["gqa", "mha", "mqa"])
def test_chunked_prefill_logits_match_jax_and_whole(kv):
    jcfg, tcfg, jp, tp, prompt = _chunk_case(kv)
    got = _prefill_logits(TG, tp, prompt, tcfg, 16, 256)
    np.testing.assert_allclose(
        got, _prefill_logits(TG, tp, prompt, tcfg, 48, 56), rtol=1e-5,
        atol=1e-5)
    np.testing.assert_allclose(
        got, _prefill_logits(JG, jp, prompt, jcfg, 16, 256), rtol=1e-5,
        atol=1e-5)


def test_k3_and_k4_routes_never_expand_kv(monkeypatch):
    """Training, whole-prompt and chunked prefill at a flash geometry read
    K/V at kv width: the expansion helpers are never called (the routes are
    the same on the card, with the kernels in place of the plain
    versions)."""
    def refuse(*a, **k):
        raise AssertionError("K/V expanded on a K3/K4 route")
    for name in ("expand_kv_heads", "expand_packed", "expand_qkv_weight"):
        monkeypatch.setattr(TA, name, refuse)
    monkeypatch.setattr(TM, "expand_qkv_weight", refuse)
    monkeypatch.setattr(torch.Tensor, "repeat_interleave", refuse)
    params = {k: v.requires_grad_(True)
              for k, v in TP.from_numpy(np_params(TCFG), TCFG, "cpu").items()}
    x, y = _batch(3)
    TM.loss_fn(params, torch.from_numpy(x), torch.from_numpy(y),
               TCFG).backward()
    tp = TM.prepare_params(params, TCFG)
    prompt = torch.as_tensor(x[:, :48]).long()
    for chunk in (0, 16):
        TG.generate(tp, prompt, TCFG, max_new=2, temperature=0.0,
                    prefill_chunk=chunk)


def test_chunked_prefill_rules():
    """T0 must be a multiple of the chunk; the cache rounds up to
    PREFILL_BLOCK when chunking (continuation chunks then take K4), and a
    cache that is not aligned takes dense cache attention."""
    tp = TM.prepare_params(both_params(JCFG, TCFG)[1], TCFG)
    prompt = torch.zeros(1, 40, dtype=torch.long)
    with pytest.raises(ValueError, match="multiple of prefill_chunk"):
        TG.generate(tp, prompt, TCFG, max_new=2, temperature=0.0,
                    prefill_chunk=16)
    assert TG._flash_cont_ok(TCFG, 256) and not TG._flash_cont_ok(TCFG, 56)
    # MQA at D=64: K4 here, dense cache attention in the JAX package
    assert TG._flash_cont_ok(TCFG.replace(num_kv_heads=1), 256)
    assert not JG._flash_cont_ok(JCFG.replace(num_kv_heads=1), 256)
    short = TG.generate(tp, prompt[:, :16], TCFG, max_new=2, temperature=0.0,
                        prefill_chunk=16)       # T0 <= chunk: one prefill
    assert short.shape == (1, 18)


def test_engine_matches_jax_engine():
    jp, tp = both_params(JCFG, TCFG, seed=5)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, V, n) for n in (5, 9, 30, 17)]
    outs = []
    for Engine, p in ((JaxEngine, jp), (GenerationEngine, tp)):
        eng = Engine(p, JCFG if Engine is JaxEngine else TCFG, max_slots=4,
                     max_len=48, prompt_buckets=(16, 32))
        for pr, n in zip(prompts, (6, 4, 9, 5)):
            eng.submit(pr, max_new=n)
        outs.append(dict(eng.run()))
    assert outs[0].keys() == outs[1].keys()
    for rid in outs[0]:
        np.testing.assert_array_equal(outs[1][rid], np.asarray(outs[0][rid]))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_loads_in_the_other_package(writer, tmp_path):
    path = str(tmp_path / "gqa.bin")
    jp, tp = both_params(JCFG, TCFG, seed=6)
    (JaxViT(JCFG, jp) if writer == "jax" else ViT(TCFG, tp)).save_checkpoint(
        path)
    jm = JaxViT.build_from_checkpoint(path)
    m = ViT.build_from_checkpoint(path, device="cpu")
    assert m.config.num_kv_heads == 2 and m.config == TCFG
    toks = np.random.default_rng(6).integers(0, V, (2, 24))
    m.forward(toks)
    jm.forward(toks)
    np.testing.assert_allclose(m.logits.numpy(), np.asarray(jm.logits),
                               rtol=1e-4, atol=1e-4)


def test_from_numpy_carries_jax_weights():
    from vitrs_tpu import params as JP
    jparams = JP.init_params(JCFG, jax.random.PRNGKey(7))
    arrs = {k: np.asarray(v) for k, v in jparams.items()}
    tp = TP.from_numpy(arrs, TCFG, "cpu")
    assert tuple(tp) == TP.tensor_order(TCFG)
    assert tp["qkvw"].shape == (2, 256 + 2 * 128, 256)
    for k, a in arrs.items():
        np.testing.assert_array_equal(tp[k].numpy(), a)
    assert TP.num_parameters(TCFG) == JP.num_parameters(JCFG)


def test_gqa_helpers_match_jax():
    rng = np.random.default_rng(8)
    H, KVH, hd = 6, 2, 8
    x = rng.standard_normal((2, 5, (H + 2 * KVH) * hd), dtype=np.float32)
    np.testing.assert_array_equal(
        TA.expand_packed(torch.from_numpy(x), H, KVH).numpy(),
        np.asarray(JA.expand_packed(jnp.asarray(x), H, KVH)))
    np.testing.assert_array_equal(TA._expand_row_index(H, KVH, hd),
                                  JA._expand_row_index(H, KVH, hd))
    w = rng.standard_normal((3, (H + 2 * KVH) * hd, 7), dtype=np.float32)
    b = rng.standard_normal((3, (H + 2 * KVH) * hd), dtype=np.float32)
    tw, tb = TA.expand_qkv_weight(torch.from_numpy(w), torch.from_numpy(b),
                                  H, KVH)
    jw, jb = JA.expand_qkv_weight(jnp.asarray(w), jnp.asarray(b), H, KVH)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    dw = rng.standard_normal((3, 3 * H * hd, 7), dtype=np.float32)
    db = rng.standard_normal((3, 3 * H * hd), dtype=np.float32)
    # the transpose: autograd of expand_qkv_weight is the JAX package's
    # group sum of the expanded gradient (its reduce_qkv_weight_grad)
    jw, jb = JA.reduce_qkv_weight_grad(jnp.asarray(dw), jnp.asarray(db), H,
                                       KVH)
    wt = torch.from_numpy(w).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    ew, eb = TA.expand_qkv_weight(wt, bt, H, KVH)
    torch.autograd.backward((ew, eb), (torch.from_numpy(dw),
                                       torch.from_numpy(db)))
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-6)


def test_trainer_takes_kv_heads_and_refuses_other_overrides(tmp_path):
    """`kv_heads` is the trainer's own field for num_kv_heads: an MQA
    gpt-nano trains; `model_overrides` (the JAX config's dict) naming a
    model variant the port does not run is refused, and --mesh ep=2 on a
    dense preset raises the JAX plan's refusal."""
    tc = TL.TrainConfig(preset="gpt-nano", steps=2, batch_size=2,
                        device="cpu", dtype="float32", dataset="",
                        log_every=1, ckpt_every=0, warmup=1,
                        workdir=str(tmp_path / "kv"), kv_heads=1)
    summary = TL.train(tc)
    assert np.isfinite(summary["final_loss"])
    from vitrs_tpu_torch import checkpoint as TC
    last = sorted((tmp_path / "kv").glob("ckpt_*.bin"))[-1]
    assert TC.load_checkpoint(str(last))[1].num_kv_heads == 1
    with pytest.raises(ValueError, match="both set"):
        TL.train(TL.TrainConfig(preset="gpt-nano", steps=1, device="cpu",
                                workdir=str(tmp_path / "both"), kv_heads=1,
                                model_overrides={"num_kv_heads": 2}))
    # the quirk path (G5/G6/G11) trains too: its loss is -p, in [-1, 0]
    q = TL.train(TL.TrainConfig(preset="gpt-nano", steps=1, device="cpu",
                                workdir=str(tmp_path / "quirks"), dataset="",
                                batch_size=4, model_overrides={"quirks": True}))
    assert -1.0 <= q["final_loss"] <= 0.0
    from vitrs_tpu_torch.cli import train as cli
    with pytest.raises(ValueError, match="needs a MoE config"):
        cli.main(["--mesh", "ep=2", "--cpu"])
