"""PyTorch port: the reference-exact path (quirks=True: G5, G6, G11)
against the JAX package and the numpy oracle, on the CPU.

  * the port's copy of oracle/numpy_ref.py equals the original on the same
    inputs (every function, both modes);
  * the quirk ops (attention_dense G5/G11, softmax G11, cross_entropy_quirk
    G6) and their gradients against the JAX ops;
  * the model's quirk loss and all 16 gradients at gpt-nano (fp32) against
    jax.grad of the JAX quirk loss and against the oracle
    (`model_forward(quirks=True)`, `model_backward_quirks`, the exact
    gradient of the as-written forward): loss rtol 2e-5; gradients rtol
    5e-4 with atol 2e-5 of the tensor's largest value (fp32 sums in another
    order); a row whose oracle gradient is exactly zero (a token absent
    from the batch, a position past T) within 2e-4 of it;
  * a quirk config at head_dim 64 never takes the flash route (the kernels'
    plain versions are made to raise), under remat it takes the full
    checkpoint, its prompts stay off K1-fwd/K4 in generate, and the five-
    call API and the trainer run it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitrs_tpu import params as JP
from vitrs_tpu.models import generate as JG
from vitrs_tpu.models import model as JM
from vitrs_tpu.ops import basic as JB
from vitrs_tpu.oracle import numpy_ref as JO
from vitrs_tpu_torch import ViT
from vitrs_tpu_torch import params as TP
from vitrs_tpu_torch.models import generate as TG
from vitrs_tpu_torch.models import model as TM
from vitrs_tpu_torch.ops import basic as TB
from vitrs_tpu_torch.ops import flash_attention as FA
from vitrs_tpu_torch.ops import flash_attention_gqa as FG
from vitrs_tpu_torch.ops import flash_prefill as FP
from vitrs_tpu_torch.oracle import numpy_ref as TO
from vitrs_tpu_torch.train import loop as TL

from test_torch_helpers import both_params, jax_config, small_cfgs, \
    torch_config
from test_torch_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NANO = dict(use_flash=False, dtype="float32")


def _setup(seed=7, B=2, T=8):
    """gpt-nano in both packages, the oracle's init plus seeded noise (so
    that no weight is degenerate), and tokens."""
    jcfg = jax_config("gpt-nano", quirks=True, **NANO)
    tcfg = torch_config("gpt-nano", quirks=True, **NANO)
    rng = np.random.default_rng(seed)
    arrs = {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in TO.init_parameters(TP.param_shapes(tcfg),
                                           seed=seed).items()}
    toks = rng.integers(0, tcfg.vocab_size, (B, T))
    tgts = rng.integers(0, tcfg.vocab_size, (B, T))
    return jcfg, tcfg, arrs, toks, tgts


def _assert_same(a, b, what):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for x, y in zip(a, b):
            _assert_same(x, y, what)
    else:
        np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("quirks", [False, True])
def test_numpy_ref_copy_matches_the_original(quirks):
    _, tcfg, arrs, toks, tgts = _setup(seed=3)
    H = tcfg.num_heads
    lj, aj = JO.model_forward(arrs, toks, tgts, H, quirks=quirks)
    lt, at = TO.model_forward(arrs, toks, tgts, H, quirks=quirks)
    assert lj == lt and set(aj) == set(at)
    for k in aj:
        _assert_same(aj[k], at[k], k)
    gj = JO.model_backward(arrs, aj, toks, tgts, H)
    gt = TO.model_backward(arrs, at, toks, tgts, H)
    for k in gj:
        _assert_same(gj[k], gt[k], k)
    x = np.random.default_rng(1).standard_normal((2, 5, 48)).astype(np.float32)
    t = np.random.default_rng(2).integers(0, 48, (2, 5))
    for fn, args in (("gelu_forward", (x,)),
                     ("layernorm_forward", (x, x[0, 0], x[1, 1])),
                     ("gelu_backward", (x, x, quirks)),
                     ("softmax_forward", (x, quirks)),
                     ("crossentropy_forward", (np.abs(x), t, quirks)),
                     ("crossentropy_backward_dense", (x, t)),
                     ("softmax_backward_dense", (x, x))):
        _assert_same(getattr(JO, fn)(*args), getattr(TO, fn)(*args), fn)
    _assert_same(JO.init_parameters(TP.param_shapes(tcfg), seed=5)["qkvw"],
                 TO.init_parameters(TP.param_shapes(tcfg), seed=5)["qkvw"],
                 "init")


@pytest.mark.parametrize("causal", [True, False])
def test_quirk_attention_dense_and_its_grads_match_jax(causal):
    """G11 bites: head 0's scores sit at -10002 - 2j for key j, exact in
    fp32 (q = 64, k = -(39.0703125 + j/128), D = 16, scale 1/4), below the
    floor, so its row max is -1e4 and G5's raw diagonal exp(s_t - m) is
    not 1; head 1 is random."""
    rng = np.random.default_rng(2)
    B, T, NH, D = 2, 6, 2, 16
    qkv = rng.standard_normal((B, T, 3 * NH * D)).astype(np.float32)
    qkv[..., :D] = 64.0
    qkv[..., NH * D:NH * D + D] = -(39.0703125
                                    + np.arange(T)[:, None] / 128.0)
    w = rng.standard_normal((B, T, NH * D)).astype(np.float32)
    jout, jatt = JB.attention_dense(jnp.asarray(qkv), NH, causal=causal,
                                    quirks=True)
    jg = jax.grad(lambda x: jnp.sum(JB.attention_dense(
        x, NH, causal=causal, quirks=True)[0] * w))(jnp.asarray(qkv))
    t = torch.tensor(qkv, requires_grad=True)
    tout, tatt = TB.attention_dense(t, NH, causal=causal, quirks=True)
    (tout * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(tatt.detach().numpy(), np.asarray(jatt),
                               rtol=2e-5, atol=1e-7)
    scale = np.abs(np.asarray(jg)).max()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=5e-4,
                               atol=2e-5 * scale)
    if causal:
        want, oatt, _ = TO.attention_forward(qkv.astype(np.float64), NH,
                                             quirks=True)
        np.testing.assert_allclose(tout.detach().numpy(), want, rtol=2e-5,
                                   atol=1e-6)


def test_quirk_softmax_and_cross_entropy_match_jax():
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((3, 5, 11)) * 4).astype(np.float32)
    logits[0, 0] -= 10005.0                     # G11: a row below the floor
    tg = rng.integers(0, 11, (3, 5))
    jp = JB.softmax(jnp.asarray(logits), quirks=True)
    tp = TB.softmax(torch.from_numpy(logits), quirks=True)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=2e-6,
                               atol=1e-7)
    np.testing.assert_allclose(
        TB.cross_entropy_quirk(tp, torch.from_numpy(tg)).numpy(),
        np.asarray(JB.cross_entropy_quirk(jp, jnp.asarray(tg))), rtol=2e-6)
    np.testing.assert_allclose(tp.numpy(),
                               TO.softmax_forward(logits, quirks=True),
                               rtol=2e-6, atol=1e-7)


def _assert_grads(got, want, name):
    w = np.asarray(want, np.float64)
    g = np.asarray(got, np.float64)
    scale = max(np.abs(w).max(), 1e-12)
    np.testing.assert_allclose(g, w, rtol=5e-4, atol=2e-5 * scale,
                               err_msg=name)
    zero = w == 0.0
    if zero.any():
        assert np.abs(g[zero]).max() <= 2e-4 * scale, name


def test_quirk_loss_and_all_grads_match_jax_and_the_oracle():
    jcfg, tcfg, arrs, toks, tgts = _setup()
    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in arrs.items()}
    loss = TM.gpt_loss(leaves, torch.as_tensor(toks), torch.as_tensor(tgts),
                       tcfg)
    loss.backward()
    jl, jg = jax.value_and_grad(JM.gpt_loss)(
        {k: jnp.asarray(v) for k, v in arrs.items()}, jnp.asarray(toks),
        jnp.asarray(tgts), jcfg)
    ol, acts = TO.model_forward(arrs, toks, tgts, tcfg.num_heads, quirks=True)
    og = TO.model_backward_quirks(arrs, acts, toks, tgts, tcfg.num_heads)
    assert -1.0 <= float(loss.detach()) <= 0.0  # G6: -p, not -log p
    np.testing.assert_allclose(float(loss), float(jl), rtol=2e-5)
    np.testing.assert_allclose(float(loss), ol, rtol=2e-5)
    assert set(og) == set(JP.CANONICAL_16)
    for k in JP.CANONICAL_16:
        _assert_grads(leaves[k].grad.numpy(), jg[k], f"{k} vs jax.grad")
        _assert_grads(leaves[k].grad.numpy(), og[k], f"{k} vs the oracle")


def _no_kernels(monkeypatch):
    """Every flash route's plain version (what a CPU tensor takes where the
    card takes the kernel) raises."""
    def refuse(*a, **k):
        raise AssertionError("a quirk config reached a flash route")
    for mod, names in ((FA, ("flash_fwd_plain", "flash_bwd_plain")),
                       (FG, ("flash_gqa_fwd_plain", "flash_gqa_bwd_plain")),
                       (FP, ("flash_prefill_plain",))):
        for n in names:
            monkeypatch.setattr(mod, n, refuse)


@pytest.mark.parametrize("remat", [False, True, "full"])
def test_quirk_config_at_head_dim_64_never_takes_the_kernels(remat,
                                                            monkeypatch):
    """At head_dim 64 a plain config takes the flash route; the quirk
    config takes dense attention under every remat (True means the full
    checkpoint for it, as in the JAX layer scan) with the same loss and
    gradients as JAX's."""
    jcfg, tcfg = small_cfgs(quirks=True, dtype="float32", remat=remat)
    jp, tp = both_params(jcfg, tcfg, seed=1)
    if remat:
        assert TM.block_body(tcfg) is not TM._block
    toks = np.random.default_rng(0).integers(0, 97, (2, 24))
    tgts = np.roll(toks, -1, axis=1)
    _no_kernels(monkeypatch)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    loss = TM.gpt_loss(leaves, torch.as_tensor(toks), torch.as_tensor(tgts),
                       tcfg)
    loss.backward()
    jl, jg = jax.value_and_grad(JM.gpt_loss)(jp, jnp.asarray(toks),
                                             jnp.asarray(tgts), jcfg)
    np.testing.assert_allclose(float(loss), float(jl), rtol=2e-5)
    for k in ("qkvw", "wte", "ln1w", "fcprojb"):
        _assert_grads(leaves[k].grad.numpy(), jg[k], k)


def test_quirk_generate_stays_off_the_kernels(monkeypatch):
    """A quirk prompt goes through dense cache attention, as in the JAX
    package (generate.py:199-201): the same greedy tokens as JAX's, with
    every flash route's plain version raising; chunked too (no K4)."""
    jcfg, tcfg = small_cfgs(quirks=True, dtype="float32")
    jp, tp = both_params(jcfg, tcfg, seed=2)
    pp = TM.prepare_params(tp, tcfg)
    prompt = np.random.default_rng(3).integers(0, 97, (2, 16))
    want = JG.generate(jp, jnp.asarray(prompt), jcfg, max_new=6,
                       key=jax.random.PRNGKey(0), temperature=0.0)
    _no_kernels(monkeypatch)
    got = TG.generate(pp, torch.as_tensor(prompt), tcfg, max_new=6,
                      temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    chunked = TG.generate(pp, torch.as_tensor(prompt), tcfg, max_new=6,
                          temperature=0.0, prefill_chunk=8)
    np.testing.assert_array_equal(chunked.numpy(), np.asarray(want))


def test_five_call_api_and_trainer_take_quirks(tmp_path):
    jcfg, tcfg, arrs, toks, tgts = _setup(seed=5)
    m = ViT(tcfg, TP.from_numpy(arrs, tcfg, "cpu"))
    loss = m.forward(toks, tgts)
    jl = JM.forward_with_loss({k: jnp.asarray(v) for k, v in arrs.items()},
                              jnp.asarray(toks), jnp.asarray(tgts), jcfg)[1]
    np.testing.assert_allclose(loss, float(jl), rtol=2e-5)
    grads = m.backward()
    assert np.isfinite(grads["qkvw"].numpy()).all()
    m.optimizer_step(1e-2)
    assert m.forward(toks, tgts) < loss          # -p falls as p rises
    summary = TL.train(TL.TrainConfig(
        preset="gpt-nano", steps=3, batch_size=4, device="cpu",
        dtype="float32", dataset="", log_every=1, ckpt_every=0, warmup=1,
        workdir=str(tmp_path), model_overrides={"quirks": True}))
    assert -1.0 <= summary["final_loss"] <= 0.0
