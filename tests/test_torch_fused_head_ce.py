"""PyTorch port: K8, the fused head matmul + CE (ops/fused_head_ce.py),
against the JAX package's `head_ce_mean` in interpret mode on the CPU, and
`gpt_loss` routed through it.

  * the plain K8 (`head_ce_mean` on CPU tensors) against the Pallas
    function with BLOCK_R=8, BLOCK_V=128 (several row panels and vocab
    tiles, as tests/test_fused_head_ce.py runs it): loss rtol 1e-6, both
    gradients rtol 1e-5 (atol 1e-7), and the pad rows of dW exactly 0;
  * `head_ce_fwd_plain`: lse and picked from the fp32 product, the logits
    rounded to the input dtype, pad columns out of the logsumexp;
  * `gpt_loss` with the port's ENABLE set against the JAX `gpt_loss` (loss
    rtol 2e-5, grads rtol 5e-4, atol 1e-6; qkvb atol 2e-4, ROADMAP.md
    Queue 3 #4) and against the port's two-op route (K5/K6), on CPU tensors;
  * the wrapper's contract: `supports` (every shape it took before the
    bf16 kernel moved to TMA and 192-column vocab tiles), `tma_mappable`
    (the views the bf16 kernel reads in place: every one `gpt_loss`
    passes; none with a base or row stride off 16 bytes, rows broadcast or
    columns strided), and a CPU tensor refused by the kernel's own entry;
  * the plain version at ragged R, targets on the last real column and in
    the pad columns (the kernel's NaN pick for those is held on the card:
    tests/test_torch_rope_window_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitrs_tpu.models import model as JM
from vitrs_tpu.ops import fused_head_ce as JH
from vitrs_tpu_torch import config as TC
from vitrs_tpu_torch import params as TP
from vitrs_tpu_torch.models import model as TM
from vitrs_tpu_torch.ops import fused_ce as TCE
from vitrs_tpu_torch.ops import fused_head_ce as TH

from test_torch_helpers import both_params, np_params, small_cfgs


@pytest.fixture
def small_blocks(monkeypatch):
    monkeypatch.setattr(JH, "BLOCK_R", 8)
    monkeypatch.setattr(JH, "BLOCK_V", 128)


def _inputs(R, C, Vp, V, seed, pad_zero=True):
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((R, C))).astype(np.float32)
    w = (0.05 * rng.standard_normal((Vp, C))).astype(np.float32)
    if pad_zero:
        w[V:] = 0.0            # pad rows, as gpt_loss pads the tied head
    t = rng.integers(0, V, R)
    return x, w, t


@pytest.mark.parametrize("R,V", [(16, 300), (24, 384), (8, 257)])
def test_plain_matches_pallas_interpret(small_blocks, R, V):
    C, Vp = 128, 384
    x, w, t = _inputs(R, C, Vp, V, seed=R + V)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    loss = TH.head_ce_mean(xt, wt, torch.from_numpy(t), V)
    loss.backward()

    def f(a, b):
        return JH.head_ce_mean(a, b, jnp.asarray(t), V, True)
    jloss, (jdx, jdw) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jdw), rtol=1e-5,
                               atol=1e-7)
    assert not wt.grad[V:].any() and not np.asarray(jdw)[V:].any()


def test_fwd_plain_statistics_and_bf16_logits():
    R, C, Vp, V = 12, 64, 256, 200
    x, w, t = _inputs(R, C, Vp, V, seed=1, pad_zero=False)
    xb, wb = (torch.from_numpy(a).bfloat16() for a in (x, w))
    logits, lse, picked = TH.head_ce_fwd_plain(xb, wb, torch.from_numpy(t), V)
    assert logits.dtype == torch.bfloat16 and logits.shape == (R, Vp)
    assert lse.dtype == picked.dtype == torch.float32
    tile = xb.double() @ wb.double().t()          # a bf16 product is exact
    np.testing.assert_allclose(logits.float().numpy(),
                               tile.bfloat16().float().numpy(), rtol=0,
                               atol=0)
    want = torch.logsumexp(tile[:, :V], dim=-1)   # pad columns left out
    np.testing.assert_allclose(lse.numpy(), want.numpy(), rtol=1e-6)
    np.testing.assert_allclose(picked.numpy(),
                               tile[torch.arange(R), t].numpy(), rtol=1e-6)


GPT_V = 16500        # pads to 16512: the fused CE route (fused_ce.supports)


@pytest.mark.parametrize("kv", [0, 2])
def test_gpt_loss_through_k8_matches_jax_and_two_op_route(kv, monkeypatch):
    jcfg, tcfg = small_cfgs(vocab_size=GPT_V, num_heads=4, channels=256,
                            num_kv_heads=kv)
    B, T = 2, 64
    assert TCE.supports(B * T, TCE.pad_vocab(GPT_V))
    assert TH.supports(B * T, TCE.pad_vocab(GPT_V), tcfg.channels)
    rng = np.random.default_rng(kv)
    x = rng.integers(0, GPT_V, (B, T)).astype(np.int32)
    y = rng.integers(0, GPT_V, (B, T)).astype(np.int32)
    jp, _ = both_params(jcfg, tcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(JM.loss_fn), static_argnums=3)(
        jp, jnp.asarray(x), jnp.asarray(y), jcfg)
    calls = {"k8": 0, "k5": 0}
    for mod, name, key in ((TH, "head_ce_fwd_plain", "k8"),
                           (TCE, "ce_fwd_plain", "k5")):
        plain = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=plain, _k=key:
                            calls.__setitem__(_k, calls[_k] + 1) or _f(*a))
    out = {}
    for enable in (True, False):
        monkeypatch.setattr(TH, "ENABLE", enable)
        params = {k: v.requires_grad_(True) for k, v in
                  TP.from_numpy(np_params(tcfg), tcfg, "cpu").items()}
        loss = TM.loss_fn(params, torch.from_numpy(x), torch.from_numpy(y),
                          tcfg)
        loss.backward()
        out[enable] = (loss.item(), {k: p.grad for k, p in params.items()})
    assert calls == {"k8": 1, "k5": 1}
    for enable in (True, False):
        np.testing.assert_allclose(out[enable][0], float(jloss), rtol=2e-5)
        for k, w in jax.device_get(jgrads).items():
            atol = 2e-4 if k == "qkvb" else 1e-6
            np.testing.assert_allclose(out[enable][1][k].numpy(),
                                       np.asarray(w), rtol=5e-4, atol=atol,
                                       err_msg=f"{k} enable={enable}")


def test_supports_and_the_kernel_entry_refuses_cpu():
    assert TH.ENABLE is False            # the JAX package's default
    assert TH.supports(8192, 50304, 768) and TH.supports(100, 50304, 768)
    assert not TH.supports(8192, 50257, 768)      # unpadded vocab
    assert not TH.supports(8192, 50304, 100)      # channels off the k chunk
    x, w, t = (torch.from_numpy(a) for a in _inputs(8, 64, 128, 100, 2))
    with pytest.raises(ValueError, match="CUDA"):
        TH.head_ce_fwd_cuda(x, w, t, 100)


@pytest.mark.parametrize("R", [1, 127, 129, 8191, 16384])
@pytest.mark.parametrize("Vp,C", [(128, 32), (128, 64), (1024, 96),
                                  (16512, 256), (50304, 768), (50304, 1024),
                                  (50304, 1280), (50304, 1600)])
def test_supports_takes_every_shape_it_took(R, Vp, C):
    """The rule before this kernel's redesign: R > 0, Vp % 128, C % 32;
    a ragged last vocab tile (Vp not a multiple of 192) is the kernel's
    to clip, not a shape to refuse."""
    assert TH.supports(R, Vp, C)
    assert not TH.supports(0, Vp, C)
    assert not TH.supports(R, Vp + 64, C) and not TH.supports(R, Vp, C + 16)


@pytest.mark.parametrize("name", ["gpt2-124m", "gpt2-350m", "gpt2-774m",
                                  "gpt2-1558m"])
def test_supports_takes_the_gpt2_presets(name):
    cfg = TC.get_config(name)
    assert TH.supports(8 * cfg.max_seq_len, TCE.pad_vocab(cfg.vocab_size),
                       cfg.channels)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tma_mappable_refuses_what_tma_cannot_map(dtype):
    R, C, Vp = 64, 768, 1024
    x = torch.zeros(R, C, dtype=dtype)
    assert TH.tma_mappable(x)
    assert TH.tma_mappable(torch.zeros(R, C + 64, dtype=dtype)[:, :C])
    assert TH.tma_mappable(torch.zeros(2 * R, C, dtype=dtype)[R:])
    buf = torch.zeros(R * C + 8, dtype=dtype)
    assert TH.tma_mappable(buf[:R * C].view(R, C))
    assert not TH.tma_mappable(buf[1:1 + R * C].view(R, C))        # base
    assert not TH.tma_mappable(torch.zeros(R, C + 1, dtype=dtype)[:, :C])
    assert not TH.tma_mappable(torch.zeros(1, C, dtype=dtype).expand(Vp, C))
    assert not TH.tma_mappable(torch.zeros(C, Vp, dtype=dtype).t())
    assert not TH.tma_mappable(torch.zeros(2, R, C, dtype=dtype))


@pytest.mark.parametrize("kv", [0, 2])
def test_gpt_loss_passes_views_tma_maps(kv, monkeypatch):
    """Every x and w `gpt_loss` hands K8 (bf16 compute: lnf reshaped to
    (R, C), the padded head) is a view the bf16 kernel reads in place."""
    _, tcfg = small_cfgs(vocab_size=GPT_V, num_heads=4, channels=256,
                         num_kv_heads=kv, dtype="bfloat16")
    seen = []
    plain = TH.head_ce_fwd_plain
    monkeypatch.setattr(TH, "head_ce_fwd_plain", lambda x, w, t, v:
                        seen.append((x, w)) or plain(x, w, t, v))
    monkeypatch.setattr(TH, "ENABLE", True)
    rng = np.random.default_rng(kv)
    x, y = (torch.from_numpy(rng.integers(0, GPT_V, (2, 64))) for _ in "xy")
    params = TP.from_numpy(np_params(tcfg), tcfg, "cpu")
    loss = TM.loss_fn(params, x, y, tcfg)
    assert torch.isfinite(loss) and len(seen) == 1
    (lx, lw), = seen
    assert lx.dtype == lw.dtype == torch.bfloat16
    assert lx.shape == (128, 256) and lw.shape == (TCE.pad_vocab(GPT_V), 256)
    assert TH.tma_mappable(lx) and TH.tma_mappable(lw)


@pytest.mark.parametrize("R", [1, 127, 129])
def test_fwd_plain_ragged_rows_last_and_pad_targets(R):
    """The plain version's contract: any R; lse over the real columns;
    picked is the target column of the fp32 product, the last real column
    and a pad column included."""
    C, Vp, V = 64, 384, 300
    x, w, t = _inputs(R, C, Vp, V, seed=R, pad_zero=False)
    t[0] = V - 1
    if R > 1:
        t[1] = V + 5
    xb, wb = (torch.from_numpy(a).bfloat16() for a in (x, w))
    logits, lse, picked = TH.head_ce_fwd_plain(xb, wb, torch.from_numpy(t), V)
    tile = xb.double() @ wb.double().t()
    assert logits.shape == (R, Vp) and lse.shape == picked.shape == (R,)
    # within one bf16 ulp: the fp32 product rounds once more than fp64's
    np.testing.assert_allclose(logits.float().numpy(),
                               tile.bfloat16().float().numpy(),
                               rtol=2.0 ** -7, atol=0)
    np.testing.assert_allclose(lse.numpy(),
                               torch.logsumexp(tile[:, :V], -1).numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(picked.numpy(),
                               tile[torch.arange(R), t].numpy(), rtol=1e-6,
                               atol=1e-7)
