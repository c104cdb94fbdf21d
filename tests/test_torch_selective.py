"""PyTorch port: selective and full remat (models/selective.py,
models/model.block_body) against the JAX package's selective path and the
port's plain block, on the CPU.

  * the attention branch (MHA; GQA at kv 1 and 2; rope + window;
    bidirectional) and the MLP branch (tanh and erf GELU): output and the
    7 gradients against JAX's `attn_branch` / `mlp_branch` as the JAX
    package runs them on the CPU (its dense branch, replayed by jax.vjp)
    and against the port's plain branch, through a mean loss as the
    models' losses are means;
  * the whole model in gpt mode (MHA, GQA kv 1 and 2, rope + window, MoE)
    and vit mode (with stochastic depth), remat True and "full": loss and
    every gradient against jax.value_and_grad of the JAX loss at
    remat=True, and against the port at remat=False;
  * the selective backward never runs the flash forward again (K1-fwd's
    plain version counted: L calls a step, 2L under "full"); the MoE half
    runs again in the backward;
  * the preset gpt2-124m-4k reads remat=True, the loop keeps it unless
    told otherwise, and the CLI's --remat sets it.

Tolerances (ROADMAP.md's CPU parity): loss rtol 2e-5, gradients rtol 5e-4
with atol 1e-6, the packed qkv bias atol 2e-4 (its K third has an exactly
zero gradient, where both sides hold fp32 noise)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitrs_tpu.config import get_config as jax_config
from vitrs_tpu.models import model as JM
from vitrs_tpu.models import selective as JS
from vitrs_tpu_torch import params as TP
from vitrs_tpu_torch.cli import train as cli
from vitrs_tpu_torch.config import get_config as torch_config
from vitrs_tpu_torch.models import model as TM
from vitrs_tpu_torch.models import selective as TS
from vitrs_tpu_torch.ops import flash_attention as FA
from vitrs_tpu_torch.ops import flash_attention_gqa as FG
from vitrs_tpu_torch.train import loop as TL

from test_torch_helpers import np_params

ATTN = ("ln1w", "ln1b", "qkvw", "qkvb", "attprojw", "attprojb")
MLP = ("ln2w", "ln2b", "fcw", "fcb", "fcprojw", "fcprojb")


def _close(got, want, name, atol=1e-6):
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=atol, err_msg=name)


def _layer(cfg, keys, seed):
    """Layer 0's tensors of `keys` from numpy-seeded parameters."""
    arrs = np_params(cfg, seed)
    return {k: arrs[k][0] for k in keys}


def _branch_grads_torch(fn, x, w):
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = {k: torch.from_numpy(v).requires_grad_(True) for k, v in w.items()}
    loss = torch.sin(fn(xt, wt)).mean()
    loss.backward()
    return loss.item(), [xt.grad.numpy()] + [wt[k].grad.numpy() for k in w]


# (num_heads, kv_heads, causal, rope, window)
ATTN_CASES = {"mha-causal": (2, 0, True, False, 0),
              "mha-bidirectional": (2, 0, False, False, 0),
              "gqa-kv1": (4, 1, True, False, 0),
              "gqa-kv2": (4, 2, True, False, 0),
              "rope-window": (2, 0, True, True, 8),
              "gqa-kv2-rope-window": (4, 2, True, True, 8)}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attn_branch_matches_jax_and_the_plain_branch(case):
    nh, kh, causal, rope, window = ATTN_CASES[case]
    kw = dict(num_layers=1, num_heads=nh, channels=64 * nh, num_kv_heads=kh,
              pos_emb="rope" if rope else "learned", window=window,
              vocab_size=97, max_seq_len=64)
    cfg = torch_config("gpt-nano").replace(**kw)
    w = _layer(cfg, ATTN, seed=1)
    T = 17 if causal else 16
    x = np.random.default_rng(2).standard_normal((2, T, cfg.channels)
                                                 ).astype(np.float32)
    calls = []
    fwd, gfwd = FA.flash_fwd_plain, FG.flash_gqa_fwd_plain
    FA.flash_fwd_plain = lambda *a, **k: calls.append(1) or fwd(*a, **k)
    FG.flash_gqa_fwd_plain = lambda *a, **k: calls.append(1) or gfwd(*a, **k)
    try:
        loss, grads = _branch_grads_torch(
            lambda xt, wt: TS.attn_branch(xt, wt, cfg, causal), x, w)
    finally:
        FA.flash_fwd_plain, FG.flash_gqa_fwd_plain = fwd, gfwd
    assert len(calls) == 1, "the selective backward ran the forward again"
    ploss, pgrads = _branch_grads_torch(
        lambda xt, wt: TM._attn_branch(xt, wt, cfg, causal), x, w)

    def jfn(*a):
        return jnp.mean(jnp.sin(JS.attn_branch(*a, nh, causal, False, True,
                                               kh, rope, window)))

    args = [jnp.asarray(x)] + [jnp.asarray(w[k]) for k in ATTN]
    jloss, jgrads = jax.jit(jax.value_and_grad(jfn, argnums=tuple(range(7))))(
        *args)
    np.testing.assert_allclose(loss, float(jloss), rtol=2e-5)
    np.testing.assert_allclose(loss, ploss, rtol=2e-5)
    for name, g, jg, pg in zip(("x",) + ATTN, grads, jgrads, pgrads):
        atol = 2e-4 if name == "qkvb" else 1e-6
        _close(g, np.asarray(jg), name, atol)
        _close(g, pg, name, atol)


@pytest.mark.parametrize("act", ["gelu", "gelu_erf"])
def test_mlp_branch_matches_jax_and_the_plain_branch(act):
    cfg = torch_config("gpt-nano").replace(num_layers=1, num_heads=2,
                                           channels=48, act=act)
    w = _layer(cfg, MLP, seed=3)
    x = np.random.default_rng(4).standard_normal((2, 5, 48)).astype(np.float32)
    loss, grads = _branch_grads_torch(
        lambda xt, wt: TS.mlp_branch(xt, wt, cfg), x, w)
    ploss, pgrads = _branch_grads_torch(
        lambda xt, wt: TM.mlp(wt, cfg, TM.basic.layernorm_cv(
            xt, wt["ln2w"], wt["ln2b"])), x, w)
    erf = act == "gelu_erf"

    def jfn(*a):
        return jnp.mean(jnp.sin(JS.mlp_branch(*a, erf)))

    args = [jnp.asarray(x)] + [jnp.asarray(w[k]) for k in MLP]
    jloss, jgrads = jax.jit(jax.value_and_grad(jfn, argnums=tuple(range(7))))(
        *args)
    np.testing.assert_allclose(loss, float(jloss), rtol=2e-5)
    np.testing.assert_allclose(loss, ploss, rtol=2e-5)
    for name, g, jg, pg in zip(("x",) + MLP, grads, jgrads, pgrads):
        _close(g, np.asarray(jg), name)
        _close(g, pg, name)


# model-level variants: (preset, config fields)
GPT = dict(num_layers=2, num_heads=2, channels=128, vocab_size=97,
           max_seq_len=32)
MODEL_CASES = {
    "gpt-mha": ("gpt-nano", GPT),
    "gpt-kv1": ("gpt-nano", dict(GPT, num_heads=4, channels=256,
                                 num_kv_heads=1)),
    "gpt-kv2": ("gpt-nano", dict(GPT, num_heads=4, channels=256,
                                 num_kv_heads=2)),
    "gpt-rope-window": ("gpt-nano", dict(GPT, pos_emb="rope", window=8)),
    "gpt-moe": ("gpt-nano", dict(GPT, num_experts=4, moe_cap_factor=1.0)),
    "vit": ("vit-tiny-4-cifar10", dict(num_layers=2, channels=128,
                                       num_heads=2, img_size=16,
                                       patch_size=4)),
}


def _inputs(tcfg):
    rng = np.random.default_rng(5)
    if tcfg.mode == "vit":
        return (rng.standard_normal((2, 16, 16, 3)).astype(np.float32),
                rng.integers(0, 10, (2,)))
    return (rng.integers(0, tcfg.vocab_size, (2, 32)),
            rng.integers(0, tcfg.vocab_size, (2, 32)))


@pytest.fixture(scope="module", params=list(MODEL_CASES))
def model_case(request):
    """(torch cfg, arrays, batch, JAX loss and grads at remat=True)."""
    preset, kw = MODEL_CASES[request.param]
    jcfg = jax_config(preset).replace(remat=True, **kw)
    tcfg = torch_config(preset).replace(**kw)
    arrs = np_params(tcfg, seed=6)
    x, y = _inputs(tcfg)
    loss, grads = jax.jit(jax.value_and_grad(JM.loss_fn), static_argnums=3)(
        {k: jnp.asarray(v) for k, v in arrs.items()}, jnp.asarray(x),
        jnp.asarray(y), jcfg)
    return tcfg, arrs, x, y, float(loss), jax.device_get(grads)


def _torch_loss_grads(tcfg, arrs, x, y, remat, drop_path=0.0):
    cfg = tcfg.replace(remat=remat, drop_path=drop_path)
    p = {k: v.requires_grad_(True)
         for k, v in TP.from_numpy(arrs, cfg, "cpu").items()}
    gen = torch.Generator().manual_seed(9) if drop_path else None
    loss = TM.loss_fn(p, torch.from_numpy(x), torch.from_numpy(y), cfg,
                      generator=gen)
    loss.backward()
    return loss.item(), {k: None if t.grad is None else t.grad.numpy()
                         for k, t in p.items()}


@pytest.mark.parametrize("remat", [True, "full"], ids=["selective", "full"])
def test_model_loss_and_grads_match_jax_and_plain(model_case, remat):
    tcfg, arrs, x, y, jloss, jgrads = model_case
    loss, grads = _torch_loss_grads(tcfg, arrs, x, y, remat)
    ploss, pgrads = _torch_loss_grads(tcfg, arrs, x, y, False)
    np.testing.assert_allclose(loss, jloss, rtol=2e-5)
    np.testing.assert_allclose(loss, ploss, rtol=2e-5)
    for k, jg in jgrads.items():
        atol = 2e-4 if k == "qkvb" else 1e-6
        g = grads[k] if grads[k] is not None else np.zeros_like(jg)
        _close(g, np.asarray(jg), k, atol)
        if pgrads[k] is not None:
            _close(g, pgrads[k], k, atol)


@pytest.mark.parametrize("remat", [True, "full"], ids=["selective", "full"])
def test_vit_stochastic_depth_sees_the_same_flags_when_recomputed(remat):
    preset, kw = MODEL_CASES["vit"]
    tcfg = torch_config(preset).replace(**kw)
    arrs = np_params(tcfg, seed=7)
    x, y = _inputs(tcfg)
    loss, grads = _torch_loss_grads(tcfg, arrs, x, y, remat, drop_path=0.5)
    ploss, pgrads = _torch_loss_grads(tcfg, arrs, x, y, False, drop_path=0.5)
    assert loss == ploss
    for k, pg in pgrads.items():
        if pg is not None:
            _close(grads[k], pg, k, 2e-4 if k == "qkvb" else 1e-6)


@pytest.mark.parametrize("remat,fwd", [(False, 1), (True, 1), ("full", 2)])
@pytest.mark.parametrize("kv_heads", [0, 2])
def test_flash_forward_runs_once_a_layer_unless_full(remat, fwd, kv_heads,
                                                     monkeypatch):
    cfg = torch_config("gpt-nano").replace(**dict(
        GPT, num_heads=4, channels=256, num_kv_heads=kv_heads, remat=remat))
    mod, name = ((FG, "flash_gqa_fwd_plain") if kv_heads
                 else (FA, "flash_fwd_plain"))
    bmod, bname = ((FG, "flash_gqa_bwd_plain") if kv_heads
                   else (FA, "flash_bwd_plain"))
    counts = {"fwd": 0, "bwd": 0}
    real, breal = getattr(mod, name), getattr(bmod, bname)

    def count(key, fn):
        def wrapped(*a, **k):
            counts[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(mod, name, count("fwd", real))
    monkeypatch.setattr(bmod, bname, count("bwd", breal))
    arrs = np_params(cfg, seed=8)
    x, y = _inputs(cfg)
    _torch_loss_grads(cfg, arrs, x, y, remat)
    assert counts == {"fwd": fwd * cfg.num_layers, "bwd": cfg.num_layers}


def test_moe_half_runs_again_in_the_selective_backward(monkeypatch):
    from vitrs_tpu_torch.models import model as M
    _, kw = MODEL_CASES["gpt-moe"]
    cfg = torch_config("gpt-nano").replace(**kw)
    calls = []
    real = M.moe_mlp
    monkeypatch.setattr(M, "moe_mlp",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    arrs = np_params(cfg, seed=8)
    x, y = _inputs(cfg)
    for remat, want in ((False, 2), (True, 4), ("full", 4)):
        calls.clear()
        _torch_loss_grads(cfg, arrs, x, y, remat)
        assert len(calls) == want, (remat, len(calls))


def test_no_grad_forward_takes_the_plain_block():
    cfg = torch_config("gpt-nano").replace(remat=True)
    assert TM.block_body(cfg) is TS.block_selective
    with torch.no_grad():
        assert TM.block_body(cfg) is TM._block
    assert TM.block_body(cfg.replace(remat=False)) is TM._block


def test_gpt2_124m_4k_preset_reads_remat_true_and_the_loop_keeps_it(
        monkeypatch, tmp_path):
    """The loop's config: the preset's remat=True when TrainConfig.remat
    is None, else the TrainConfig's (the run stops once the config is
    built)."""
    assert torch_config("gpt2-124m-4k").remat is True
    assert jax_config("gpt2-124m-4k").remat is True

    class Built(Exception):
        pass

    def record(cfg, core_only=False):
        raise Built(cfg.remat, cfg.max_seq_len)

    monkeypatch.setattr(TL.PRM, "num_parameters", record)
    for remat, want in ((None, True), (False, False), ("full", "full")):
        with pytest.raises(Built) as e:
            TL.train(TL.TrainConfig(preset="gpt2-124m-4k", device="cpu",
                                    workdir=str(tmp_path), remat=remat))
        assert e.value.args == (want, 4096)


@pytest.mark.parametrize("argv,field,value", [
    ([], "remat", None), (["--remat"], "remat", True),
    (["--remat", "full"], "remat", "full"), (["--remat", "off"], "remat", False),
    (["--ema-decay", "0.999"], "ema_decay", 0.999),
    (["--ra-ops", "2", "--ra-mag", "0.5"], "ra_mag", 0.5),
    (["--profile-at", "3"], "profile_at", 3),
    ([], "async_ckpt", True)])
def test_cli_takes_the_loop_flags(argv, field, value, monkeypatch):
    got = []
    monkeypatch.setattr(TL, "train", lambda tc: got.append(tc) or {})
    cli.main(["--preset", "gpt-nano", "--cpu", "--steps", "1"] + argv)
    assert getattr(got[0], field) == value


def test_cli_mesh_still_raises_item_18(tmp_path):
    """--mesh cp=2 is ported: in one process (no torchrun) the CLI raises
    the two-rank mesh's error."""
    with pytest.raises(RuntimeError, match="one process a rank"):
        cli.main(["--preset", "gpt-nano", "--cpu", "--steps", "1",
                  "--mesh", "cp=2", "--workdir", str(tmp_path)])
