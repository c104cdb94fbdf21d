"""PyTorch port: LoRA (models/lora.py, cli/finetune.py) against the JAX
package, on the CPU, fp32.  Base parameters and adapters are numpy arrays
handed to both packages (`params.from_numpy` carries a LoRA tree).

Tolerances: the merged weights rtol 2e-5 (an fp32 product of rank r, summed
in another order); losses rtol 2e-5; the adapters' gradients rtol 5e-4 with
atol 2e-5 of their largest value; the adapters after one AdamW step within
1e-3 of the step's size lr, or within 2 lr where the gradient is under
1e-4 of its largest value (AdamW's first step moves a value by
lr g / (|g| + 1e-8): fp32 noise in a g near 0 can move it anywhere in
(-lr, lr)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitrs_tpu import checkpoint as JC
from vitrs_tpu import checkpoint_tree as JCT
from vitrs_tpu.models import lora as JLO
from vitrs_tpu.models import model as JM
from vitrs_tpu_torch import checkpoint as TC
from vitrs_tpu_torch import checkpoint_tree as TCT
from vitrs_tpu_torch import params as TP
from vitrs_tpu_torch.cli import finetune
from vitrs_tpu_torch.models import lora as TLO
from vitrs_tpu_torch.models import model as TM

from test_torch_helpers import np_params, small_cfgs
from test_torch_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NANO = dict(num_layers=2, num_heads=2, channels=32, vocab_size=97,
            max_seq_len=16, dtype="float32", use_flash=False)
JCFG, TCFG = small_cfgs(**NANO)
J_STEP = jax.jit(JLO.lora_train_step.__wrapped__,
                 static_argnames=("cfg", "alpha", "lr", "weight_decay"))
J_GRAD = jax.jit(jax.grad(lambda lo, p, x, y, cfg: JM.loss_fn(
    JLO.apply_lora(p, lo), x, y, cfg)), static_argnums=4)


def _adapters(cfg, rank=4, seed=1, zero_b=False):
    """A ~ N(0, 0.02) and B ~ N(0, 0.02) (0 with zero_b) as numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in TLO.LORA_TARGETS:
        L, OC, IC = TP.param_shapes(cfg)[name]
        out[name + "_a"] = (0.02 * rng.standard_normal((L, rank, IC))
                            ).astype(np.float32)
        out[name + "_b"] = (np.zeros((L, OC, rank), np.float32) if zero_b
                            else (0.02 * rng.standard_normal((L, OC, rank))
                                  ).astype(np.float32))
    return out


def _both(cfg_pair, seed=0, **kw):
    jcfg, tcfg = cfg_pair
    base = np_params(tcfg, seed)
    lora = _adapters(tcfg, **kw)
    return (base, lora,
            {k: jnp.asarray(v) for k, v in base.items()},
            {k: jnp.asarray(v) for k, v in lora.items()},
            TP.from_numpy(base, tcfg, "cpu"), TP.from_numpy(lora, tcfg, "cpu"))


def _data(cfg, seed=0, B=4, T=16):
    x = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T))
    return x, np.roll(x, -1, axis=1)


def test_zero_init_is_identity():
    tp = TP.init_params(TCFG, torch.Generator().manual_seed(0))
    lora = TLO.init_lora(TCFG, torch.Generator().manual_seed(1), rank=4)
    assert lora["qkvw_a"].shape == (2, 4, 32) and not lora["qkvw_b"].any()
    merged = TLO.apply_lora(tp, lora)
    for k in tp:
        assert torch.equal(merged[k], tp[k]), k
    x = torch.as_tensor(_data(TCFG)[0])
    assert torch.equal(
        TM.gpt_forward(TM.prepare_params(merged, TCFG), x, TCFG),
        TM.gpt_forward(TM.prepare_params(tp, TCFG), x, TCFG))


def test_apply_and_merge_lora_match_jax():
    _, _, jp, jl, tp, tl = _both((JCFG, TCFG))
    want = JLO.apply_lora(jp, jl, alpha=8.0)
    got = TLO.apply_lora(tp, tl, alpha=8.0)
    merged = TLO.merge_lora(tp, tl, alpha=8.0)
    assert TLO.lora_rank(tl) == 4
    for k in TP.tensor_order(TCFG):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]),
                                   rtol=2e-5, atol=1e-7, err_msg=k)
        assert torch.equal(merged[k], got[k].detach())
        assert not merged[k].requires_grad
    for k in ("wte", "ln1w", "qkvb"):          # not adapted: the same tensor
        assert got[k] is tp[k]


def _step_both(cfg_pair, steps=1, lr=1e-2, seed=0):
    """`steps` lora_train_steps in each package from the same base and
    adapters: (the losses, the final adapters) of each."""
    jcfg, tcfg = cfg_pair
    _, _, jp, jl, tp, tl = _both(cfg_pair, seed=seed)
    x, y = _data(tcfg, seed)
    jm, jv = JLO.init_lora_opt(jl)
    tm, tv = TLO.init_lora_opt(tl)
    jlosses, tlosses = [], []
    for s in range(steps):
        loss, jl, jm, jv = J_STEP(jl, jm, jv, jnp.asarray(s), jp,
                                  jnp.asarray(x), jnp.asarray(y), cfg=jcfg,
                                  lr=lr, alpha=16.0, weight_decay=0.01)
        jlosses.append(float(loss))
        loss, tl, tm, tv = TLO.lora_train_step(
            tl, tm, tv, s, tp, torch.as_tensor(x), torch.as_tensor(y), tcfg,
            lr=lr, alpha=16.0, weight_decay=0.01)
        tlosses.append(float(loss))
    return jlosses, tlosses, jl, tl, tp, (tm, tv)


def _grads(cfg_pair, seed=0):
    """The adapters' gradients of the first step's loss, each package."""
    jcfg, tcfg = cfg_pair
    _, _, jp, jl, tp, tl = _both(cfg_pair, seed=seed)
    x, y = _data(tcfg, seed)
    jg = J_GRAD(jl, jp, jnp.asarray(x), jnp.asarray(y), jcfg)
    leaves = {k: t.clone().requires_grad_(True) for k, t in tl.items()}
    TM.loss_fn(TLO.apply_lora(tp, leaves), torch.as_tensor(x),
               torch.as_tensor(y), tcfg).backward()
    return jg, {k: t.grad for k, t in leaves.items()}


def _adapters_close(cfg_pair, tl, jl, lr):
    jg, tg = _grads(cfg_pair)
    for k, t in tl.items():
        w, g = np.asarray(jg[k]), tg[k].numpy()
        top = np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=5e-4, atol=2e-5 * top,
                                   err_msg=f"d{k}")
        d = np.abs(t.numpy() - np.asarray(jl[k]))
        near0 = np.abs(g) < 1e-4 * top
        assert d[~near0].max() <= 1e-3 * lr, (k, d[~near0].max())
        assert d.max() <= 2 * lr, k


def test_lora_train_step_loss_and_adapter_update_match_jax():
    base = np_params(TCFG, 0)
    lr = 1e-2
    jlosses, tlosses, jl, tl, tp, (tm, tv) = _step_both((JCFG, TCFG), lr=lr)
    np.testing.assert_allclose(tlosses, jlosses, rtol=2e-5)
    start = _adapters(TCFG)
    for k, t in tl.items():
        moved = np.abs(t.numpy() - start[k])
        assert moved.max() > 0.5 * lr, k       # every tensor took its step
    _adapters_close((JCFG, TCFG), tl, jl, lr)
    # the base is frozen: unchanged bit for bit, no gradient, no state
    for k, t in tp.items():
        assert np.array_equal(t.numpy(), base[k]), k
        assert not t.requires_grad and t.grad is None, k
    assert set(tm) == set(tv) == set(tl)


@pytest.mark.parametrize("overrides", [
    dict(num_kv_heads=1, pos_emb="rope"),
    dict(num_kv_heads=2, pos_emb="rope", num_heads=4, channels=256)],
    ids=["mqa-rope-D64-flash", "gqa-rope-D64-flash"])
def test_lora_composes_with_gqa_and_rope(overrides):
    """At head_dim 64 the port's step runs the fused qkv op over K3's plain
    versions (the JAX package is dense on the CPU): the first step's
    adapters as JAX's, and over 3 steps the losses as JAX's, falling.
    (Later steps' adapters are not compared: Adam's moments carry a value
    whose gradient sits near 0 by up to lr a step either way.)"""
    pair = small_cfgs(dtype="float32", max_seq_len=16, **overrides)
    assert pair[1].qkv_dim < 3 * pair[1].channels
    lr = 3e-3
    _, _, jl, tl, _, _ = _step_both(pair, steps=1, lr=lr)
    assert tl["qkvw_b"].shape == (pair[1].num_layers, pair[1].qkv_dim, 4)
    _adapters_close(pair, tl, jl, lr)
    jlosses, tlosses, _, _, _, _ = _step_both(pair, steps=3, lr=lr)
    np.testing.assert_allclose(tlosses, jlosses, rtol=2e-5)
    assert tlosses[-1] < tlosses[0]


def test_adapter_tree_round_trips_both_ways(tmp_path):
    lora = _adapters(TCFG)
    JCT.save_tree(str(tmp_path / "jax.tree"), lora, meta={"rank": 4})
    tree, meta = TCT.load_tree(str(tmp_path / "jax.tree"))
    back = TP.from_numpy(tree, TCFG, "cpu")
    assert meta["rank"] == 4 and set(back) == set(lora)
    for k, v in lora.items():
        assert back[k].dtype == torch.float32
        np.testing.assert_array_equal(back[k].numpy(), v)
    TCT.save_tree(str(tmp_path / "torch.tree"), TP.to_numpy(back, TCFG))
    jtree, _ = JCT.load_tree(str(tmp_path / "torch.tree"))
    for k, v in lora.items():
        np.testing.assert_array_equal(jtree[k], v)
    with pytest.raises(ValueError, match="fcw_b"):
        bad = dict(tree, fcw_b=tree["fcw_b"][:, :-1])
        TP.from_numpy(bad, TCFG, "cpu")


def test_finetune_cli_adapters_merge_and_resume(tmp_path):
    """vitrs-finetune-torch on a gpt-nano base written by the port: the
    adapter file, --merge's checkpoint reloading (in both packages) to the
    logits of apply_lora, and --resume continuing from the adapter file."""
    base = str(tmp_path / "base.bin")
    arrs = np_params(TCFG, 3)
    TC.save_checkpoint(base, TP.from_numpy(arrs, TCFG, "cpu"), TCFG)
    out, merged = str(tmp_path / "a.tree"), str(tmp_path / "merged.bin")
    s = finetune.main(["--ckpt", base, "--cpu", "--steps", "3",
                       "--batch-size", "2", "--rank", "2", "--lr", "1e-2",
                       "--warmup", "1", "--out", out, "--merge", merged,
                       "--log-every", "1"])
    assert s["adapter_params"] == sum(t.numel() for t in s["lora"].values())
    assert len(s["losses"]) == 3 and np.isfinite(s["val_loss"])
    for k, t in s["base"].items():
        assert np.array_equal(t.numpy(), arrs[k]) and t.grad is None, k
    tree, meta = TCT.load_tree(out)
    assert meta["rank"] == 2 and meta["steps"] == 3
    x = torch.as_tensor(_data(TCFG, 4)[0])
    want = TM.gpt_forward(TM.prepare_params(
        TLO.apply_lora(s["base"], s["lora"]), TCFG), x, TCFG)
    tarrs, tcfg, _ = TC.load_checkpoint(merged)
    got = TM.gpt_forward(TM.prepare_params(
        TP.from_numpy(tarrs, tcfg, "cpu"), TCFG), x, TCFG)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    jarrs, _, _ = JC.load_checkpoint(merged)
    jlog = JM.gpt_forward({k: jnp.asarray(v) for k, v in jarrs.items()},
                          jnp.asarray(x.numpy()), JCFG)
    np.testing.assert_allclose(np.asarray(jlog), want.numpy(), rtol=1e-4,
                               atol=1e-5)
    r = finetune.main(["--ckpt", base, "--cpu", "--steps", "1",
                       "--batch-size", "2", "--resume", out,
                       "--out", str(tmp_path / "b.tree")])
    assert r["adapter_params"] == s["adapter_params"]
