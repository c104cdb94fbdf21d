"""PyTorch port: Muon (ops/muon.py), its training step and the loop's
side-tree resume against the JAX package, on the CPU.

  * `newton_schulz5` bitwise against the JAX chain on small matrices (wide,
    tall and stacked), and close to it on an expert slab; that it
    orthogonalises an ill-conditioned matrix;
  * the hybrid split; three steps of the hybrid Muon/AdamW update on a
    small MoE model, and `make_dp_train_step_muon` (clip 1.0) against the
    JAX step on a one-device mesh;
  * the loop's resume (2 + 2 steps == 4 straight) and the CLI's flags.

Tolerances, from the observed error: the chain is bf16 products with fp32
accumulation, and sums over more than about 128 terms run in another order
in the two packages, which flips a bf16 rounding now and then and grows
over five iterations (a (2, 4, 512, 128) slab: 40% of values differ, by up
to 8 bf16 ulps; three steps on the small MoE model: the matrices differ
by up to 3.6e-4 where the steps move them by up to 1.7e-2).  So the Muon
matrices are held within 1e-3 absolute (a wiring fault, such as a lost
aspect scale, Nesterov term or decay, moves them by the order of the
update), the AdamW tensors at rtol 2e-5, atol 1e-6, or the AdamW lr where
the gradient is fp32 noise (|g| < 1e-6, as tests/test_torch_train.py); the
port's own resume is bitwise.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitrs_tpu.ops import muon as JMU
from vitrs_tpu.parallel import data_parallel as JDP
from vitrs_tpu_torch import checkpoint as TC
from vitrs_tpu_torch import checkpoint_tree as TCT
from vitrs_tpu_torch import params as TP
from vitrs_tpu_torch.cli import train as cli
from vitrs_tpu_torch.ops import muon as TMU
from vitrs_tpu_torch.parallel import data_parallel as TDP
from vitrs_tpu_torch.train import loop as TL

from test_torch_helpers import np_params, small_cfgs

MOE = dict(vocab_size=97, num_experts=4, moe_top_k=2, moe_cap_factor=1.0)


def _ns_both(g):
    want = np.asarray(JMU.newton_schulz5(jnp.asarray(g)).astype(jnp.float32))
    got = TMU.newton_schulz5(torch.from_numpy(g))
    assert got.dtype == torch.bfloat16 and got.shape == g.shape
    return got.float().numpy(), want


@pytest.mark.parametrize("shape", [(48, 32), (32, 48), (3, 16, 24),
                                   (2, 4, 64, 32)])
def test_newton_schulz_matches_jax_bitwise(shape):
    g = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got, want = _ns_both(g)
    np.testing.assert_array_equal(got, want)


def test_newton_schulz_on_an_expert_slab_stays_near_jax():
    g = np.random.default_rng(1).standard_normal((2, 4, 512, 128)).astype(
        np.float32)
    got, want = _ns_both(g)
    np.testing.assert_allclose(got, want, rtol=0, atol=8 * 2 ** -10)


def test_newton_schulz_orthogonalizes():
    rng = np.random.default_rng(0)
    u, _ = np.linalg.qr(rng.standard_normal((32, 32)))
    vt, _ = np.linalg.qr(rng.standard_normal((48, 48)))
    s = np.geomspace(0.01, 1.0, 32)
    g = ((u * s) @ vt[:32]).astype(np.float32)
    sv = np.linalg.svd(TMU.newton_schulz5(torch.from_numpy(g)).float().numpy(),
                       compute_uv=False)
    assert sv.min() > 0.3 and sv.max() < 1.6 and np.median(sv) > 0.7, sv


def test_split_policy_matches_jax():
    _, tcfg = small_cfgs(**MOE)
    arrs = np_params(tcfg)
    mu, rest = TMU.split_muon(TP.from_numpy(arrs, tcfg, "cpu"))
    jmu, jrest = JMU.split_muon(arrs)
    assert set(mu) == set(jmu) == {"qkvw", "attprojw", "fcw", "fcprojw"}
    assert set(rest) == set(jrest) and "routerw" in rest


def _assert_params(got, want, start, grads=None, alr=0.0):
    """grads, alr: the step's gradients and AdamW lr, where AdamW from zero
    moments moves a value by alr g / (|g| + eps): where |g| < 1e-6 (fp32
    noise) a tiny difference in g moves it by up to alr, so those values
    are held within alr (tests/test_torch_train.py's rule)."""
    for k, w in want.items():
        g = got[k].detach().float().numpy()
        w = np.asarray(w)
        if k in TMU.MUON_KEYS:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-3, err_msg=k)
            assert np.abs(g - start[k]).max() > 3e-3, f"{k} barely moved"
            continue
        atol = np.full(w.shape, 1e-6, np.float32)
        if grads is not None:
            atol[np.abs(grads[k]) < 1e-6] = alr
        bad = np.abs(g - w) > atol + 2e-5 * np.abs(w)
        assert not bad.any(), (f"{k}: {bad.sum()} of {w.size} values "
                               f"differ, max {np.abs(g - w)[bad].max():.3e}")


def test_three_steps_match_jax():
    _, tcfg = small_cfgs(**MOE)
    arrs = np_params(tcfg, 2)
    rng = np.random.default_rng(2)
    grads = [{k: (0.01 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in arrs.items()} for _ in range(3)]
    jp = {k: jnp.asarray(v) for k, v in arrs.items()}
    tp = TP.from_numpy(arrs, tcfg, "cpu")
    js, ts = JMU.init_state(jp), TMU.init_state(tp)
    for t, g in enumerate(grads, 1):
        jp, js = JMU.step(jp, {k: jnp.asarray(v) for k, v in g.items()}, js,
                          jnp.asarray(t), 0.02, adamw_lr=1e-3,
                          weight_decay=0.1)
        tp, ts = TMU.step(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                          ts, t, 0.02, adamw_lr=1e-3, weight_decay=0.1)
    _assert_params(tp, jp, arrs)
    for f in ("momentum", "m", "v"):
        for k, w in getattr(js, f).items():
            np.testing.assert_allclose(getattr(ts, f)[k].numpy(),
                                       np.asarray(w), rtol=2e-5, atol=1e-9,
                                       err_msg=f"{f}[{k}]")


def test_dp_muon_step_matches_jax():
    jcfg, tcfg = small_cfgs(**MOE)
    arrs = np_params(tcfg, 3)
    rng = np.random.default_rng(3)
    x = rng.integers(0, 97, (2, 64)).astype(np.int32)
    y = rng.integers(0, 97, (2, 64)).astype(np.int32)
    mesh = JDP.make_mesh(1)
    jparams = {k: jnp.asarray(v) for k, v in arrs.items()}
    jp, _, jloss = JDP.make_dp_train_step_muon(jcfg, mesh, clip_norm=1.0,
                                               weight_decay=0.1)(
        JDP.replicate(jparams, mesh),
        JDP.replicate(JMU.init_state(jparams), mesh),
        JDP.shard_batch(jnp.asarray(x), mesh),
        JDP.shard_batch(jnp.asarray(y), mesh), jnp.asarray(0, jnp.int32),
        jnp.asarray(0.02, jnp.float32), jnp.asarray(1e-3, jnp.float32))
    flat = TP.flatten_params(TP.from_numpy(arrs, tcfg, "cpu"), tcfg)
    params = TP.unflatten_params(flat, tcfg)
    step = TDP.make_dp_train_step_muon(tcfg, TDP.make_mesh(devices=["cpu"]),
                                       clip_norm=1.0, weight_decay=0.1)
    params, state, loss = step(params, TMU.init_state(params), x, y, 0,
                               0.02, 1e-3)
    assert TP.flat_base(params, tcfg) is flat, "updated in place"
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-5)
    grads = {k: t.grad.numpy() for k, t in params.items()}
    _assert_params(params, jax.device_get(jp), arrs, grads, 1e-3)


def _run(workdir, steps=4):
    tc = TL.TrainConfig(preset="gpt-nano", dataset="", steps=steps,
                        batch_size=4, lr=0.02, muon_adamw_lr=1e-3,
                        clip_norm=1.0, warmup=2, dtype="float32",
                        log_every=1, ckpt_every=2, seed=3, optimizer="muon",
                        device="cpu", workdir=str(workdir))
    return TL.train(tc)


def test_loop_muon_resume_is_bitwise(tmp_path):
    straight = tmp_path / "straight"
    _run(straight)
    tree, meta = TCT.load_tree(str(straight / "muon_00000004.tree"))
    assert set(tree) == {"momentum", "m", "v"}
    assert set(tree["momentum"]) == {"qkvw", "attprojw", "fcw", "fcprojw"}
    assert meta == {"step": 4, "cursor": 16}
    resumed = tmp_path / "resumed"
    shutil.copytree(straight, resumed)
    for name in ("ckpt_00000004.bin", "muon_00000004.tree"):
        os.remove(resumed / name)
    _run(resumed)
    a = TC.load_checkpoint(str(straight / "ckpt_00000004.bin"))[0]
    b = TC.load_checkpoint(str(resumed / "ckpt_00000004.bin"))[0]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_train_cli_muon_on_the_cpu(tmp_path, capsys):
    cli.main(["--preset", "gpt-nano", "--optimizer", "muon", "--lr", "0.02",
              "--muon-adamw-lr", "1e-3", "--cpu", "--steps", "3",
              "--batch-size", "4", "--log-every", "1", "--dataset", "",
              "--warmup", "1", "--workdir", str(tmp_path)])
    assert "[done]" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "muon_00000003.tree")
