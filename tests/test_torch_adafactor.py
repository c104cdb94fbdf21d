"""PyTorch port: Adafactor (ops/adafactor.py), its training step and the
loop's side-tree resume against the JAX package, on the CPU.

  * `init_state`'s layout leaf for leaf on a small MoE model (C=128, so the
    per-layer matrices and the (L, E, 4C, C) expert slabs factor, while
    the (L, E, C) router and the stacked biases keep a full vf), and the
    state's bytes (also for gpt2-moe-8e, counted on the meta device);
  * three steps with relative step on and off, beta1 = 0 and 0.9, with and
    without the decay mask: parameters and every state leaf;
  * `make_dp_train_step_adafactor` against the JAX step on a one-device
    mesh (MoE, fp32): loss, parameters, state;
  * checkpoint_tree files in both directions; the loop's resume (2 + 2
    steps == 4 straight), its refusal of a state of another factoring
    layout and of the options the tree steps do not take, the port's loop
    resuming a JAX Adafactor run, and the CLI's new flags.

Tolerances: parameters and state after the steps rtol 1e-4, atol 5e-5,
the JAX DP parity test's (tests/test_adafactor.py: u = g rsqrt(v) turns
fp32 noise in a g near 0 into a sign; so after a step on real gradients
the packed qkv bias is compared on its q and v thirds, its k third's
gradient being exactly 0 in exact arithmetic); the loss rtol 2e-5; the
port's own resume is bitwise.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitrs_tpu import checkpoint_tree as JCT
from vitrs_tpu.ops import adafactor as JAF
from vitrs_tpu.ops import optimizer as JO
from vitrs_tpu.parallel import data_parallel as JDP
from vitrs_tpu.train import loop as JL
from vitrs_tpu_torch import checkpoint as TC
from vitrs_tpu_torch import checkpoint_tree as TCT
from vitrs_tpu_torch import params as TP
from vitrs_tpu_torch.cli import train as cli
from vitrs_tpu_torch.config import get_config as torch_config
from vitrs_tpu_torch.ops import adafactor as TAF
from vitrs_tpu_torch.ops import optimizer as TO
from vitrs_tpu_torch.parallel import data_parallel as TDP
from vitrs_tpu_torch.train import loop as TL

from test_torch_helpers import np_params, small_cfgs

MOE = dict(vocab_size=97, num_experts=4, moe_top_k=2, moe_cap_factor=1.0)
FIELDS = ("vr", "vc", "vf", "m")


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=1e-4,
                               atol=5e-5, err_msg=what)


def _assert_states(ts, js):
    for f in FIELDS:
        tree, jtree = getattr(ts, f), getattr(js, f)
        assert set(tree) == set(jtree), f
        for k in jtree:
            _close(tree[k].numpy(), jtree[k], f"{f}[{k}]")


def test_init_state_layout_matches_jax():
    jcfg, tcfg = small_cfgs(**MOE)
    arrs = np_params(tcfg)
    for beta1 in (0.0, 0.9):
        ts = TAF.init_state(TP.from_numpy(arrs, tcfg, "cpu"), beta1=beta1)
        js = JAF.init_state({k: jnp.asarray(v) for k, v in arrs.items()},
                            beta1=beta1)
        for f in FIELDS:
            assert {k: tuple(v.shape) for k, v in getattr(ts, f).items()} \
                == {k: tuple(v.shape) for k, v in getattr(js, f).items()}, f
        assert TAF.state_bytes(ts) == JAF.state_bytes(js)
    # per-matrix factoring of the expert slabs; the router keeps a full vf
    assert ts.vr["fcw"].shape == (2, 4, 512) and ts.vc["fcw"].shape == (2, 4, 128)
    assert ts.vf["routerw"].shape == (2, 4, 128) and ts.vr["routerw"].dim() == 0
    assert ts.vf["fcb"].shape == (2, 4, 512)


def test_state_bytes_of_the_moe_bench_row():
    """gpt2-moe-8e: the factored state against AdamW's m + v (2 x 4 bytes a
    parameter, 4.17 GB), counted on the meta device."""
    cfg = torch_config("gpt2-moe-8e")
    meta = {k: torch.empty(s, device="meta")
            for k, s in TP.param_shapes(cfg).items()}
    got = TAF.state_bytes(TAF.init_state(meta))
    want = JAF.state_bytes(jax.eval_shape(JAF.init_state, {
        k: jax.ShapeDtypeStruct(s, jnp.float32)
        for k, s in TP.param_shapes(cfg).items()}))
    assert got == want
    assert 8 * TP.num_parameters(cfg) == 4_169_582_592
    assert got == 5_452_212          # 0.13% of AdamW's m + v


@pytest.mark.parametrize("relative_step,beta1,mask", [
    (True, 0.0, True), (False, 0.9, False), (True, 0.9, True)],
    ids=["relative", "absolute-momentum", "relative-momentum"])
def test_three_steps_match_jax(relative_step, beta1, mask):
    jcfg, tcfg = small_cfgs(**MOE)
    arrs = np_params(tcfg, 1)
    rng = np.random.default_rng(1)
    grads = [{k: (0.01 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in arrs.items()} for _ in range(3)]
    jp = {k: jnp.asarray(v) for k, v in arrs.items()}
    tp = TP.from_numpy(arrs, tcfg, "cpu")
    js = JAF.init_state(jp, beta1=beta1)
    ts = TAF.init_state(tp, beta1=beta1)
    for t, g in enumerate(grads, 1):
        jp, js = JAF.step(jp, {k: jnp.asarray(v) for k, v in g.items()}, js,
                          jnp.asarray(t), 1e-2, beta1=beta1,
                          weight_decay=0.1,
                          decay_mask=JO.decay_mask_2d(jp) if mask else None,
                          relative_step=relative_step)
        tp, ts = TAF.step(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                          ts, t, 1e-2, beta1=beta1, weight_decay=0.1,
                          decay_mask=TO.decay_mask_2d(tp) if mask else None,
                          relative_step=relative_step)
    for k in arrs:
        _close(tp[k].numpy(), jp[k], k)
        assert np.abs(tp[k].numpy() - arrs[k]).max() > 1e-5, f"{k} moved"
    _assert_states(ts, js)


def test_dp_adafactor_step_matches_jax():
    jcfg, tcfg = small_cfgs(**MOE)
    arrs = np_params(tcfg, 2)
    rng = np.random.default_rng(2)
    x = rng.integers(0, 97, (2, 64)).astype(np.int32)
    y = rng.integers(0, 97, (2, 64)).astype(np.int32)
    mesh = JDP.make_mesh(1)
    jparams = {k: jnp.asarray(v) for k, v in arrs.items()}
    jp, js, jloss = JDP.make_dp_train_step_adafactor(jcfg, mesh)(
        JDP.replicate(jparams, mesh),
        JDP.replicate(JAF.init_state(jparams), mesh),
        JDP.shard_batch(jnp.asarray(x), mesh),
        JDP.shard_batch(jnp.asarray(y), mesh), jnp.asarray(1, jnp.int32),
        jnp.asarray(1e-2, jnp.float32), jnp.asarray(0.1, jnp.float32))
    flat = TP.flatten_params(TP.from_numpy(arrs, tcfg, "cpu"), tcfg)
    params = TP.unflatten_params(flat, tcfg)
    step = TDP.make_dp_train_step_adafactor(tcfg,
                                            TDP.make_mesh(devices=["cpu"]))
    params, ts, loss = step(params, TAF.init_state(params), x, y, 1, 1e-2,
                            0.1)
    assert TP.flat_base(params, tcfg) is flat, "updated in place"
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-5)
    C = tcfg.channels
    for k in arrs:
        got, want = params[k].detach().numpy(), np.asarray(jp[k])
        if k == "qkvb":
            # the k third's gradient is exactly 0 in exact arithmetic, so
            # both packages step on fp32 noise there, which u = g rsqrt(v)
            # scales to a full step (ROADMAP.md Queue 3 #4): the q and v
            # thirds are compared
            got, want = (np.concatenate([a[:, :C], a[:, 2 * C:]], -1)
                         for a in (got, want))
        _close(got, want, k)
    _assert_states(ts, jax.device_get(js))


def test_checkpoint_tree_files_load_in_both_directions(tmp_path):
    rng = np.random.default_rng(3)
    tree = {"vr": {"fcw": rng.standard_normal((2, 4, 8)).astype(np.float32),
                   "wte": np.zeros((), np.float32)},
            "vf": {"ln1w": rng.standard_normal((2, 8)).astype(np.float32)},
            "m": {}}
    for write, read in ((TCT, JCT), (JCT, TCT)):
        path = str(tmp_path / f"{write.__name__}.tree")
        write.save_tree(path, tree, meta={"step": 3, "cursor": 48})
        got, meta = read.load_tree(path)
        assert meta == {"step": 3, "cursor": 48} and "m" not in got
        for f in ("vr", "vf"):
            assert set(got[f]) == set(tree[f])
            for k, v in tree[f].items():
                np.testing.assert_array_equal(got[f][k], v)
                assert got[f][k].shape == v.shape
    with open(path, "r+b") as f:
        f.write(b"\0\0\0\0")
    with pytest.raises(ValueError, match="magic"):
        TCT.load_tree(path)


def _run(workdir, steps=4, **kw):
    tc = TL.TrainConfig(preset="gpt-nano", dataset="", steps=steps,
                        batch_size=4, lr=1e-2, warmup=2, dtype="float32",
                        log_every=1, ckpt_every=2, seed=3,
                        optimizer="adafactor", device="cpu",
                        workdir=str(workdir), **kw)
    return TL.train(tc)


def _params_at(workdir, step):
    return TC.load_checkpoint(os.path.join(workdir,
                                           f"ckpt_{step:08d}.bin"))[0]


def test_loop_adafactor_resume_is_bitwise(tmp_path):
    """2 + 2 steps through the side tree == 4 straight: the tree holds
    vr/vc/vf (no m at beta1 = 0) and the data cursor in its meta."""
    straight = tmp_path / "straight"
    _run(straight)
    assert os.path.exists(straight / "adafactor_00000002.tree")
    tree, meta = TCT.load_tree(str(straight / "adafactor_00000004.tree"))
    assert set(tree) == {"vr", "vc", "vf"} and meta == {"step": 4,
                                                        "cursor": 16}
    assert TC.load_checkpoint(str(straight / "ckpt_00000004.bin"))[2]["m"] \
        is None
    resumed = tmp_path / "resumed"
    shutil.copytree(straight, resumed)
    for name in ("ckpt_00000004.bin", "adafactor_00000004.tree"):
        os.remove(resumed / name)
    _run(resumed)
    a, b = _params_at(straight, 4), _params_at(resumed, 4)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_loop_refuses_an_adafactor_tree_of_another_layout(tmp_path):
    _run(tmp_path, steps=2)
    path = str(tmp_path / "adafactor_00000002.tree")
    tree, meta = TCT.load_tree(path)
    # a leaf written as if it were factored: its vf a 0-d placeholder
    tree["vf"]["ln1w"] = np.zeros((), np.float32)
    TCT.save_tree(path, tree, meta)
    with pytest.raises(ValueError, match="factoring layout"):
        _run(tmp_path, steps=4)


@pytest.mark.parametrize("optimizer", ["adafactor", "muon"])
@pytest.mark.parametrize("field,value", [
    ("accum_steps", 2), ("mixup_alpha", 0.2), ("log_grad_norm", True)])
def test_tree_optimizers_refuse_what_their_step_lacks(tmp_path, optimizer,
                                                      field, value):
    tc = TL.TrainConfig(preset="gpt-nano", steps=1, device="cpu",
                        optimizer=optimizer, workdir=str(tmp_path))
    setattr(tc, field, value)
    with pytest.raises(ValueError, match="lean step"):
        TL.train(tc)


def test_loop_refuses_an_unknown_optimizer(tmp_path):
    with pytest.raises(ValueError, match="unknown optimizer"):
        TL.train(TL.TrainConfig(preset="gpt-nano", steps=1, device="cpu",
                                optimizer="lion", workdir=str(tmp_path)))


def test_port_loop_resumes_a_jax_adafactor_run(tmp_path):
    """The JAX loop trains 2 of 4 steps (its .bin without m/v and its
    adafactor_00000002.tree), the port's loop takes steps 3-4 from there
    and lands where the JAX loop's straight run does."""
    common = dict(preset="gpt-nano", dataset="tokens", steps=4,
                  batch_size=4, lr=1e-2, warmup=2, dtype="float32",
                  log_every=1, seed=3, optimizer="adafactor", n_devices=1,
                  async_ckpt=False, model_overrides=dict(use_flash=False))
    straight, half = tmp_path / "jax4", tmp_path / "jax2"
    JL.train(JL.TrainConfig(workdir=str(straight), ckpt_every=4, **common))
    JL.train(JL.TrainConfig(workdir=str(half), ckpt_every=2, run_steps=2,
                            **common))
    assert os.path.exists(half / "adafactor_00000002.tree")
    summary = _run(half)
    assert np.isfinite(summary["final_loss"])
    want, got = _params_at(straight, 4), _params_at(half, 4)
    for k in want:
        _close(got[k], want[k], k)


def test_train_cli_moe_adafactor_on_the_cpu(tmp_path, capsys):
    cli.main(["--preset", "gpt-nano", "--num-experts", "4", "--moe-top-k",
              "2", "--optimizer", "adafactor", "--lr", "1e-2", "--cpu",
              "--steps", "3", "--batch-size", "4", "--dtype", "float32",
              "--log-every", "1", "--dataset", "", "--warmup", "1",
              "--workdir", str(tmp_path)])
    assert "[done]" in capsys.readouterr().out
    _, cfg, extras = TC.load_checkpoint(str(tmp_path / "ckpt_00000003.bin"))
    assert (cfg.num_experts, cfg.moe_top_k, extras["step"]) == (4, 2, 3)
    assert os.path.exists(tmp_path / "adafactor_00000003.tree")
