"""FSDP (fsdp=2) and hybrid FSDP (dp=2,fsdp=2) on gloo CPU ranks
(tests/torch_dist_worker.py, one spawn a mesh) against the JAX package's
GSPMD steps on 2- and 4-device meshes, with AdamW, Adafactor and Muon, one
step each from the same numpy parameters and global batch; and the
sharding rule `spec_for` against JAX's for every preset.  Tolerances: the
AdamW step's are tests/test_fsdp.py's hybrid test's; Adafactor's and
Muon's are their JAX FSDP tests' (tests/test_adafactor.py,
tests/test_muon_parallel.py), whose reasons hold here too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vitrs_tpu.models import model as JM
from vitrs_tpu.parallel import fsdp as JFS
from vitrs_tpu.parallel import muon_parallel as JMP
from vitrs_tpu_torch import config as TC
from vitrs_tpu_torch import params as TPRM
from vitrs_tpu_torch.parallel import fsdp as TFS
from test_torch_helpers import (SMALL, assert_params_close, np_params,
                                small_cfgs, spawn_ranks)

OVR = dict(SMALL, max_seq_len=16)
B = 8
MESHES = {"fsdp=2": 2, "dp=2,fsdp=2": 4}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jcfg, tcfg = small_cfgs(**OVR)
    jcfg = jcfg.replace(use_flash=False)
    arrs = np_params(tcfg, seed=6)
    rng = np.random.default_rng(6)
    x = rng.integers(0, 97, (B, 16)).astype(np.int32)
    y = rng.integers(0, 97, (B, 16)).astype(np.int32)
    inputs = {**{"p/" + k: v for k, v in arrs.items()}, "x": x, "y": y}
    outs = {m: spawn_ranks("fsdp", n, tmp_path_factory.mktemp("fsdp"),
                           {"preset": "gpt-nano", "overrides": OVR,
                            "mesh": m}, inputs)
            for m, n in MESHES.items()}
    grads = jax.device_get(jax.jit(jax.grad(JM.loss_fn), static_argnums=3)(
        _params(arrs), jnp.asarray(x), jnp.asarray(y), jcfg))
    return jcfg, tcfg, arrs, x, y, outs, grads


def _jax_mesh(name):
    return (JFS.make_mesh(2) if name == "fsdp=2"
            else JFS.make_hybrid_mesh(2, 2))


def _params(arrs):
    return {k: jnp.array(v) for k, v in arrs.items()}


def _got(out, opt):
    pre = f"{opt}/p/"
    return {k[len(pre):]: v for k, v in out.items() if k.startswith(pre)}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_fsdp_adamw_step_matches_jax(run, mesh):
    jcfg, tcfg, arrs, x, y, outs, grads = run
    jm = _jax_mesh(mesh)
    params = _params(arrs)
    step = JFS.make_fsdp_train_step(jcfg, jm, params, weight_decay=0.1)
    pf = JFS.place_params(params, jm)
    mf, vf = JFS.init_opt_state(pf, jm)
    jp, _, _, jloss = step(pf, mf, vf, jnp.asarray(x), jnp.asarray(y),
                           jnp.asarray(1, jnp.int32),
                           jnp.asarray(1e-3, jnp.float32))
    for out in outs[mesh]:
        np.testing.assert_allclose(out["adamw/loss"], float(jloss), rtol=1e-6)
        assert_params_close(_got(out, "adamw"), jax.device_get(jp), tcfg,
                            rtol=2e-6, atol=1e-7,
                            grads=grads, lr=1e-3)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_fsdp_adafactor_step_matches_jax(run, mesh):
    jcfg, tcfg, arrs, x, y, outs, grads = run
    jm = _jax_mesh(mesh)
    placed = JFS.place_params(_params(arrs), jm)
    st = JFS.init_af_state(placed, jm)
    step = JFS.make_fsdp_train_step_adafactor(jcfg, jm, placed)
    jp, _, jloss = step(placed, st, jnp.asarray(x), jnp.asarray(y),
                        jnp.asarray(1, jnp.int32),
                        jnp.asarray(0.01, jnp.float32),
                        jnp.asarray(0.1, jnp.float32))
    for out in outs[mesh]:
        np.testing.assert_allclose(out["adafactor/loss"], float(jloss),
                                   rtol=1e-6)
        assert_params_close(_got(out, "adafactor"), jax.device_get(jp), tcfg,
                            rtol=1e-4, atol=2e-4)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_fsdp_muon_step_matches_jax(run, mesh):
    jcfg, tcfg, arrs, x, y, outs, grads = run
    jm = _jax_mesh(mesh)
    params = _params(arrs)
    step = JMP.make_fsdp_muon_train_step(jcfg, jm, params)
    fp = JFS.place_params(params, jm)
    jp, _, jloss = step(fp, JMP.init_fsdp_muon_state(fp, jm),
                        jnp.asarray(x), jnp.asarray(y),
                        jnp.asarray(0, jnp.int32),
                        jnp.asarray(0.02, jnp.float32),
                        jnp.asarray(3e-3, jnp.float32))
    # between the packages the bf16 Newton-Schulz is held to
    # tests/test_torch_muon.py's 1e-3 (a last-bit difference in the
    # momentum can round a bf16 product the other way)
    for out in outs[mesh]:
        np.testing.assert_allclose(out["muon/loss"], float(jloss), rtol=1e-6)
        assert_params_close(_got(out, "muon"), jax.device_get(jp), tcfg,
                            rtol=2e-3, atol=1e-3)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_state_is_sharded_and_grad_norm_counts_each_leaf_once(run, mesh):
    """m holds the rank's slices only (the fsdp axis's share of every
    sharded tensor, replicated ones whole), and `gradops.global_grad_norm`
    over the sharded gradients equals the whole gradient's norm and JAX's
    one-device norm."""
    jcfg, tcfg, arrs, x, y, outs, grads = run
    shard = {"fsdp=2": 2, "dp=2,fsdp=2": 2}[mesh]
    specs = {k: TFS.spec_for(s, shard)
             for k, s in TPRM.param_shapes(tcfg).items()}
    want = sum(int(np.prod(s)) // (1 if specs[k] is None else shard)
               for k, s in TPRM.param_shapes(tcfg).items())
    jnorm = float(np.sqrt(sum(np.sum(np.square(t, dtype=np.float64))
                              for t in grads.values())))
    for out in outs[mesh]:
        assert int(out["m_numel"]) == want
        np.testing.assert_allclose(out["gnorm"], out["gnorm_whole"],
                                   rtol=1e-6)
        np.testing.assert_allclose(out["gnorm"], jnorm, rtol=1e-5)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_spec_for_matches_jax_for_every_preset(n):
    for name in TC.PRESETS:
        cfg = TC.get_config(name)
        for k, shape in TPRM.param_shapes(cfg).items():
            spec = tuple(JFS.spec_for(shape, n))
            want = spec.index(JFS.AXIS) if JFS.AXIS in spec else None
            assert TFS.spec_for(shape, n) == want, (name, k, shape)


def test_gradops_clip_and_accumulation_on_one_rank():
    """`clip_by_global_norm` scales by min(1, clip / (norm + 1e-6)) and
    returns the norm before the clip; `accumulate_microbatches` over equal
    slices gives the whole batch's mean loss and gradients."""
    import torch
    from vitrs_tpu_torch.models import model as TM
    from vitrs_tpu_torch.parallel import gradops
    _, tcfg = small_cfgs(**OVR)
    params = TPRM.from_numpy(np_params(tcfg, seed=8), tcfg, "cpu")
    rng = np.random.default_rng(8)
    x = torch.as_tensor(rng.integers(0, 97, (4, 16)))
    y = torch.as_tensor(rng.integers(0, 97, (4, 16)))

    def loss_and_grads(p, xb, yb):
        leaves = {k: t.detach().requires_grad_(True) for k, t in p.items()}
        loss = TM.loss_fn(leaves, xb, yb, tcfg)
        loss.backward()
        return loss.detach(), {k: t.grad for k, t in leaves.items()}

    whole_loss, whole = loss_and_grads(params, x, y)
    loss, grads = gradops.accumulate_microbatches(loss_and_grads, params, x,
                                                  y, 2)
    np.testing.assert_allclose(float(loss), float(whole_loss), rtol=1e-6)
    for k in whole:
        np.testing.assert_allclose(grads[k].numpy(), whole[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    specs = {k: None for k in grads}
    norm = float(torch.sqrt(sum(g.square().sum() for g in grads.values())))
    clipped, before = gradops.clip_by_global_norm(grads, specs, 0.5)
    np.testing.assert_allclose(float(before), norm, rtol=1e-6)
    scale = min(1.0, 0.5 / (norm + 1e-6))
    for k in grads:
        np.testing.assert_allclose(clipped[k].numpy(),
                                   grads[k].numpy() * scale, rtol=1e-6)
