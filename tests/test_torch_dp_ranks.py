"""ZeRO-1 at world size 2: the port's `make_dp_train_step` on two gloo CPU
ranks (tests/torch_dist_worker.py, one spawn for the whole file) against
the JAX package's step on a 2-device mesh of the conftest's CPU devices,
from the same numpy parameters and global batch.  Tolerances are
tests/test_data_parallel.py's (the per-shard reduction order against the
whole batch's); the tree steps take their one-device tests' tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vitrs_tpu import params as JPRM
from vitrs_tpu.ops import adafactor as JAF
from vitrs_tpu.ops import muon as JMU
from vitrs_tpu.parallel import data_parallel as JDP
from test_torch_helpers import (SMALL, assert_params_close, np_params,
                                small_cfgs, spawn_ranks)

# vocab 89: a config no other test builds the JAX decay-2d step for (its
# lru-cached flat mask would leak a tracer into an equal config's step)
OVR = dict(SMALL, vocab_size=89, max_seq_len=16)
B = 8


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jcfg, tcfg = small_cfgs(**OVR)
    jcfg = jcfg.replace(use_flash=False)
    arrs = np_params(tcfg, seed=5)
    rng = np.random.default_rng(5)
    x = rng.integers(0, 89, (B, 16)).astype(np.int32)
    y = rng.integers(0, 89, (B, 16)).astype(np.int32)
    outs = spawn_ranks("dp", 2, tmp_path_factory.mktemp("dp"),
                       {"preset": "gpt-nano", "overrides": OVR},
                       {**{"p/" + k: v for k, v in arrs.items()},
                        "x": x, "y": y})
    mesh = JDP.make_mesh(devices=jax.devices()[:2])
    return jcfg, tcfg, mesh, arrs, x, y, outs


def _fresh(arrs, mesh):
    """A replicated copy for one JAX step (the steps donate their
    parameters)."""
    return JDP.replicate({k: jnp.array(v) for k, v in arrs.items()}, mesh)


def _batch(mesh, x, y):
    return (JDP.shard_batch(jnp.asarray(x), mesh),
            JDP.shard_batch(jnp.asarray(y), mesh))


def _unflat(flat, cfg):
    out, off = {}, 0
    for k in JPRM.tensor_order(cfg):
        shp = JPRM.param_shapes(cfg)[k]
        size = int(np.prod(shp))
        out[k] = flat[off:off + size].reshape(shp)
        off += size
    return out


# JAX's accumulation reshapes 1-D (vit) targets only; with equal
# micro-batches the mean of the micro-batch means is the batch mean, so the
# port's accum_steps=2 is held to the JAX step without accumulation
@pytest.mark.parametrize("variant,kw,lr,wd", [
    ("plain", dict(return_grad_norm=True), 1e-3, 0.01),
    ("clip", dict(return_grad_norm=True, clip_norm=0.05, decay_2d_only=True),
     1e-3, 0.1),
    ("accum", {}, 1e-3, 0.01)])
def test_zero1_step_matches_jax_two_devices(run, variant, kw, lr, wd):
    jcfg, tcfg, mesh, arrs, x, y, outs = run
    m, v = JDP.init_sharded_opt_state(jcfg, mesh)
    res = JDP.make_dp_train_step(jcfg, mesh, **kw)(
        _fresh(arrs, mesh), m, v, *_batch(mesh, x, y),
        jnp.asarray(1, jnp.int32), jnp.asarray(lr, jnp.float32),
        jnp.asarray(wd, jnp.float32))
    jm = np.asarray(jax.device_get(res[1]))
    shard = int(outs[0]["shard"])
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out[f"{variant}/loss"], float(res[3]),
                                   rtol=1e-5)
        # every rank holds the same all-gathered parameters
        np.testing.assert_array_equal(out[f"{variant}/p"],
                                      outs[0][f"{variant}/p"])
        assert out[f"{variant}/m"].shape == (shard,)
        np.testing.assert_allclose(out[f"{variant}/m"],
                                   jm[r * shard:(r + 1) * shard],
                                   rtol=2e-4, atol=1e-7)
        if "return_grad_norm" in kw:
            np.testing.assert_allclose(out[f"{variant}/gnorm"],
                                       float(res[4]), rtol=1e-5)
    got = _unflat(outs[0][f"{variant}/p"], tcfg)
    assert_params_close(got, jax.device_get(res[0]), tcfg, rtol=2e-4,
                        atol=5e-5)


def test_m_and_v_are_sharded_half_a_rank(run):
    _, tcfg, _, _, _, _, outs = run
    n = JPRM.num_parameters(small_cfgs(**OVR)[0])
    assert int(outs[0]["shard"]) == -(-n // 2)
    for out in outs:
        assert out["plain/m"].shape == out["plain/v"].shape == (-(-n // 2),)
    # the two shards differ: each rank updated its own half
    assert not np.array_equal(outs[0]["plain/m"], outs[1]["plain/m"])


def test_clip_scales_the_update(run):
    """The clip variant's norm is the one before the clip, and clipping to
    0.05 changes the first moment by that factor."""
    _, _, _, _, _, _, outs = run
    g = float(outs[0]["clip/gnorm"])
    assert g > 0.05
    np.testing.assert_allclose(outs[0]["clip/m"] * g / 0.05,
                               outs[0]["plain/m"], rtol=1e-3, atol=1e-9)


def test_adafactor_dp_step_matches_jax(run):
    jcfg, tcfg, mesh, arrs, x, y, outs = run
    jp, _, jloss = JDP.make_dp_train_step_adafactor(jcfg, mesh)(
        _fresh(arrs, mesh),
        JDP.replicate(JAF.init_state(_fresh(arrs, mesh)), mesh),
        *_batch(mesh, x, y),
        jnp.asarray(1, jnp.int32), jnp.asarray(1e-2, jnp.float32),
        jnp.asarray(0.1, jnp.float32))
    for out in outs:
        np.testing.assert_allclose(out["adafactor/loss"], float(jloss),
                                   rtol=2e-5)
    assert_params_close(_unflat(outs[1]["adafactor/p"], tcfg),
                        jax.device_get(jp), tcfg, rtol=1e-4, atol=5e-5)


def test_muon_dp_step_matches_jax(run):
    jcfg, tcfg, mesh, arrs, x, y, outs = run
    jp, _, jloss = JDP.make_dp_train_step_muon(jcfg, mesh, clip_norm=1.0)(
        _fresh(arrs, mesh),
        JDP.replicate(JMU.init_state(_fresh(arrs, mesh)), mesh),
        *_batch(mesh, x, y),
        jnp.asarray(0, jnp.int32), jnp.asarray(0.02, jnp.float32),
        jnp.asarray(3e-3, jnp.float32))
    for out in outs:
        np.testing.assert_allclose(out["muon/loss"], float(jloss), rtol=2e-5)
    # Muon's bf16 Newton-Schulz: tests/test_torch_muon.py's 1e-3
    assert_params_close(_unflat(outs[1]["muon/p"], tcfg), jax.device_get(jp),
                        tcfg, rtol=0, atol=1e-3)
