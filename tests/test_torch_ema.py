"""PyTorch port: EMA weights (ops/ema.py) and the training loop's EMA
against the JAX package, on the CPU.

  * 3 updates of the flat fp32 EMA (one lerp_ a step) equal JAX's
    update_ema over the same parameter trees, fp32 rtol 1e-6 (lerp and
    decay*e + (1-decay)*p are the same value up to rounding);
  * the loop's ema_{step}.tree loads in the JAX package's checkpoint_tree
    and a tree the JAX package writes resumes the port's loop; a resumed
    run's EMA equals a straight run's bit for bit;
  * the final evaluation reads the EMA weights."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vitrs_tpu import checkpoint_tree as JCT
from vitrs_tpu.ops import ema as JEMA
from vitrs_tpu_torch import checkpoint_tree as TCT
from vitrs_tpu_torch import params as TP
from vitrs_tpu_torch.ops import ema as TEMA
from vitrs_tpu_torch.train import loop as TL

from test_torch_helpers import np_params, small_cfgs

VIT = dict(num_layers=2, channels=64, num_heads=2, img_size=16, patch_size=4)


@pytest.mark.parametrize("decay", [0.9, 0.9999])
def test_three_updates_equal_jax(decay):
    jcfg, tcfg = small_cfgs()
    steps = [np_params(tcfg, seed=s) for s in range(4)]
    jema = JEMA.init_ema({k: jnp.asarray(v) for k, v in steps[0].items()})
    flat = TP.flatten_params(TP.from_numpy(steps[0], tcfg, "cpu"), tcfg)
    tema = TEMA.init_ema(flat)
    for arrs in steps[1:]:
        jema = JEMA.update_ema(jema, {k: jnp.asarray(v)
                                      for k, v in arrs.items()}, decay)
        TEMA.update_ema(tema, TP.flatten_params(
            TP.from_numpy(arrs, tcfg, "cpu"), tcfg), decay)
    got = TP.unflatten_params(tema, tcfg)
    # atol: an ulp of the largest terms (|p| < 0.25, ulp 1.5e-8), where
    # the average of independent draws cancels to near 0
    for k, want in jax.device_get(jema).items():
        np.testing.assert_allclose(got[k].numpy(), want, rtol=1e-6,
                                   atol=1.5e-8, err_msg=k)


def _vit_run(workdir, **kw):
    kw.setdefault("steps", 4)
    return TL.train(TL.TrainConfig(
        preset="vit-tiny-4-cifar10", dataset="synthetic-shapes",
        dataset_size=64, batch_size=8, lr=1e-3, warmup=1,
        dtype="float32", log_every=2, ckpt_every=2, workdir=str(workdir),
        device="cpu", ema_decay=0.5, model_overrides=VIT, **kw))


def test_ema_tree_loads_in_jax_and_resumes_bitwise(tmp_path):
    _vit_run(tmp_path / "straight")
    _vit_run(tmp_path / "resumed", run_steps=2)
    _vit_run(tmp_path / "resumed")
    trees = {}
    for name in ("straight", "resumed"):
        path = os.path.join(tmp_path, name, "ema_00000004.tree")
        jtree, jmeta = JCT.load_tree(path)
        ttree, tmeta = TCT.load_tree(path)
        assert jmeta == tmeta and tmeta["step"] == 4 and tmeta["decay"] == 0.5
        assert set(jtree) == set(ttree) and len(ttree) == 21   # vit mode
        for k in ttree:
            np.testing.assert_array_equal(jtree[k], ttree[k])
        trees[name] = ttree
    for k in trees["straight"]:
        np.testing.assert_array_equal(trees["straight"][k],
                                      trees["resumed"][k], err_msg=k)


def test_a_jax_written_ema_tree_resumes_the_loop(tmp_path, capsys):
    """Two runs resume at step 2, one from its own EMA tree, one from that
    tree shifted by 0.25 and rewritten by the JAX package: two more steps
    at decay 0.5 keep a quarter of the shift, so their EMAs differ by
    0.0625 everywhere."""
    import shutil
    _vit_run(tmp_path / "own", run_steps=2)
    shutil.copytree(tmp_path / "own", tmp_path / "jax")
    path = os.path.join(tmp_path, "jax", "ema_00000002.tree")
    tree, meta = TCT.load_tree(path)
    JCT.save_tree(path, {k: v + np.float32(0.25) for k, v in tree.items()},
                  meta=meta)
    capsys.readouterr()
    for name in ("own", "jax"):
        _vit_run(tmp_path / name)
        assert "[resume] EMA from" in capsys.readouterr().out
    own, _ = TCT.load_tree(os.path.join(tmp_path, "own", "ema_00000004.tree"))
    jax_, _ = TCT.load_tree(os.path.join(tmp_path, "jax", "ema_00000004.tree"))
    for k in own:
        np.testing.assert_allclose(jax_[k] - own[k], 0.0625, rtol=0,
                                   atol=1e-6, err_msg=k)


def test_final_eval_reads_the_ema_weights(tmp_path):
    from vitrs_tpu_torch.config import get_config
    s = _vit_run(tmp_path)
    cfg = get_config("vit-tiny-4-cifar10", dtype="float32", **VIT)
    ema, _ = TCT.load_tree(os.path.join(tmp_path, "ema_00000004.tree"))
    ds = TL.image_dataset(TL.TrainConfig(dataset="synthetic-shapes",
                                         dataset_size=64), cfg, train=False)
    want = TL.evaluate(cfg, TP.from_numpy(ema, cfg, "cpu"), ds,
                       batch=min(256, len(ds)))
    assert s["eval"] == want
    from vitrs_tpu_torch import checkpoint as TC
    final, _, _ = TC.load_checkpoint(os.path.join(tmp_path,
                                                  "ckpt_00000004.bin"), cfg)
    plain = TL.evaluate(cfg, TP.from_numpy(final, cfg, "cpu"), ds,
                        batch=min(256, len(ds)))
    assert plain["loss"] != want["loss"]
