"""PyTorch port: async and range-sharded checkpoint writes
(checkpoint_async.py) against the synchronous writer and the JAX package,
on the CPU, one counterpart for each test of tests/test_checkpoint_async.py.

  * the async file is byte-identical to checkpoint.save_checkpoint's and
    to the JAX package's synchronous save of the same values;
  * snapshot semantics: the values at save() time, however the caller's
    tensors change in place afterwards (as the fused AdamW changes the
    masters, m and v);
  * save() returns at once and training goes on while the write drains;
  * a writer's error surfaces on the next wait();
  * the range-sharded file of 1, 3 and 4 writers equals the single file
    (and the JAX package's sharded file);
  * a kill-and-resume run with async checkpoints is bitwise the straight
    run.
The snapshot under an in-place K7 on the card: tests/test_torch_train_cuda.py."""

import os
import time

import numpy as np
import pytest
import torch

from vitrs_tpu import checkpoint as JC
from vitrs_tpu import checkpoint_async as JCA
from vitrs_tpu.config import get_config as jax_config
from vitrs_tpu_torch import checkpoint as TC
from vitrs_tpu_torch import params as TP
from vitrs_tpu_torch.checkpoint_async import (AsyncCheckpointer,
                                              save_checkpoint_sharded)
from vitrs_tpu_torch.config import get_config

SMALL = dict(num_layers=2, channels=32, num_heads=2)


def _cfg():
    return get_config("vit-tiny-4-cifar10").replace(**SMALL)


def _state(seed=0):
    """Flat-arena params (views into one fp32 vector), m and v."""
    cfg = _cfg()
    params = TP.unflatten_params(TP.flatten_params(
        TP.init_params(cfg, torch.Generator().manual_seed(seed)), cfg), cfg)
    n = TP.num_parameters(cfg)
    rng = np.random.default_rng(seed)
    m = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    v = torch.from_numpy(np.abs(rng.standard_normal(n)).astype(np.float32))
    return cfg, params, m, v


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("flat", [True, False], ids=["arena", "dict"])
def test_async_save_bitwise_matches_sync(flat, tmp_path):
    cfg, params, m, v = _state()
    if not flat:
        params = {k: t.clone() for k, t in params.items()}
    sync = str(tmp_path / "sync.bin")
    TC.save_checkpoint(sync, params, cfg, m=m, v=v, step=7, seed=3, cursor=99)
    jax_path = str(tmp_path / "jax.bin")
    JC.save_checkpoint(jax_path, TP.to_numpy(params, cfg),
                       jax_config("vit-tiny-4-cifar10").replace(**SMALL),
                       m=m.numpy(), v=v.numpy(), step=7, seed=3, cursor=99)
    ck = AsyncCheckpointer()
    path = str(tmp_path / "async.bin")
    ck.save(path, params, cfg, m=m, v=v, step=7, seed=3, cursor=99)
    ck.close()
    assert _read(path) == _read(sync) == _read(jax_path)


def test_async_save_is_a_snapshot(tmp_path):
    """The values of save() time, though every tensor is then changed in
    place, as K7 changes the masters, m and v after the step."""
    cfg, params, m, v = _state(1)
    want = {k: t.clone() for k, t in params.items()}
    want_m, want_v = m.clone(), v.clone()
    ck = AsyncCheckpointer()
    path = str(tmp_path / "snap.bin")
    ck.save(path, params, cfg, m=m, v=v, step=1, n_valid=m.shape[0])
    TP.flat_base(params, cfg).mul_(-3.0).add_(1.0)
    m.zero_()
    v.fill_(7.0)
    ck.close()
    got, _, extras = TC.load_checkpoint(path)
    assert extras["step"] == 1
    for k in want:
        np.testing.assert_array_equal(got[k], want[k].numpy(), err_msg=k)
    np.testing.assert_array_equal(extras["m"], want_m.numpy())
    np.testing.assert_array_equal(extras["v"], want_v.numpy())


def test_async_overlaps_training_steps(tmp_path):
    """save() returns quickly and training goes on while the write drains;
    the file holds the pre-save params though 5 more steps ran."""
    from vitrs_tpu_torch.vit import ViT
    model = ViT.from_config(_cfg(), device="cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 32, 32, 3), dtype=np.float32)
    y = rng.integers(0, 10, (16,))
    model.train_step(x, y, lr=1e-3)
    snapshot = {k: t.detach().clone() for k, t in model.params.items()}
    ck = AsyncCheckpointer()
    path = str(tmp_path / "ovl.bin")
    t0 = time.perf_counter()
    ck.save(path, model.params, model.config, step=1)
    t_save = time.perf_counter() - t0
    for _ in range(5):
        model.train_step(x, y, lr=1e-3)
    ck.close()
    got, _, _ = TC.load_checkpoint(path)
    for k in snapshot:
        np.testing.assert_array_equal(got[k], snapshot[k].numpy(), err_msg=k)
    assert not torch.equal(model.params["fcw"].detach(), snapshot["fcw"])
    assert t_save < 5.0, t_save


def test_async_checkpointer_surfaces_writer_errors(tmp_path):
    cfg, params, _, _ = _state()
    ck = AsyncCheckpointer()
    ck.save(str(tmp_path / "no_such_dir" / "x.bin"), params, cfg)
    with pytest.raises(FileNotFoundError):
        ck.wait()
    # the error is reported once; the writer goes on serving saves
    ok = str(tmp_path / "ok.bin")
    ck.save(ok, params, cfg, step=2)
    ck.close()
    assert TC.load_checkpoint(ok)[2]["step"] == 2


@pytest.mark.parametrize("num_hosts", [1, 3, 4])
def test_sharded_write_equals_single_host_file(num_hosts, tmp_path):
    """N writers each write their range into one file (host 0 first, as
    the JAX function's barrier orders them): byte-identical to one
    save_checkpoint and to the JAX package's sharded file, loading
    bit-exact."""
    cfg, params, m, v = _state(2)
    ref = str(tmp_path / "single.bin")
    TC.save_checkpoint(ref, params, cfg, m=m, v=v, step=11, seed=5,
                       cursor=1234)
    sh, jsh = str(tmp_path / "sharded.bin"), str(tmp_path / "jax.bin")
    jcfg = jax_config("vit-tiny-4-cifar10").replace(**SMALL)
    host = TP.to_numpy(params, cfg)
    for h in range(num_hosts):
        save_checkpoint_sharded(sh, cfg, h, num_hosts, params=params, m=m,
                                v=v, step=11, seed=5, cursor=1234)
        JCA.save_checkpoint_sharded(jsh, jcfg, h, num_hosts, params=host,
                                    m=m.numpy(), v=v.numpy(), step=11,
                                    seed=5, cursor=1234)
    assert _read(sh) == _read(ref) == _read(jsh)
    p2, _, e2 = TC.load_checkpoint(sh)
    assert e2["step"] == 11 and e2["cursor"] == 1234
    np.testing.assert_array_equal(e2["m"], m.numpy())
    for k in host:
        np.testing.assert_array_equal(p2[k], host[k])


def test_train_loop_async_resume_still_bit_exact(tmp_path):
    """Kill-and-resume with async checkpoints (the default) equals the
    straight run bit for bit: the snapshot holds exactly the post-step
    state, and the cursor counts the consumed examples (the prefetcher's
    loader runs ahead)."""
    from vitrs_tpu_torch.train import loop as TL
    common = dict(preset="vit-tiny-4-cifar10", dataset="cifar10", steps=4,
                  batch_size=16, lr=1e-3, warmup=2, dtype="float32",
                  log_every=2, seed=1, device="cpu", async_ckpt=True,
                  model_overrides=SMALL)
    w1, w2 = str(tmp_path / "straight"), str(tmp_path / "resumed")
    TL.train(TL.TrainConfig(workdir=w1, ckpt_every=4, **common))
    TL.train(TL.TrainConfig(workdir=w2, ckpt_every=2, run_steps=2, **common))
    TL.train(TL.TrainConfig(workdir=w2, ckpt_every=2, **common))
    a = _read(os.path.join(w1, "ckpt_00000004.bin"))
    assert a == _read(os.path.join(w2, "ckpt_00000004.bin"))
    assert TC.load_checkpoint(os.path.join(w2, "ckpt_00000002.bin"))[2][
        "cursor"] == 32
