"""PyTorch port: the binary checkpoint loads in both directions."""

import dataclasses

import numpy as np
import pytest
import torch

from vitrs_tpu import checkpoint as JC
from vitrs_tpu_torch import checkpoint as TC
from vitrs_tpu_torch import params as TP

from test_torch_helpers import np_params, small_cfgs


def _opt(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n).astype(np.float32),
            rng.random(n).astype(np.float32))


@pytest.mark.parametrize("with_opt", [False, True])
def test_jax_written_loads_in_port(tmp_path, with_opt):
    jcfg, tcfg = small_cfgs()
    arrs = np_params(tcfg, seed=1)
    m, v = _opt(TP.num_parameters(tcfg), 2) if with_opt else (None, None)
    path = str(tmp_path / "jax.bin")
    JC.save_checkpoint(path, arrs, jcfg, m=m, v=v, step=7 if with_opt else 0,
                       seed=3 if with_opt else 0, cursor=11)
    got, cfg, extras = TC.load_checkpoint(path)
    want, jcfg2, jextras = JC.load_checkpoint(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg2)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], arrs[k])
    assert {k: extras[k] for k in ("step", "seed", "cursor")} == \
        {k: jextras[k] for k in ("step", "seed", "cursor")}
    if with_opt:
        np.testing.assert_array_equal(extras["m"], m)
        np.testing.assert_array_equal(extras["v"], v)
    else:
        assert extras["m"] is None and extras["v"] is None


@pytest.mark.parametrize("with_opt", [False, True])
def test_port_written_loads_in_jax(tmp_path, with_opt):
    jcfg, tcfg = small_cfgs()
    tparams = TP.from_numpy(np_params(tcfg, seed=4), tcfg)
    m, v = _opt(TP.num_parameters(tcfg), 5) if with_opt else (None, None)
    tpath, jpath = str(tmp_path / "t.bin"), str(tmp_path / "j.bin")
    TC.save_checkpoint(tpath, tparams, tcfg, m=m, v=v,
                       step=2 if with_opt else 0)
    # the same content written by JAX gives the same bytes
    JC.save_checkpoint(jpath, TP.to_numpy(tparams, tcfg), jcfg, m=m, v=v,
                       step=2 if with_opt else 0)
    with open(tpath, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    got, cfg, extras = JC.load_checkpoint(tpath)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for k, t in tparams.items():
        np.testing.assert_array_equal(got[k], t.numpy())
    assert extras["step"] == (2 if with_opt else 0)


def test_bf16_params_save_as_f32(tmp_path):
    _, tcfg = small_cfgs()
    tparams = TP.from_numpy(np_params(tcfg), tcfg, dtype=torch.bfloat16)
    path = str(tmp_path / "bf.bin")
    TC.save_checkpoint(path, tparams, tcfg)
    got, _, _ = TC.load_checkpoint(path)
    np.testing.assert_array_equal(got["wte"], tparams["wte"].float().numpy())


def test_header_round_trip_equals_jax():
    jcfg, tcfg = small_cfgs(num_kv_heads=1, window=8)
    h = TC._header(tcfg, 2, 5, True, 9)
    np.testing.assert_array_equal(h, JC._header(jcfg, 2, 5, True, 9))
    assert dataclasses.asdict(TC.config_from_header(h)) == \
        dataclasses.asdict(JC.config_from_header(h))


def _write_header(path, h):
    with open(path, "wb") as f:
        f.write(h.astype(np.int32).tobytes())


def test_bad_magic_raises(tmp_path):
    _, tcfg = small_cfgs()
    h = TC._header(tcfg, 1, 0, False, 0)
    h[0] = 1234
    path = str(tmp_path / "bad.bin")
    _write_header(path, h)
    with pytest.raises(ValueError, match="bad magic"):
        TC.load_checkpoint(path)


def test_unsupported_version_and_truncation_raise(tmp_path):
    _, tcfg = small_cfgs()
    h = TC._header(tcfg, 1, 0, False, 0)
    h[1] = 3
    path = str(tmp_path / "v3.bin")
    _write_header(path, h)
    with pytest.raises(ValueError, match="version 3"):
        TC.load_checkpoint(path)
    h[1] = 1
    _write_header(path, h)                      # header, no payload
    with pytest.raises(ValueError, match="truncated checkpoint at tensor wte"):
        TC.load_checkpoint(path)


def test_geometry_mismatch_raises(tmp_path):
    _, tcfg = small_cfgs()
    path = str(tmp_path / "c.bin")
    TC.save_checkpoint(path, np_params(tcfg), tcfg)
    with pytest.raises(ValueError, match="channels"):
        TC.load_checkpoint(path, tcfg.replace(channels=64))
    _, cfg, _ = TC.load_checkpoint(path, tcfg.replace(dtype="bfloat16"))
    assert cfg.dtype == "bfloat16"
