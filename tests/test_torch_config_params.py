"""PyTorch port: config, parameter layout and the import boundary.

The port copies config.py and re-implements params.py; these tests pin both
equal to the JAX package, and check that no port module imports jax."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from vitrs_tpu import params as JP
from vitrs_tpu.config import PRESETS as JAX_PRESETS
from vitrs_tpu_torch import params as TP
from vitrs_tpu_torch.config import PRESETS as TORCH_PRESETS, get_config

from test_torch_helpers import np_params, small_cfgs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_same_preset_names():
    assert list(TORCH_PRESETS) == list(JAX_PRESETS)


@pytest.mark.parametrize("name", sorted(JAX_PRESETS))
def test_preset_equals_jax(name):
    t, j = TORCH_PRESETS[name], JAX_PRESETS[name]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for prop in ("head_size", "kv_heads", "kv_dim", "qkv_dim", "is_gqa",
                 "is_moe", "seq_len"):
        assert getattr(t, prop) == getattr(j, prop), prop


@pytest.mark.parametrize("name", ["gpt2-124m", "gpt2-moe-8e", "vit-b-16",
                                  "gpt-nano", "gpt2-1558m"])
def test_shapes_order_and_count_equal_jax(name):
    t, j = TORCH_PRESETS[name], JAX_PRESETS[name]
    assert TP.param_shapes(t) == JP.param_shapes(j)
    assert TP.tensor_order(t) == JP.tensor_order(j)
    assert TP.num_parameters(t) == JP.num_parameters(j)
    assert (TP.num_parameters(t, core_only=True)
            == JP.num_parameters(j, core_only=True))


def test_gpt2_124m_parameter_count():
    assert TP.num_parameters(get_config("gpt2-124m")) == 124_439_808


def test_validation_matches_jax():
    bad = dict(num_heads=5)               # 768 % 5 != 0
    with pytest.raises(AssertionError):
        get_config("gpt2-124m", **bad)
    with pytest.raises(AssertionError):
        JAX_PRESETS["gpt2-124m"].replace(**bad).validate()


def test_from_numpy_to_numpy_round_trip():
    jcfg, tcfg = small_cfgs()
    jparams = JP.init_params(jcfg, jax.random.PRNGKey(0))
    arrs = {k: np.asarray(v) for k, v in jparams.items()}   # read-only views
    tparams = TP.from_numpy(arrs, tcfg, "cpu")
    assert all(v.dtype == torch.float32 for v in tparams.values())
    back = TP.to_numpy(tparams, tcfg)
    assert list(back) == list(JP.tensor_order(jcfg))
    for k in arrs:
        np.testing.assert_array_equal(back[k], arrs[k])
    bf = TP.from_numpy(arrs, tcfg, "cpu", torch.bfloat16)
    assert bf["qkvw"].dtype == torch.bfloat16


def test_from_numpy_rejects_wrong_shape():
    _, tcfg = small_cfgs()
    arrs = np_params(tcfg)
    arrs["qkvw"] = arrs["qkvw"][:, :-1]
    with pytest.raises(ValueError, match="qkvw"):
        TP.from_numpy(arrs, tcfg)


@pytest.mark.parametrize("scheme", ["production", "reference"])
def test_init_params_schemes(scheme):
    _, tcfg = small_cfgs()
    p = TP.init_params(tcfg, torch.Generator().manual_seed(0), scheme)
    p2 = TP.init_params(tcfg, torch.Generator().manual_seed(0), scheme)
    assert tuple(p) == TP.tensor_order(tcfg)
    for k, v in p.items():
        assert tuple(v.shape) == TP.param_shapes(tcfg)[k]
        assert torch.equal(v, p2[k]), k              # seeded: reproducible
    assert torch.equal(p["ln1w"], torch.ones_like(p["ln1w"]))
    assert not p["qkvb"].any()
    w = p["fcw"]
    if scheme == "reference":
        assert w.min() >= 0.0 and w.max() < 0.02
    else:
        assert w.abs().max() <= 0.04 + 1e-7          # truncated at 2 std
        assert abs(w.std().item() - 0.0176) < 2e-3   # std of N(0, .02) cut at 2 std
        proj = 0.02 / np.sqrt(2.0 * tcfg.num_layers)
        assert p["attprojw"].abs().max() <= 2 * proj + 1e-7


def test_port_imports_no_jax():
    """Import every module of the port in a fresh interpreter: jax must not
    be among the loaded modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import vitrs_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) >= 14, names\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'vitrs_tpu.')) or m == 'vitrs_tpu')\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 14
