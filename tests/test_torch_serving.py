"""The port's serving.py: `export_forward` (torch.export) and `ServedModel`
against the JAX package's `vit_forward` / `gpt_forward` on the same numpy
parameters, at tests/test_serving.py's sizes (fp32, rtol 1e-5) and at a
head_dim-64 GPT whose exported graph calls the K1-fwd op; the JAX
artifact refused; `ServedModel` in a process that loads no model code; and
tests/test_serving_depth.py's three `BatchingServer` tests."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitrs_tpu import serving as JS
from vitrs_tpu.config import get_config as jax_config
from vitrs_tpu.models import model as JM
from vitrs_tpu_torch import params as TP
from vitrs_tpu_torch import serving as TS
from vitrs_tpu_torch.config import get_config as torch_config
from vitrs_tpu_torch.models import model as TM
from test_torch_helpers import np_params, small_cfgs

VIT = dict(num_layers=2, channels=32, num_heads=2, dtype="float32")


def _both(name, **kw):
    return (jax_config(name, use_flash=False).replace(**kw),
            torch_config(name).replace(**kw))


def _export(tcfg, arrs, B, path):
    TS.export_forward(TP.from_numpy(arrs, tcfg, "cpu"), tcfg, B, str(path))
    return TS.ServedModel(str(path))


def test_vit_export_matches_jax(tmp_path):
    jcfg, tcfg = _both("vit-tiny-4-cifar10", **VIT)
    arrs = np_params(tcfg, seed=0)
    served = _export(tcfg, arrs, 4, tmp_path / "vit.vitrs")
    x = np.random.default_rng(0).standard_normal((4, 32, 32, 3),
                                                 dtype=np.float32)
    want = JM.vit_forward({k: jnp.asarray(v) for k, v in arrs.items()},
                          jnp.asarray(x), jcfg, train=False)
    np.testing.assert_allclose(served(x).numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["gpt-nano", "small-d64"])
def test_gpt_export_matches_jax(name, tmp_path):
    if name == "gpt-nano":
        jcfg, tcfg = _both("gpt-nano", dtype="float32")
    else:
        jcfg, tcfg = small_cfgs(dtype="float32")
    arrs = np_params(tcfg, seed=1)
    path = tmp_path / "gpt.vitrs"
    served = _export(tcfg, arrs, 2, path)
    tok = np.random.default_rng(1).integers(0, tcfg.vocab_size,
                                            (2, tcfg.max_seq_len))
    want = JM.gpt_forward({k: jnp.asarray(v) for k, v in arrs.items()},
                          jnp.asarray(tok), jcfg)
    got = served(tok)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the graph holds the eager forward's ops: equal bit for bit
    pp = TM.prepare_params(TP.from_numpy(arrs, tcfg, "cpu"), tcfg)
    torch.testing.assert_close(got, TM.gpt_forward(
        pp, torch.as_tensor(tok).long(), tcfg), rtol=0, atol=0)
    assert served.meta["input_dtype"] == "int32"


def test_exported_graph_calls_the_kernel_op(tmp_path):
    _, tcfg = small_cfgs(dtype="float32")
    arrs = np_params(tcfg, seed=2)
    served = _export(tcfg, arrs, 1, tmp_path / "g.vitrs")
    targets = [n.target for n in served._module.graph.nodes
               if n.op == "call_function"]
    assert targets.count(torch.ops.vitrs.flash_fwd.default) == \
        tcfg.num_layers


def test_shape_mismatch_rejected(tmp_path):
    _, tcfg = _both("vit-tiny-4-cifar10", **dict(VIT, num_layers=1))
    served = _export(tcfg, np_params(tcfg), 4, tmp_path / "m.vitrs")
    with pytest.raises(AssertionError, match="expected"):
        served(np.zeros((2, 32, 32, 3), np.float32))


def test_a_jax_artifact_is_refused(tmp_path):
    import jax
    from vitrs_tpu import params as JP
    jcfg = jax_config("vit-tiny-4-cifar10", use_flash=False).replace(
        num_layers=1, channels=32, num_heads=2)
    path = str(tmp_path / "jax.vitrs")
    JS.export_forward(JP.init_params(jcfg, jax.random.PRNGKey(0)), jcfg, 2,
                      path)
    with pytest.raises(ValueError, match="not a vitrs_tpu_torch"):
        TS.ServedModel(path)


def test_served_model_loads_no_model_code(tmp_path):
    _, tcfg = small_cfgs(dtype="float32")
    arrs = np_params(tcfg, seed=3)
    path = tmp_path / "child.vitrs"
    served = _export(tcfg, arrs, 2, path)
    tok = np.random.default_rng(3).integers(0, tcfg.vocab_size,
                                            (2, tcfg.max_seq_len))
    np.save(tmp_path / "tok.npy", tok)
    code = (
        "import sys, numpy as np\n"
        "from vitrs_tpu_torch.serving import ServedModel\n"
        f"m = ServedModel({str(path)!r})\n"
        f"np.save({str(tmp_path / 'out.npy')!r}, "
        f"m(np.load({str(tmp_path / 'tok.npy')!r})).numpy())\n"
        "bad = [k for k in sys.modules if k.startswith("
        "('vitrs_tpu_torch.models', 'vitrs_tpu_torch.vit', 'jax'))]\n"
        "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"),
                                  served(tok).numpy())


def test_batching_server_coalesces_and_scatters():
    calls = []

    def fn(x):
        calls.append(len(x))
        return torch.as_tensor(x) * 2.0 + 1.0

    srv = TS.BatchingServer(fn, batch_size=4, max_wait_ms=50.0)
    try:
        futs = [srv.submit(np.full((3,), i, np.float32)) for i in range(6)]
        outs = [f.result(timeout=10) for f in futs]
        for i, o in enumerate(outs):
            np.testing.assert_allclose(o, np.full((3,), 2.0 * i + 1.0))
        # every call ran at the compiled batch size
        assert all(c == 4 for c in calls)
    finally:
        srv.close()


def test_batching_server_serves_classifier(tmp_path):
    _, tcfg = _both("vit-tiny-4-cifar10", **VIT)
    served = _export(tcfg, np_params(tcfg, seed=4), 8, tmp_path / "c.vitrs")
    srv = TS.BatchingServer(served, batch_size=8, max_wait_ms=20.0)
    try:
        xs = np.random.default_rng(0).standard_normal((5, 32, 32, 3),
                                                      dtype=np.float32)
        got = np.stack([f.result(timeout=30)
                        for f in [srv.submit(x) for x in xs]])
        want = served(np.concatenate([xs, xs[:3]])).numpy()[:5]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    finally:
        srv.close()


def test_batching_server_propagates_errors():
    def bad(x):
        raise RuntimeError("boom")

    srv = TS.BatchingServer(bad, batch_size=2, max_wait_ms=1.0)
    try:
        fut = srv.submit(np.zeros(3, np.float32))
        with pytest.raises(RuntimeError, match="boom"):
            fut.result(timeout=10)
    finally:
        srv.close()
