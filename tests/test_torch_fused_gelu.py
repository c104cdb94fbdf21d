"""The GELU ops on the CPU (ops/basic.py): `vitrs::gelu_fwd` and
`vitrs::gelu_bwd` run their plain versions, the eager chain of
ops/basic.py, bit for bit; the fake versions give the shape and dtype;
`basic._Gelu` and selective remat's `_MlpBranch` call the two ops (recording
functions stood in for the plain versions, which the ops look up at each
call); an exported graph holds one GELU node a layer; and the CPU path
neither builds nor loads the CUDA library (ops/fused_gelu.py), so it needs
no toolkit.  The kernels themselves are held to the same plain versions on
the card (tests/test_torch_gelu_cuda.py)."""

import numpy as np
import pytest
import torch

from vitrs_tpu_torch import params as P
from vitrs_tpu_torch import serving
from vitrs_tpu_torch.config import get_config
from vitrs_tpu_torch.models import selective
from vitrs_tpu_torch.ops import basic
from vitrs_tpu_torch.ops import fused_gelu as FG

DTYPES = (torch.bfloat16, torch.float32)


def _x(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(3.0 * rng.standard_normal(shape).astype(
        np.float32)).to(dtype)


@pytest.mark.parametrize("erf", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_the_ops_run_the_eager_chain_on_the_cpu(dtype, erf):
    x, dy = _x((5, 96), dtype, 0), _x((5, 96), dtype, 1)
    y = basic.gelu_fwd_op(x, erf)
    assert torch.equal(y, basic.gelu_erf(x) if erf else basic.gelu(x))
    local = (basic.gelu_erf_grad_local if erf
             else basic.gelu_grad_local)(x.float())
    assert torch.equal(basic.gelu_bwd_op(x, dy, erf),
                       (local * dy.float()).to(dtype))


@pytest.mark.parametrize("erf", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_gelu_cv_is_unchanged_through_the_ops(dtype, erf):
    """The autograd.Function's value and gradient are the eager chain's."""
    x, dy = _x((3, 4, 64), dtype, 2), _x((3, 4, 64), dtype, 3)
    leaf = x.clone().requires_grad_(True)
    y = (basic.gelu_erf_cv if erf else basic.gelu_cv)(leaf)
    y.backward(dy)
    assert torch.equal(y.detach(), basic.gelu_fwd_plain(x, erf))
    assert torch.equal(leaf.grad, basic.gelu_bwd_plain(x, dy, erf))


def test_the_fake_versions_give_shape_and_dtype():
    x = torch.empty(2, 7, 48, dtype=torch.bfloat16, device="meta")
    for y in (basic.gelu_fwd_op(x, False), basic.gelu_bwd_op(x, x, True)):
        assert y.shape == x.shape and y.dtype == x.dtype
        assert y.device.type == "meta"


def _recording(monkeypatch):
    calls = []
    for name in ("gelu_fwd_plain", "gelu_bwd_plain"):
        real = getattr(basic, name)
        monkeypatch.setattr(basic, name, lambda *a, _n=name, _f=real: (
            calls.append((_n, a[-1])), _f(*a))[1])
    return calls


@pytest.mark.parametrize("erf", [False, True])
def test_gelu_cv_calls_the_ops(monkeypatch, erf):
    calls = _recording(monkeypatch)
    x = _x((4, 32), torch.float32, 4).requires_grad_(True)
    (basic.gelu_erf_cv if erf else basic.gelu_cv)(x).sum().backward()
    assert calls == [("gelu_fwd_plain", erf), ("gelu_bwd_plain", erf)]


@pytest.mark.parametrize("erf", [False, True])
def test_selective_mlp_branch_calls_the_ops(monkeypatch, erf):
    """The forward, the backward's recompute, then the gradient."""
    cfg = get_config("gpt-nano").replace(
        num_layers=1, num_heads=2, channels=32, max_seq_len=8,
        act="gelu_erf" if erf else "gelu_tanh")
    params = P.init_params(cfg, torch.Generator().manual_seed(0))
    p = {k: params[k][0].requires_grad_(True) for k in selective.MLP_KEYS}
    x = _x((2, 8, 32), torch.float32, 5).requires_grad_(True)
    calls = _recording(monkeypatch)
    selective.mlp_branch(x, p, cfg).sum().backward()
    assert calls == [("gelu_fwd_plain", erf), ("gelu_fwd_plain", erf),
                     ("gelu_bwd_plain", erf)]


def test_an_exported_graph_calls_the_gelu_op(tmp_path):
    cfg = get_config("gpt-nano").replace(
        num_layers=2, num_heads=2, channels=64, max_seq_len=16,
        vocab_size=64, dtype="float32")
    params = P.init_params(cfg, torch.Generator().manual_seed(1))
    path = str(tmp_path / "g.vitrs")
    serving.export_forward(params, cfg, 1, path)
    served = serving.ServedModel(path)
    targets = [n.target for n in served._module.graph.nodes
               if n.op == "call_function"]
    assert targets.count(torch.ops.vitrs.gelu_fwd.default) == cfg.num_layers


def test_the_cpu_path_never_builds_the_kernels():
    """The module imports and the ops run without a CUDA toolkit: the
    library is built at the first CUDA call only."""
    basic.gelu_fwd_op(_x((8,), torch.float32, 6), False)
    assert FG._kernels.cache_info().misses == 0
    assert FG.gelu_fwd_cuda.launches == 0 and FG.gelu_bwd_cuda.launches == 0


@pytest.mark.parametrize("chunk, max_new, ticks", [(1, 6, 6), (4, 6, 8)])
def test_the_engine_runs_one_gelu_a_layer_a_pass(monkeypatch, chunk, max_new,
                                                 ticks):
    """A prefill dispatch and a decode tick each run every layer's MLP
    once; a chunked tick decodes to the chunk's end (8 ticks for 6 new
    tokens in chunks of 4)."""
    from vitrs_tpu_torch.serving_gen import GenerationEngine
    cfg = get_config("gpt-nano").replace(
        num_layers=2, num_heads=2, channels=32, max_seq_len=32,
        vocab_size=64, dtype="float32")
    params = P.init_params(cfg, torch.Generator().manual_seed(2))
    eng = GenerationEngine(params, cfg, max_slots=2, max_len=32,
                           prompt_buckets=(8,), decode_chunk=chunk)
    eng.submit(np.arange(5), max_new=max_new)
    calls = _recording(monkeypatch)
    eng.run()
    assert (eng.prefill_dispatches, eng.decode_ticks) == (1, ticks)
    assert calls == [("gelu_fwd_plain", False)] * (cfg.num_layers
                                                   * (1 + ticks))
