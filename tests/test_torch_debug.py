"""The port's utils/debug.py against tests/test_debug_utils.py's four
cases, and the checks on a model: an index out of range and a NaN weight
row are named at the op that meets them."""

import numpy as np
import pytest
import torch

from vitrs_tpu_torch.models import model as TM
from vitrs_tpu_torch.utils import debug as DBG
from test_torch_helpers import np_params, small_cfgs
from vitrs_tpu_torch import params as TP


def test_checked_passes_clean_fn():
    f = DBG.checked(lambda x: torch.sum(x * 2))
    assert float(f(torch.ones(4))) == 8.0


def test_checked_raises_on_nan():
    f = DBG.checked(lambda x: torch.log(x).sum())
    with pytest.raises(DBG.CheckError, match="log") as e:
        f(torch.tensor([-1.0, 2.0]))        # log(-1) = nan
    assert (e.value.op, e.value.kind) == ("log", "nan")


def test_global_norm():
    tree = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    np.testing.assert_allclose(float(DBG.global_norm(tree)), 5.0, rtol=1e-6)


def test_debug_mode_restores_flag():
    prev = torch.is_anomaly_enabled()
    with DBG.debug_mode():
        assert torch.is_anomaly_enabled() is True
        with pytest.raises(DBG.CheckError, match="div"):
            torch.ones(2) / torch.zeros(2)      # a new Inf
    assert torch.is_anomaly_enabled() == prev
    assert torch.isinf(torch.ones(2) / torch.zeros(2)).all()   # off again


def test_checked_model_forward_names_the_op():
    _, tcfg = small_cfgs(dtype="float32")
    pp = TM.prepare_params(TP.from_numpy(np_params(tcfg), tcfg, "cpu"), tcfg)
    tok = torch.as_tensor(np.random.default_rng(0).integers(
        0, tcfg.vocab_size, (2, 16)))
    fwd = DBG.checked(lambda p, t: TM.gpt_forward(p, t, tcfg))
    assert torch.isfinite(fwd(pp, tok)).all()      # masks fill -inf: passes
    with pytest.raises(DBG.CheckError) as e:
        fwd(pp, tok + tcfg.vocab_size)
    assert e.value.kind == "index"
    bad = dict(pp, wte=pp["wte"].clone())
    bad["wte"][int(tok[0, 3])] = float("nan")
    with pytest.raises(DBG.CheckError) as e:
        fwd(bad, tok)
    assert (e.value.op, e.value.kind) == ("__getitem__", "nan")
    with pytest.raises(DBG.CheckError, match="gather"):
        DBG.checked(torch.gather)(torch.ones(2, 3), 1,
                                  torch.tensor([[3], [0]]))
