"""PyTorch port: entry points put their tensors on the card unless the
caller asks for the CPU, and raise when torch sees no CUDA device; nothing
falls back to the CPU on its own.  (torch's view of the card is patched
away, so these run the same with and without one.)"""

import pytest
import torch

from vitrs_tpu_torch import params as TP
from vitrs_tpu_torch.config import get_config
from vitrs_tpu_torch.models import generate as TG
from vitrs_tpu_torch.parallel import data_parallel as TDP

from test_torch_helpers import np_params

CFG = get_config("gpt-nano")
RING = CFG.replace(window=4).validate()


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)


@pytest.mark.parametrize("make", [
    lambda dev: TG.init_kv_cache(CFG, 2, 8, **dev),
    lambda dev: TG.init_ring_kv(RING, 2, 4, **dev),
    lambda dev: TP.from_numpy(np_params(CFG), CFG, **dev),
], ids=["init_kv_cache", "init_ring_kv", "from_numpy"])
def test_defaults_to_the_card_and_takes_the_cpu_by_name(no_card, make):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make({})
    out = make({"device": "cpu"})
    tensors = out.values() if isinstance(out, dict) else out
    assert all(t.device.type == "cpu" for t in tensors)


def test_make_mesh_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TDP.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TDP.make_mesh(2)
    assert TDP.make_mesh(devices=["cpu"]).devices == (torch.device("cpu"),)
