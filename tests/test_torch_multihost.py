"""The port's parallel/multihost.py and the sharded checkpoint's barrier:
no process group without a cluster, a loud failure within its timeout for
a cluster that cannot be reached, and a 2-rank `save_checkpoint_sharded`
(each rank its byte range, barriers between) byte-equal to one
`save_checkpoint`."""

import socket
import time

import numpy as np
import pytest
import torch.distributed as dist

from vitrs_tpu_torch import checkpoint as TCK
from vitrs_tpu_torch import params as TP
from vitrs_tpu_torch.parallel import multihost as MH
from test_torch_helpers import np_params, small_cfgs, spawn_ranks


def test_no_cluster_no_group(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert MH.initialize(device="cpu") is False
    assert not dist.is_initialized()
    assert MH.host_info()["num_processes"] == 1 and MH.is_primary()


def test_unreachable_cluster_fails_loudly_within_its_timeout():
    with socket.socket() as s:         # a free local port nobody listens on
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError):
        MH.initialize(f"tcp://127.0.0.1:{port}", world_size=2, rank=1,
                      device="cpu", timeout=2)
    assert time.perf_counter() - t0 < 30
    assert not dist.is_initialized()


def test_sharded_checkpoint_equals_one_save(tmp_path):
    _, cfg = small_cfgs(max_seq_len=16)
    arrs = np_params(cfg, seed=7)
    n = TP.num_parameters(cfg)
    rng = np.random.default_rng(7)
    m, v = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    path = str(tmp_path / "sharded.bin")
    spawn_ranks("ckpt", 2, tmp_path / "ranks",
                {"preset": "gpt-nano", "overrides": dict(
                    num_layers=2, num_heads=2, channels=128, vocab_size=97,
                    max_seq_len=16), "path": path},
                {**{"p/" + k: a for k, a in arrs.items()}, "m": m, "v": v})
    one = str(tmp_path / "one.bin")
    TCK.save_checkpoint(one, TP.from_numpy(arrs, cfg, "cpu"), cfg, m=m, v=v,
                        step=7, seed=3, cursor=96)
    with open(path, "rb") as a, open(one, "rb") as b:
        assert a.read() == b.read()


def test_dryrun_multichip_two_ranks():
    from vitrs_tpu_torch.parallel import dryrun
    assert np.isfinite(dryrun.dryrun_multichip(2))
