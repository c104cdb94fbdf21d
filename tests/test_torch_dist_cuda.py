"""PyTorch port, on the card: the kernels as `torch.library` ops, export
serving, the NaN guards and ZeRO-1 over two ranks sharing the card.

  * `opcheck` (schema, fake tensor) of the K1-fwd, K2, K5/K6 and K7 ops on
    CUDA tensors, and the K1-fwd op's result equal to its wrapper's;
  * a small fp32 model (L=2, 2 heads of 64) exported on the card: logits
    equal to the eager forward's bit for bit, K1-fwd once a layer a call;
  * `utils/debug.checked` on the card naming the op that makes a NaN;
  * `parallel/dryrun`-style ZeRO-1: two gloo ranks on cuda:0, one step,
    the same loss on both ranks as one process stepping the whole batch.

These need an NVIDIA GPU with sm_90a and nvcc: each test skips without a
CUDA device (decided inside the `cuda` fixture, never at import).  They
import no JAX.  Run them on the card with
    python -m pytest tests/test_torch_dist_cuda.py -q --noconftest
"""

import multiprocessing as mp

import numpy as np
import pytest
import torch

from vitrs_tpu_torch import params as P
from vitrs_tpu_torch import serving as S
from vitrs_tpu_torch.config import get_config
from vitrs_tpu_torch.models import model as M
from vitrs_tpu_torch.ops import flash_attention as FA
from vitrs_tpu_torch.ops import fused_adamw as FW
from vitrs_tpu_torch.ops import fused_ce as CE
from vitrs_tpu_torch.utils import debug as DBG

CHECKS = ("test_schema", "test_faketensor")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _cfg():
    return get_config("gpt-nano").replace(
        num_layers=2, num_heads=2, channels=128, max_seq_len=64,
        vocab_size=512, dtype="float32")


def test_ops_pass_opcheck_on_the_card(cuda):
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(2, 128, 3 * 128, generator=g, device="cuda")
    q, k, v = qkv.split(128, dim=-1)
    out, lse = FA.flash_fwd_cuda(q, k, v, 2, True, 0.125)
    logits = torch.randn(256, 512, generator=g, device="cuda")
    tgt = torch.randint(0, 500, (256,), generator=g, device="cuda")
    clse, _ = CE.ce_fwd_cuda(logits, tgt, 500)
    n = 4099
    cases = [
        (FA.flash_fwd_op, (q, k, v, 2, True, 0.125, 0, False)),
        (FA.flash_bwd_op, (q, k, v, out, lse, torch.ones_like(q), 2, True,
                           0.125, 0, False)),
        (CE.ce_fwd, (logits, tgt, 500)),
        (CE.ce_bwd, (logits, tgt, clse, torch.ones(256, device="cuda"),
                     500)),
        (FW.adamw_op, tuple(torch.rand(n, generator=g, device="cuda")
                            for _ in range(4)) + (2.0, 1e-3, 0.9, 0.999,
                                                  1e-8, 0.1)),
    ]
    for op, args in cases:
        got = torch.library.opcheck(op, args, test_utils=CHECKS)
        assert all(v == "SUCCESS" for v in got.values()), (op, got)
    via_op = FA.flash_fwd_op(q, k, v, 2, True, 0.125, 0, False)
    assert all(torch.equal(a, b) for a, b in zip(via_op, (out, lse)))


def test_export_on_the_card_equals_eager(cuda, tmp_path):
    cfg = _cfg()
    params = P.init_params(cfg, torch.Generator(device="cuda").manual_seed(1))
    path = str(tmp_path / "m.vitrs")
    S.export_forward(params, cfg, 2, path)
    served = S.ServedModel(path)
    tok = torch.randint(0, cfg.vocab_size, (2, 64), device="cuda",
                        dtype=torch.int32)
    FA.flash_fwd_cuda.launches = 0
    got = served(tok)
    assert FA.flash_fwd_cuda.launches == cfg.num_layers
    want = M.gpt_forward(M.prepare_params(params, cfg), tok.long(), cfg)
    assert torch.equal(got, want)


def test_checked_names_the_op_on_the_card(cuda):
    x = torch.tensor([-1.0, 2.0], device="cuda")
    with pytest.raises(DBG.CheckError, match="sqrt"):
        DBG.checked(torch.sqrt)(x)
    with pytest.raises(DBG.CheckError, match="index"):
        DBG.checked(torch.index_select)(x, 0, torch.tensor([2],
                                                           device="cuda"))


def _rank(rank, rdv, out):
    torch.backends.cuda.matmul.allow_tf32 = False
    from vitrs_tpu_torch.parallel import data_parallel as dp
    from vitrs_tpu_torch.parallel import multihost
    torch.cuda.set_device(0)
    multihost.initialize("file://" + rdv, 2, rank, backend="gloo",
                         device="cuda:0", timeout=300)
    loss = _zero1_loss(dp.make_mesh(devices=["cuda:0"]), rank, 2)
    out.put((rank, loss))
    torch.distributed.destroy_process_group()


def _zero1_loss(mesh, rank, world):
    from vitrs_tpu_torch.parallel import data_parallel as dp
    cfg = _cfg()
    params = P.unflatten_params(P.flatten_params(
        P.init_params(cfg, torch.Generator().manual_seed(2)), cfg).cuda(), cfg)
    rng = np.random.default_rng(2)
    x = rng.integers(0, cfg.vocab_size, (4, 64))
    b = 4 // world
    xs = x[rank * b:(rank + 1) * b]
    m, v = dp.init_sharded_opt_state(cfg, mesh)
    *_, loss = dp.make_dp_train_step(cfg, mesh)(
        params, m, v, xs, np.roll(xs, -1, 1), 1, 1e-3, 0.1)
    return loss.item()


def test_zero1_two_ranks_share_the_card(cuda, tmp_path):
    from vitrs_tpu_torch.parallel import data_parallel as dp
    want = _zero1_loss(dp.make_mesh(devices=["cuda:0"]), 0, 1)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, str(tmp_path / "rdv"), out))
             for r in range(2)]
    for p in procs:
        p.start()
    got = dict(out.get(timeout=300) for _ in procs)
    for p in procs:
        p.join(timeout=60)
        assert p.exitcode == 0
    assert got[0] == got[1]
    np.testing.assert_allclose(got[0], want, rtol=1e-5)
