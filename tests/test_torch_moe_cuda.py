"""PyTorch port, on the card: the MoE layer (ops/moe.py) and the MoE
training step through the kernels.

  * `moe_mlp` in bf16 at gpt2-moe-8e's width (C=768, E=8, top-2, cap factor
    1.0, S=4096), forward and backward twice: the same bits (the gather-only
    backward; autograd's index_add_ would add with atomics);
  * `moe_mlp` in fp32 on the card against the CPU, with assignments
    dropped: the same router dst, the output and all six gradients;
  * one Adafactor step of a small fp32 MoE model (2 heads of 64: K1-fwd,
    K2; V=16500: K5, K6) on the card against the same step on the CPU.

These need an NVIDIA GPU with sm_90a and nvcc: each test skips without a
CUDA device (decided inside the `cuda` fixture, never at import).  They
import no JAX.  Run them on the card with
    python -m pytest tests/test_torch_moe_cuda.py -q --noconftest
Tolerances (TF32 off, fp32 sums in other orders): the layer's output rtol
1e-5 + atol 1e-6, its gradients rtol 5e-4 (ROADMAP.md's CPU parity
tolerance) + 1e-5 of each gradient's largest value (sums over the tokens
cancel to near 0: read 3e-6 where the largest is far above;
tests/test_torch_vit_cuda.py's rule); the step's loss rtol
1e-5, gradients rtol 1e-4 + atol 1e-6 (the packed qkv bias atol 2e-4: its k
third's gradient is exactly 0, so both hold fp32 noise), parameters after
Adafactor rtol 1e-4 + atol 5e-5 (tests/test_torch_adafactor.py's), the
qkv bias on its q and v thirds (Adafactor scales noise to a full step).
"""

import numpy as np
import pytest
import torch

from vitrs_tpu_torch import params as P
from vitrs_tpu_torch.config import get_config
from vitrs_tpu_torch.ops import adafactor as AF
from vitrs_tpu_torch.ops import flash_attention as FA
from vitrs_tpu_torch.ops import fused_ce as CE
from vitrs_tpu_torch.ops import moe as MOE
from vitrs_tpu_torch.parallel import data_parallel as dp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _layer(S, C, E, dtype, device, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(S, C, generator=gen)
    ws = [0.05 * torch.randn(s, generator=gen)
          for s in ((E, C), (E, 4 * C, C), (E, 4 * C), (E, C, 4 * C), (E, C))]
    # the router stays fp32, as the model keeps it
    ws = [ws[0]] + [w.to(dtype) for w in ws[1:]]
    return ([x.to(dtype).to(device)] + [w.to(device) for w in ws],
            torch.randn(S, C, generator=gen).to(dtype).to(device))


def _fwd_bwd(leaves, dout):
    leaves = [t.clone().requires_grad_(True) for t in leaves]
    out, aux = MOE.moe_mlp(*leaves, top_k=2, cap_factor=1.0)
    ((out.float() * dout.float()).sum() + aux.load_balance
     + aux.z_loss).backward()
    return [out.detach(), aux.kept_fraction] + [t.grad for t in leaves]


def test_moe_mlp_is_bitwise_repeatable_on_the_card(cuda):
    leaves, dout = _layer(4096, 768, 8, torch.bfloat16, "cuda", 0)
    a, b = _fwd_bwd(leaves, dout), _fwd_bwd(leaves, dout)
    torch.cuda.synchronize()
    assert a[1].item() < 1.0, "no assignment dropped"
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_moe_mlp_on_the_card_matches_the_cpu(cuda, monkeypatch):
    dsts = []
    real = MOE.router

    def recording(*a):
        routed = real(*a)
        dsts.append(routed[0].cpu())
        return routed

    monkeypatch.setattr(MOE, "router", recording)
    leaves, dout = _layer(1024, 128, 4, torch.float32, "cpu", 1)
    want = _fwd_bwd(leaves, dout)
    got = _fwd_bwd([t.cuda() for t in leaves], dout.cuda())
    assert torch.equal(dsts[0], dsts[1])
    assert want[1].item() < 1.0, "no assignment dropped"
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-5, atol=1e-6)
    for g, w in zip(got[2:], want[2:]):
        torch.testing.assert_close(g.cpu(), w, rtol=5e-4,
                                   atol=1e-5 * w.abs().max().item())


def test_moe_adafactor_step_on_the_card_matches_the_cpu(cuda):
    cfg = get_config("gpt-nano").replace(
        num_layers=2, num_heads=2, channels=128, max_seq_len=64,
        vocab_size=16500, num_experts=4, moe_top_k=2, moe_cap_factor=1.0)
    params = P.init_params(cfg, torch.Generator().manual_seed(2))
    rng = np.random.default_rng(2)
    x = rng.integers(0, cfg.vocab_size, (2, 64))
    y = rng.integers(0, cfg.vocab_size, (2, 64))
    out = {}
    for dev in ("cuda", "cpu"):
        wrappers = (FA.flash_fwd_cuda, FA.flash_bwd_cuda, CE.ce_fwd_cuda,
                    CE.ce_bwd_cuda)
        for w in wrappers:
            w.launches = 0
        leaves = P.unflatten_params(P.flatten_params(
            {k: t.to(dev) for k, t in params.items()}, cfg), cfg)
        step = dp.make_dp_train_step_adafactor(cfg,
                                               dp.make_mesh(devices=[dev]))
        new, _, loss = step(leaves, AF.init_state(leaves), x, y, 1, 1e-2,
                            0.1)
        out[dev] = (loss.item(), {k: t.grad.cpu() for k, t in new.items()},
                    {k: t.detach().cpu() for k, t in new.items()},
                    [w.launches for w in wrappers])
    assert out["cuda"][3] == [2, 2, 1, 1] and out["cpu"][3] == [0, 0, 0, 0]
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    C = cfg.channels
    for k, w in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][k], w, rtol=1e-4,
                                   atol=2e-4 if k == "qkvb" else 1e-6)
        g, w = out["cuda"][2][k], out["cpu"][2][k]
        if k == "qkvb":
            g, w = (torch.cat([t[:, :C], t[:, 2 * C:]], -1) for t in (g, w))
        torch.testing.assert_close(g, w, rtol=1e-4, atol=5e-5)
