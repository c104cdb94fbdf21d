"""PyTorch port, on the card: vit mode's kernels and paths.

  K1-fwd  csrc/flash_fwd.cu   non-causal, T in {17, 65, 197, 257} (the CPU
                              test model's, vit-tiny-4-cifar10's, ViT-B/16's
                              and CLIP-L/14's token counts), NH=12;
  K2      csrc/flash_bwd.cu   the same cases;
each against its plain version, in bf16 and fp32, and twice with bitwise
equal results.  Then one ViT-B/16 training step (full width and depth,
fp32, B=2) through the kernels (K1-fwd, K2, K7) against the same step with
the plain versions put in their place on the card, and the ViT-S/16
inference logits (bf16, B=8) through K1-fwd against the plain version's.

These need an NVIDIA GPU with sm_90a and nvcc: each test skips without a
CUDA device (decided inside the `cuda` fixture, never at import).  They
import no JAX.  Run them on the card with
    python -m pytest tests/test_torch_vit_cuda.py -q --noconftest
Tolerances:
  K1-fwd  out as chip_smoke.out_errors (tests/flash_tolerance.py); lse
          1e-4 bf16, 1e-5 fp32 (the same fp32 p summed in another order);
  K2      2e-2 abs + rel bf16, 1e-4 fp32 (tests/test_torch_train_cuda.py);
  step    fp32 throughout (TF32 off): loss rtol 1e-5; each gradient
          within 1e-5 of its largest value (fp32 sums in another order,
          compounded over 12 layers of backward: read up to 2.2e-6 on an
          H100); parameters after AdamW
          within 1e-6 + 2e-5 |p|, or 2 lr where the gradient is within its
          tolerance of 0 (AdamW from zero moments moves a value by about
          lr sign(g), so noise that flips a sign moves it by up to 2 lr);
  infer   bf16 logits within 2e-2 of their largest value: both sides round
          at the same points, p rounds against the kernel's running max
          but the plain version's final max (out_errors' reasoning), over
          12 layers.
"""

import numpy as np
import pytest
import torch

from flash_tolerance import assert_out_close
from vitrs_tpu_torch import params as P
from vitrs_tpu_torch.cli import infer
from vitrs_tpu_torch.config import get_config
from vitrs_tpu_torch.models import model as M
from vitrs_tpu_torch.ops import flash_attention as FA
from vitrs_tpu_torch.ops import fused_adamw as FW
from vitrs_tpu_torch.parallel import data_parallel as dp

NH, D = 12, 64
C = NH * D
# the kernel wrappers, whose launch counts the tests read (`plain_on_card`
# puts the plain versions in their place in the module)
FWD, BWD = FA.flash_fwd_cuda, FA.flash_bwd_cuda
TOL = {torch.bfloat16: (1e-4, 2e-2), torch.float32: (1e-5, 1e-4)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def plain_on_card(monkeypatch):
    """Put the plain versions where the kernel wrappers were, so that a
    CUDA run computes with them."""
    def use():
        monkeypatch.setattr(FA, "flash_fwd_cuda", FA.flash_fwd_plain)
        monkeypatch.setattr(FA, "flash_bwd_cuda", FA.flash_bwd_plain)
        monkeypatch.setattr(FW, "adamw_cuda", FW.adamw_plain)
    return use


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T", [17, 65, 197, 257])
def test_noncausal_fwd_and_bwd_match_plain_and_repeat(cuda, T, dtype):
    g = torch.Generator(device=cuda).manual_seed(T)
    qkv = torch.randn(2, T, 3 * C, generator=g, device=cuda).to(dtype)
    do = torch.randn(2, T, C, generator=g, device=cuda).to(dtype)
    q, k, v = qkv.split(C, dim=-1)
    (out, lse), (out2, lse2) = (FA.flash_fwd_cuda(q, k, v, NH, False, 0.125)
                                for _ in range(2))
    ref, ref_lse = FA.flash_fwd_plain(q, k, v, NH, False, 0.125)
    got, again = (FA.flash_bwd_cuda(q, k, v, out, lse, do, NH, False, 0.125)
                  for _ in range(2))
    want = FA.flash_bwd_plain(q, k, v, out, lse, do, NH, False, 0.125)
    torch.cuda.synchronize()
    lse_tol, tol = TOL[dtype]
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert_out_close(out, ref)
    assert (lse - ref_lse).abs().max().item() <= lse_tol
    for name, a, b, c in zip(("dq", "dk", "dv"), got, again, want):
        assert torch.equal(a, b), name
        torch.testing.assert_close(a.float(), c.float(), rtol=tol, atol=tol,
                                   msg=name)


def _vit_b16_step(device, B=2, lr=1e-3):
    """(loss, grads, params after one step, launches) of one fp32 ViT-B/16
    training step on `device` from seeded weights and a seeded uint8
    batch: the gradients from `loss_fn`, then the trainer's step."""
    from vitrs_tpu_torch.data import datasets as DS
    cfg = get_config("vit-b-16", dtype="float32")
    params = P.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (B, 224, 224, 3)).astype(np.uint8)
    y = rng.integers(0, 1000, B)
    stats = (DS.IMAGENET_MEAN, DS.IMAGENET_STD)
    before = (FWD.launches, BWD.launches)
    leaves = {k: t.to(device).requires_grad_(True) for k, t in params.items()}
    xd = dp.normalize_images(torch.as_tensor(x, device=device), *stats)
    loss = M.loss_fn(leaves, xd, torch.as_tensor(y, device=device), cfg)
    loss.backward()
    grads = {k: torch.zeros(t.shape) if t.grad is None else t.grad.cpu()
             for k, t in leaves.items()}
    del leaves
    mesh = dp.make_mesh(devices=[device])
    m, v = dp.init_sharded_opt_state(cfg, mesh)
    step = dp.make_dp_train_step(cfg, mesh, normalize=stats)
    flat = P.flatten_params(params, cfg).to(device)
    new, _, _, _ = step(P.unflatten_params(flat, cfg), m, v, x, y, 1, lr,
                        0.05)
    launches = (FWD.launches - before[0], BWD.launches - before[1])
    return (loss.item(), grads, {k: t.detach().cpu() for k, t in new.items()},
            launches)


def test_vit_b16_step_on_the_kernels_matches_the_plain_versions(
        cuda, plain_on_card):
    lk, gk, pk, (nf, nb) = _vit_b16_step(cuda)
    assert nf == nb == 24              # 12 layers, in loss_fn and in the step
    plain_on_card()
    lp, gp, pp, _ = _vit_b16_step(cuda)
    assert abs(lk - lp) <= 1e-5 * abs(lp), (lk, lp)
    for k in gp:
        gtol = 1e-5 * gp[k].abs().max().item()
        err = (gk[k] - gp[k]).abs().max().item()
        assert err <= gtol, (k, err, gtol)
        tol = torch.where(gp[k].abs() <= gtol, torch.full_like(gp[k], 2e-3),
                          1e-6 + 2e-5 * pp[k].abs())
        d = pk[k] - pp[k]
        assert bool((d.abs() <= tol).all()), (k, d.abs().max().item())


def test_vit_s16_infer_logits_match_the_plain_version(cuda, plain_on_card):
    before = FWD.launches
    got = infer.run("vit-s-16", batch_size=8, steps=1, dtype="bfloat16",
                    device="cuda")["logits"]
    assert FWD.launches - before == 24     # warm-up + 1 step, 12 layers
    plain_on_card()
    want = infer.run("vit-s-16", batch_size=8, steps=1, dtype="bfloat16",
                     device="cuda")["logits"]
    assert got.shape == (8, 1000) and bool(torch.isfinite(got).all())
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert err <= 2e-2, err
