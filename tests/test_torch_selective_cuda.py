"""PyTorch port, on the card: selective and full remat through the kernels
(K1-fwd and K2 for MHA, K3 under GQA, rope and the band inside them).

  * a small model's loss and 16 gradients under remat True and "full"
    against remat False, bf16 compute over fp32 masters: the selective
    backward repeats the plain block's operations, so rtol 5e-4 with atol
    1e-6 (qkvb's K third, an exactly zero gradient, atol 2e-4) holds;
  * the launches of one step: K1-fwd (or K3-fwd) L, L and 2L; K2 (or
    K3-bwd) L each: the selective backward runs the flash backward from
    the saved out and lse and never the forward;
  * the selective peak memory below the plain one at a longer sequence.

These need an NVIDIA GPU with sm_90a and nvcc: each test skips without a
CUDA device (decided inside the `cuda` fixture, never at import).  Run them
on the card with
    python -m pytest tests/test_torch_selective_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from vitrs_tpu_torch import params as P
from vitrs_tpu_torch.config import get_config
from vitrs_tpu_torch.models import model as M
from vitrs_tpu_torch.ops import flash_attention as FA
from vitrs_tpu_torch.ops import flash_attention_gqa as FG


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CASES = {"mha": dict(num_heads=2, channels=128),
         "gqa-kv2": dict(num_heads=4, channels=256, num_kv_heads=2),
         "rope-window": dict(num_heads=2, channels=128, pos_emb="rope",
                             window=64),
         "vit": dict(num_heads=2, channels=128)}


def _cfg(case, remat, T=256):
    if case == "vit":
        return get_config("vit-tiny-4-cifar10").replace(
            num_layers=2, img_size=32, patch_size=4, dtype="bfloat16",
            remat=remat, **CASES[case])
    return get_config("gpt-nano").replace(
        num_layers=2, vocab_size=16500, max_seq_len=T, dtype="bfloat16",
        remat=remat, **CASES[case])


def _counters(cfg):
    if cfg.kv_heads != cfg.num_heads:
        return FG.flash_gqa_fwd_cuda, FG.flash_gqa_bwd_cuda
    return FA.flash_fwd_cuda, FA.flash_bwd_cuda


def _step(cfg, cuda, seed=0):
    """(loss, grads, (forward, backward) launches) of one step."""
    params = P.init_params(cfg, torch.Generator().manual_seed(seed))
    leaves = {k: t.to(cuda).requires_grad_(True) for k, t in params.items()}
    rng = np.random.default_rng(seed)
    if cfg.mode == "vit":
        x = torch.as_tensor(rng.standard_normal((4, 32, 32, 3)),
                            dtype=torch.float32, device=cuda)
        y = torch.as_tensor(rng.integers(0, 10, 4), device=cuda)
    else:
        x, y = (torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                             (2, cfg.max_seq_len)),
                                device=cuda) for _ in range(2))
    fwd, bwd = _counters(cfg)
    before = fwd.launches, bwd.launches
    loss = M.loss_fn(leaves, x, y, cfg)
    loss.backward()
    torch.cuda.synchronize()
    ran = fwd.launches - before[0], bwd.launches - before[1]
    return loss.item(), {k: t.grad for k, t in leaves.items()}, ran


@pytest.mark.parametrize("remat", [True, "full"], ids=["selective", "full"])
@pytest.mark.parametrize("case", list(CASES))
def test_remat_matches_the_plain_block_on_the_kernels(cuda, case, remat):
    L = 2
    l0, g0, ran0 = _step(_cfg(case, False), cuda)
    l1, g1, ran1 = _step(_cfg(case, remat), cuda)
    assert ran0 == (L, L)
    assert ran1 == ((2 * L if remat == "full" else L), L)
    assert abs(l1 - l0) <= 2e-5 * abs(l0)
    for k, want in g0.items():
        if want is None:
            assert g1[k] is None
            continue
        atol = 2e-4 if k == "qkvb" else 1e-6
        d = (g1[k] - want).abs()
        assert bool((d <= atol + 5e-4 * want.abs()).all()), (
            k, d.max().item())


def test_selective_peak_memory_is_below_the_plain_peak(cuda):
    peaks = {}
    for remat in (False, True):
        cfg = _cfg("mha", remat, T=2048).replace(num_layers=4)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _step(cfg, cuda)
        peaks[remat] = torch.cuda.max_memory_allocated()
    assert peaks[True] < peaks[False], peaks
