"""PyTorch port, on the card: the GELU kernels (csrc/gelu.cu,
ops/fused_gelu.py) against their plain versions, the eager chain of
ops/basic.py (`gelu_fwd_plain` / `gelu_bwd_plain`), run on the same card
in the working dtype.

  * forward and backward, tanh and exact, bf16 and fp32, at the three
    benchmark cells' activations ((64 * 1024, 3072) GPT-2 training,
    (128 * 197, 3072) ViT-B/16 training, (256 * 197, 3072) ViT-B/16
    inference), at n = 1, 7, 8, 9 and 8k + 3 (the 16-byte vectors and the
    scalar tail), on a 3-D (E, cap, 4C) expert activation, and on every
    bf16 bit pattern;
  * a second call gives the same bits;
  * a non-contiguous view, an fp16 tensor and a misaligned view are
    refused with ValueError before any launch;
  * the launch counters: a GPT training step (loss and backward) counts one
    forward and one backward launch a layer, an inference `vit_forward` one
    forward a layer and no backward.

Tolerances:
  bf16 forward  bit for bit: the kernel rounds to bf16 after every step at
                which the eager bf16 kernels round (the exact form once, at
                the end), with the same fp32 operations and the same
                tanhf / erff in between;
  bf16 backward one bf16 ulp: one fp32 formula rounded once, in the eager
                order; an ulp leaves room for a libm difference between the
                toolkit that built PyTorch and the one that builds the kernel;
  fp32          2e-6 relative: the same fp32 operations in the same order.

These need an NVIDIA GPU with sm_90a and nvcc: each test skips without a
CUDA device (decided inside the `cuda` fixture, never at import).  They
import no JAX.  Run them on the card with
    python -m pytest tests/test_torch_gelu_cuda.py -q --noconftest
"""

import pytest
import torch

from vitrs_tpu_torch import params as P
from vitrs_tpu_torch.config import get_config
from vitrs_tpu_torch.models import model as M
from vitrs_tpu_torch.ops import basic
from vitrs_tpu_torch.ops import fused_gelu as FG

CELL_SHAPES = ((64 * 1024, 3072), (128 * 197, 3072), (256 * 197, 3072))
EDGE_SIZES = (1, 7, 8, 9, 8 * 1001 + 3)
DTYPES = (torch.bfloat16, torch.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _draw(shape, dtype, seed, device):
    """N(0, 3^2) values with the ends of the range at the front: zeros,
    tiny and huge values of both signs, the tanh form's overflow of x^3."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = 3.0 * torch.randn(shape, generator=g, device=device)
    ends = torch.tensor([0.0, -0.0, 1e-30, -1e-30, 1e-3, -1e-3, 6.0, -6.0,
                         20.0, -20.0, 1e20, -1e20, 3e38, -3e38],
                        device=device)
    flat = x.view(-1)
    k = min(flat.numel(), ends.numel())
    flat[:k] = ends[:k]
    return x.to(dtype)


def _ulps(a, b):
    """Per-element distance in bf16 units in the last place (ordered
    integers of the bit patterns)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -32768 - i, i)
    return (ordered(a) - ordered(b)).abs()


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _assert_close(got, want, exact):
    """NaN where the plain version gives NaN (the tanh backward's inf * 0
    at |x| >= 1e20), the tolerance above everywhere else."""
    assert got.dtype == want.dtype and got.shape == want.shape
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    got, want = got[~nan], want[~nan]
    if got.dtype == torch.bfloat16:
        if exact:
            assert torch.equal(_bits(got), _bits(want)), (
                f"{(got != want).sum().item()} of {got.numel()} values differ")
        else:
            assert _ulps(got, want).max().item() <= 1
    else:
        err = (got - want).abs()
        assert torch.all(err <= 2e-6 * want.abs()), err.max().item()


def _shapes():
    return CELL_SHAPES + tuple((n,) for n in EDGE_SIZES) + ((8, 1024, 3072),)


@pytest.mark.parametrize("erf", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_matches_the_eager_chain(cuda, dtype, erf):
    for i, shape in enumerate(_shapes()):
        x = _draw(shape, dtype, i, cuda)
        before = FG.gelu_fwd_cuda.launches
        got = FG.gelu_fwd_cuda(x, erf)
        want = basic.gelu_fwd_plain(x, erf)
        torch.cuda.synchronize()
        assert FG.gelu_fwd_cuda.launches == before + 1
        _assert_close(got, want, exact=True)
        assert torch.equal(_bits(FG.gelu_fwd_cuda(x, erf)), _bits(got))


@pytest.mark.parametrize("erf", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_backward_matches_the_eager_chain(cuda, dtype, erf):
    for i, shape in enumerate(_shapes()):
        x = _draw(shape, dtype, i, cuda)
        dy = _draw(shape, dtype, 100 + i, cuda)
        before = FG.gelu_bwd_cuda.launches
        got = FG.gelu_bwd_cuda(x, dy, erf)
        want = basic.gelu_bwd_plain(x, dy, erf)
        torch.cuda.synchronize()
        assert FG.gelu_bwd_cuda.launches == before + 1
        _assert_close(got, want, exact=False)
        assert torch.equal(_bits(FG.gelu_bwd_cuda(x, dy, erf)), _bits(got))


@pytest.mark.parametrize("erf", [False, True])
def test_every_bf16_value(cuda, erf):
    """All 65,536 bf16 bit patterns: subnormals, infinities and NaNs too."""
    x = torch.arange(-32768, 32768, dtype=torch.int32, device=cuda).to(
        torch.int16).view(torch.bfloat16)
    _assert_close(FG.gelu_fwd_cuda(x, erf), basic.gelu_fwd_plain(x, erf),
                  exact=True)
    dy = _draw(x.shape, torch.bfloat16, 5, cuda)
    _assert_close(FG.gelu_bwd_cuda(x, dy, erf), basic.gelu_bwd_plain(x, dy, erf),
                  exact=False)


def test_the_ops_route_cuda_tensors_to_the_kernels(cuda):
    x = _draw((4, 3072), torch.bfloat16, 7, cuda)
    dy = _draw((4, 3072), torch.bfloat16, 8, cuda)
    f, b = FG.gelu_fwd_cuda.launches, FG.gelu_bwd_cuda.launches
    assert torch.equal(_bits(basic.gelu_fwd_op(x, True)),
                       _bits(FG.gelu_fwd_cuda(x, True)))
    assert torch.equal(_bits(basic.gelu_bwd_op(x, dy, False)),
                       _bits(FG.gelu_bwd_cuda(x, dy, False)))
    assert (FG.gelu_fwd_cuda.launches, FG.gelu_bwd_cuda.launches) == (f + 2,
                                                                     b + 2)


def test_refusals_come_before_any_launch(cuda):
    x = _draw((64, 3072), torch.bfloat16, 9, cuda)
    cases = (("non-contiguous", x.t()),
             ("fp16", x.to(torch.float16)),
             ("misaligned", x.view(-1)[1:8193]))
    f, b = FG.gelu_fwd_cuda.launches, FG.gelu_bwd_cuda.launches
    for what, bad in cases:
        with pytest.raises(ValueError):
            FG.gelu_fwd_cuda(bad, False)
        with pytest.raises(ValueError):
            FG.gelu_bwd_cuda(bad, bad, True)
        ok = torch.empty(bad.shape, dtype=torch.bfloat16, device=cuda)
        with pytest.raises(ValueError):
            FG.gelu_bwd_cuda(ok, bad, False)
    torch.cuda.synchronize()
    assert (FG.gelu_fwd_cuda.launches, FG.gelu_bwd_cuda.launches) == (f, b)


def test_a_gpt_training_step_launches_once_a_layer_each_way(cuda):
    cfg = get_config("gpt-nano").replace(
        num_layers=3, num_heads=2, channels=128, max_seq_len=64,
        vocab_size=512, dtype="bfloat16")
    params = P.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    g = torch.Generator(device=cuda).manual_seed(1)
    tokens = torch.randint(0, 512, (4, 64), generator=g, device=cuda)
    targets = torch.randint(0, 512, (4, 64), generator=g, device=cuda)
    f, b = FG.gelu_fwd_cuda.launches, FG.gelu_bwd_cuda.launches
    M.gpt_loss(params, tokens, targets, cfg).backward()
    torch.cuda.synchronize()
    assert FG.gelu_fwd_cuda.launches - f == cfg.num_layers
    assert FG.gelu_bwd_cuda.launches - b == cfg.num_layers
    assert all(torch.isfinite(p.grad).all() for p in params.values())


def test_a_vit_inference_forward_launches_once_a_layer(cuda):
    cfg = get_config("vit-tiny-4-cifar10").replace(
        num_layers=3, dtype="bfloat16", act="gelu_erf")
    params = P.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    images = torch.randn(8, 32, 32, 3, device=cuda)
    f, b = FG.gelu_fwd_cuda.launches, FG.gelu_bwd_cuda.launches
    with torch.inference_mode():
        logits = M.vit_forward(M.prepare_params(params, cfg), images, cfg)
    torch.cuda.synchronize()
    assert logits.shape == (8, cfg.num_classes)
    assert FG.gelu_fwd_cuda.launches - f == cfg.num_layers
    assert FG.gelu_bwd_cuda.launches == b
