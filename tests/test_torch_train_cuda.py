"""PyTorch port, on the card: the training slice's kernels against their
plain versions at edge shapes, and one training step on CUDA against the
same step on the CPU.

  K2  csrc/flash_bwd.cu    flash backward      T in {1, 37, 64, 200, 1024};
                                               bf16 at ragged T, sm_scale
                                               1/8 and 0.1, bitwise
                                               repeatable
  K5  csrc/fused_ce.cu     CE forward          rows not a multiple of 32
  K6  csrc/fused_ce.cu     CE backward         same
  K7  csrc/fused_adamw.cu  AdamW               n not a multiple of 4

and the fused qkv op's weight gradient (an fp32 cuBLAS product of bf16
operands) against the CPU's; the prefetcher's stream and event order
(data/prefetch.py: every batch lands whole before the step that reads it,
however busy the step's stream is, and its pinned buffers are reused only
after their copies); the async checkpoint's snapshot under an in-place K7
(checkpoint_async.py: the file holds the values of save() time).

These need an NVIDIA GPU with sm_90a and nvcc: each test skips without a
CUDA device (decided inside the `cuda` fixture, never at import).  Run them
on the card with
    python -m pytest tests/test_torch_train_cuda.py -q
Tolerances:
  K2 bf16   2e-2 abs + 2e-2 rel: p and ds round to bf16 before their
            products in both versions, but the kernel's fp32 sums run in
            another order, which can flip a rounding (2^-8 relative);
  K2 fp32   1e-4: fp32 throughout, other summation order over T <= 1024;
  K5        lse 1e-4 abs (fp32 logsumexp over 16k-50k columns, other
            order); picked exact (a copy);
  K6        one bf16 ulp of the value (2^-8 relative) + 1e-6 abs: the same
            fp32 formula, expf against torch.exp;
  K7        rtol 2e-6, atol 1e-9: the same fp32 operations in the same
            order; only exp of the bias correction may differ by an ulp.
"""

import numpy as np
import pytest
import torch

from vitrs_tpu_torch.ops import flash_attention as FA
from vitrs_tpu_torch.ops import fused_adamw as FW
from vitrs_tpu_torch.ops import fused_ce as CE

FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _flash_inputs(cuda, dtype, B, T, causal, seed):
    NH, C = 12, 768
    g = torch.Generator(device=cuda).manual_seed(seed)
    qkv = torch.randn(B, T, 3 * C, generator=g, device=cuda).to(dtype)
    out, lse = FA.flash_attention_fwd(qkv, NH, causal)
    do = torch.randn(B, T, C, generator=g, device=cuda).to(dtype)
    return qkv, out, lse, do


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [1, 37, 64, 200, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_matches_plain(cuda, dtype, T, causal):
    NH, C = 12, 768
    qkv, out, lse, do = _flash_inputs(cuda, dtype, 2, T, causal, T)
    q, k, v = qkv.split(C, dim=-1)
    before = FA.flash_bwd_cuda.launches
    got = FA.flash_bwd_cuda(q, k, v, out, lse, do, NH, causal, 0.125)
    want = FA.flash_bwd_plain(q, k, v, out, lse, do, NH, causal, 0.125)
    torch.cuda.synchronize()
    assert FA.flash_bwd_cuda.launches == before + 1
    tol = FLASH_TOL[dtype]
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == (2, T, C)
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol,
                                   msg=name)


@pytest.mark.parametrize("sm_scale", [0.125, 0.1])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [63, 65, 127, 128, 129, 1000])
def test_flash_bwd_ragged_scale_deterministic(cuda, T, causal, sm_scale):
    """bf16 K2 at ragged T around its 64-row tiles, at sm_scale 1/8 (s
    scaled in fp32) and 0.1 (q^ from the pre-pass), against its plain
    version; two calls give the same bits (no atomics)."""
    NH, C = 12, 768
    g = torch.Generator(device=cuda).manual_seed(T + 1)
    qkv = torch.randn(2, T, 3 * C, generator=g, device=cuda).bfloat16()
    do = torch.randn(2, T, C, generator=g, device=cuda).bfloat16()
    q, k, v = qkv.split(C, dim=-1)
    out, lse = FA.flash_fwd_cuda(q, k, v, NH, causal, sm_scale)
    got = FA.flash_bwd_cuda(q, k, v, out, lse, do, NH, causal, sm_scale)
    again = FA.flash_bwd_cuda(q, k, v, out, lse, do, NH, causal, sm_scale)
    want = FA.flash_bwd_plain(q, k, v, out, lse, do, NH, causal, sm_scale)
    torch.cuda.synchronize()
    tol = FLASH_TOL[torch.bfloat16]
    for name, a, b, c in zip(("dq", "dk", "dv"), got, again, want):
        assert torch.equal(a, b), name
        torch.testing.assert_close(a.float(), c.float(), rtol=tol, atol=tol,
                                   msg=name)


def test_flash_autograd_runs_both_kernels(cuda):
    qkv = torch.randn(2, 100, 3 * 768, device=cuda, dtype=torch.bfloat16,
                      requires_grad=True)
    fwd0, bwd0 = FA.flash_fwd_cuda.launches, FA.flash_bwd_cuda.launches
    FA.flash_attention_qkv(qkv, 12).float().square().sum().backward()
    torch.cuda.synchronize()
    assert FA.flash_fwd_cuda.launches == fwd0 + 1
    assert FA.flash_bwd_cuda.launches == bwd0 + 1
    assert qkv.grad.shape == qkv.shape and torch.isfinite(qkv.grad).all()


def test_flash_bwd_refuses_bad_lse(cuda):
    qkv, out, lse, do = _flash_inputs(cuda, torch.bfloat16, 1, 16, True, 0)
    q, k, v = qkv.split(768, dim=-1)
    with pytest.raises(ValueError, match="lse"):
        FA.flash_bwd_cuda(q, k, v, out, lse.transpose(1, 2), do, 12, True,
                          0.125)


def _ce_inputs(cuda, dtype, R, V, seed):
    Vp = CE.pad_vocab(V)
    g = torch.Generator(device=cuda).manual_seed(seed)
    logits = (3 * torch.randn(R, Vp, generator=g, device=cuda)).to(dtype)
    targets = torch.randint(0, V, (R,), generator=g, device=cuda)
    return logits, targets


@pytest.mark.parametrize("R,V", [(1, 16384), (37, 16500), (200, 50257)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ce_kernels_match_plain(cuda, dtype, R, V):
    logits, targets = _ce_inputs(cuda, dtype, R, V, R)
    b_fwd, b_bwd = CE.ce_fwd_cuda.launches, CE.ce_bwd_cuda.launches
    lse, picked = CE.ce_fwd_cuda(logits, targets, V)
    want_lse, want_picked = CE.ce_fwd_plain(logits, targets, V)
    g = torch.full((R,), 1.0 / R, device=cuda)
    d = CE.ce_bwd_cuda(logits, targets, lse, g, V)
    want_d = CE.ce_bwd_plain(logits, targets, lse, g, V)
    torch.cuda.synchronize()
    assert (CE.ce_fwd_cuda.launches, CE.ce_bwd_cuda.launches) == (b_fwd + 1,
                                                                  b_bwd + 1)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-4)
    torch.testing.assert_close(picked, want_picked, rtol=0, atol=0)
    assert d.dtype == dtype and d.shape == logits.shape
    torch.testing.assert_close(d.float(), want_d.float(), rtol=2 ** -8,
                               atol=1e-6)
    assert (d[:, V:] == 0).all(), "pad columns must get exactly 0"


def test_ce_autograd_mean_runs_both_kernels(cuda):
    logits, targets = _ce_inputs(cuda, torch.bfloat16, 64, 16500, 5)
    logits.requires_grad_(True)
    b_fwd, b_bwd = CE.ce_fwd_cuda.launches, CE.ce_bwd_cuda.launches
    loss = CE.cross_entropy_mean(logits, targets, real_vocab=16500)
    loss.backward()
    torch.cuda.synchronize()
    assert (CE.ce_fwd_cuda.launches, CE.ce_bwd_cuda.launches) == (b_fwd + 1,
                                                                  b_bwd + 1)
    want = CE.cross_entropy_mean(logits.detach().cpu().float(), targets.cpu(),
                                 real_vocab=16500)
    assert abs(loss.item() - want.item()) < 1e-4


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 3, 4099, 1 << 20])
def test_adamw_matches_plain(cuda, n, g_dtype):
    rng = np.random.default_rng(n)
    p, g, m = (torch.from_numpy(rng.standard_normal(n).astype(np.float32))
               .to(cuda) for _ in range(3))
    v = torch.from_numpy(rng.random(n).astype(np.float32)).to(cuda)
    g = g.to(g_dtype)
    want = FW.adamw_plain(p.clone(), g, m.clone(), v.clone(), 7, 3e-4,
                          weight_decay=0.1)
    before = FW.adamw_cuda.launches
    got = FW.adamw_cuda(p, g, m, v, 7, 3e-4, weight_decay=0.1)
    torch.cuda.synchronize()
    assert FW.adamw_cuda.launches == before + 1
    assert got[0] is p and got[1] is m and got[2] is v      # in place
    for name, a, b in zip("pmv", got, want):
        torch.testing.assert_close(a, b, rtol=2e-6, atol=1e-9, msg=name)


def test_adamw_unaligned_view_takes_the_scalar_path(cuda):
    base = torch.zeros(4 * 1024 + 1, device=cuda)
    p = base[1:]                              # 4-byte offset: no float4
    g = torch.ones_like(p)
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    # the plain version on the card: at t=1, bc2 = 1 - exp(log 0.999)
    # cancels, so a last-bit difference between two exp implementations
    # (CPU and GPU) would show as 3e-5 relative
    want = FW.adamw_plain(p.clone(), g, m.clone(), v.clone(), 1, 1e-3)
    FW.adamw_cuda(p, g, m, v, 1, 1e-3)
    torch.cuda.synchronize()
    for a, b in zip((p, m, v), want):
        torch.testing.assert_close(a, b, rtol=2e-6, atol=1e-9)


def test_qkv_weight_grad_is_an_fp32_product_on_cuda(cuda):
    """The fused qkv op's weight gradient from bf16 operands on the card
    (cuBLAS, fp32 output) against the CPU's widened fp32 product: within
    1e-5 of the largest value, which a product rounded to bf16 fails."""
    from vitrs_tpu_torch.ops import fused_qkv_attention as Q
    rng = np.random.default_rng(6)
    dq, dk, dv, ln1 = (torch.from_numpy(rng.standard_normal((4, 200, 768))
                                        .astype(np.float32)).to(torch.bfloat16)
                       for _ in range(4))
    w = torch.from_numpy(0.05 * rng.standard_normal((2304, 768))
                         .astype(np.float32)).to(torch.bfloat16)
    want = Q.qkv_projection_bwd(dq, dk, dv, ln1, w)[1]
    got = Q.qkv_projection_bwd(*(t.to(cuda) for t in (dq, dk, dv, ln1, w)))[1]
    assert got.dtype == torch.float32
    scale = want.abs().max().item()
    assert (got.cpu() - want).abs().max().item() <= 1e-5 * scale
    rounded = got.to(torch.bfloat16).float().cpu()
    assert (rounded - want).abs().max().item() > 1e-5 * scale


def test_train_step_on_cuda_matches_cpu(cuda):
    """One `make_dp_train_step` step of a small fp32 model (D=64: flash;
    V=16500 over 128 rows: fused CE) on CUDA with the kernels and on the
    CPU with the plain versions.  loss rtol 1e-5; params rtol 2e-5 + atol
    1e-6, or atol lr where |grad| < 1e-6 (AdamW from zero state magnifies
    fp32 noise there, e.g. the K third of qkvb)."""
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.models import model as M
    from vitrs_tpu_torch.parallel import data_parallel as dp
    cfg = get_config("gpt-nano").replace(num_layers=2, num_heads=2,
                                         channels=128, max_seq_len=64,
                                         vocab_size=16500)
    params = P.init_params(cfg, torch.Generator().manual_seed(4))
    rng = np.random.default_rng(4)
    x = rng.integers(0, cfg.vocab_size, (2, 64))
    y = rng.integers(0, cfg.vocab_size, (2, 64))
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    M.loss_fn(leaves, torch.as_tensor(x), torch.as_tensor(y), cfg).backward()
    out = {}
    for dev in (cuda, torch.device("cpu")):
        before = (FA.flash_bwd_cuda.launches, CE.ce_bwd_cuda.launches,
                  FW.adamw_cuda.launches)
        mesh = dp.make_mesh(devices=[dev])
        m, v = dp.init_sharded_opt_state(cfg, mesh)
        step = dp.make_dp_train_step(cfg, mesh)
        flat = P.flatten_params(params, cfg).to(dev)
        new, _, _, loss = step(P.unflatten_params(flat, cfg), m, v, x, y, 1,
                               1e-3, 0.1)
        after = (FA.flash_bwd_cuda.launches, CE.ce_bwd_cuda.launches,
                 FW.adamw_cuda.launches)
        ran = tuple(a - b for a, b in zip(after, before))
        assert ran == ((cfg.num_layers, 1, 1) if dev.type == "cuda"
                       else (0, 0, 0))
        out[dev.type] = loss.item(), {k: t.detach().cpu() for k, t in new.items()}
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * abs(out["cpu"][0])
    for k, want in out["cpu"][1].items():
        tol = torch.where(leaves[k].grad.abs() < 1e-6,
                          torch.full_like(want, 1e-3), 1e-6 + 2e-5 * want.abs())
        assert bool(((out["cuda"][1][k] - want).abs() <= tol).all()), k


class _Slow:
    """A loader of large numbered batches (each value its batch number)."""

    def __init__(self, shape=(64, 224, 224, 3)):
        self.i, self.shape = 0, shape

    def next_batch(self):
        x = np.full(self.shape, self.i % 251, np.uint8)
        y = np.full((self.shape[0],), self.i, np.int64)
        self.i += 1
        return x, y


def test_prefetcher_batches_land_before_the_step_reads_them(cuda):
    """Keep the step's stream busy (a long matmul chain) while the
    prefetcher copies on its side stream: every batch the step reads is
    whole, in order, and the pinned buffers are reused only after their
    copies (6 slots' worth of batches come through intact)."""
    from vitrs_tpu_torch.data.prefetch import DevicePrefetcher
    pf = DevicePrefetcher(_Slow(), cuda, depth=2)
    a = torch.randn(4096, 4096, device=cuda)
    try:
        for i in range(12):
            x, y = next(pf)
            assert x.device.type == "cuda" and x.dtype == torch.uint8
            for _ in range(4):          # the step's stream stays busy
                a = (a @ a).clamp_(-1, 1)
            # reads on the current stream, ordered after the copy's event
            assert int(x.min()) == int(x.max()) == i % 251
            assert int(y[0]) == i and int(y[-1]) == i
            del x, y                     # record_stream keeps them alive
    finally:
        pf.close()


def test_async_snapshot_holds_under_an_in_place_adamw(cuda, tmp_path):
    """save() then K7 updating the masters, m and v in place at once, many
    times: the file holds the values of save() time (the device copy is
    queued before the next K7 on the same stream)."""
    from vitrs_tpu_torch import checkpoint as C
    from vitrs_tpu_torch import params as P
    from vitrs_tpu_torch.checkpoint_async import AsyncCheckpointer
    from vitrs_tpu_torch.config import get_config
    cfg = get_config("gpt2-124m")
    n = P.num_parameters(cfg)
    g = torch.Generator(device=cuda).manual_seed(0)
    flat = torch.randn(n, generator=g, device=cuda) * 0.02
    m = torch.randn(n, generator=g, device=cuda) * 1e-3
    v = torch.rand(n, generator=g, device=cuda) * 1e-6
    grad = torch.randn(n, generator=g, device=cuda)
    params = P.unflatten_params(flat, cfg)
    want = flat.cpu(), m.cpu(), v.cpu()
    ck = AsyncCheckpointer()
    path = str(tmp_path / "snap.bin")
    ck.save(path, params, cfg, m=m, v=v, step=3, n_valid=n)
    before = FW.adamw_cuda.launches
    for step in range(4, 24):
        FW.adamw_cuda(flat, grad, m, v, step, 1e-2)
    assert FW.adamw_cuda.launches - before == 20
    ck.close()
    got, _, extras = C.load_checkpoint(path)
    np.testing.assert_array_equal(
        P.flatten_params(P.from_numpy(got, cfg, "cpu"), cfg).numpy(),
        want[0].numpy())
    np.testing.assert_array_equal(extras["m"], want[1].numpy())
    np.testing.assert_array_equal(extras["v"], want[2].numpy())
    assert not torch.equal(flat.cpu(), want[0])
