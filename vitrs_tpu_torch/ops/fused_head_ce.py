"""K8: the GPT head matmul with the cross-entropy statistics in its
epilogue — the port of `vitrs_tpu/ops/fused_head_ce.py`.

    logits = lnf @ wte_p.T       (R, Vp), fp32 accumulation, stored in
                                 lnf's dtype
    loss   = mean(logsumexp(logits[:, :V]) - logits[target])

with the logsumexp and the target logit taken from the fp32 product, not
from the rounded logits (so in bf16 this loss differs slightly from the
two-op path's, whose K5 reads the rounded logits).  The Pallas forward
(`_head_ce_fwd`, kernel `_kernel`) becomes `csrc/fused_head_ce.cu`; its
schedule is the port's own (bf16: a persistent warp-specialised wgmma GEMM
over (row, vocab) tiles fed by TMA, the CE statistics in its epilogue,
then a small merge launch; the source says why).  The backward is, as in
the JAX package, outside the kernel: dlogits = (softmax - onehot) * g / R
from the saved logits and lse (K6, ops/fused_ce.ce_bwd), then dX =
dlogits . wte_p and dW = dlogits^T . X as matmuls.  The logits are still
written once: the backward reads them.

* `ENABLE = False` mirrors the JAX switch (fused_head_ce.py:55): with it
  set, models/model.gpt_loss routes here where `supports` takes the shape,
  as the JAX package does.  There is no CLI flag, as in the JAX package.
* A CUDA tensor goes to the kernel (`head_ce_fwd_cuda`, which counts its
  `launches`; one launch runs the tile kernel and the merge), or the
  wrapper raises; a CPU tensor to `head_ce_fwd_plain`.  The bf16 kernel
  reads x and w in place by TMA, so a view `tma_mappable` refuses raises
  before any launch; the fp32 instance takes contiguous copies.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build, fused_ce

ENABLE = False        # the JAX package's default; see the module docstring
BLOCK_C = 32          # channels must be a multiple (the fp32 instance's k
                      # chunk; the bf16 TMA maps zero-fill a half k step)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VOCAB_TILE = 128     # the padded vocab must be a multiple (fp32 tiles: 64;
                      # the bf16 tile's ragged last columns are clipped)


def supports(n_rows: int, vocab_padded: int, channels: int) -> bool:
    """Whether K8 takes the shape: a vocab padded to a multiple of 128 and
    channels a multiple of 32.  The row count is free (the kernel masks a
    ragged last row tile); the JAX gate's R % 2048 is its TPU panel, not
    carried over."""
    return (n_rows > 0 and vocab_padded % _VOCAB_TILE == 0
            and channels % BLOCK_C == 0)


def tma_mappable(t: torch.Tensor) -> bool:
    """Whether a 2-D tensor or view is one the bf16 kernel's tensor maps
    (csrc/fused_head_ce.cu `map_2d`) can describe: rows contiguous, the
    base address and the row stride 16-byte multiples, and rows that do not
    overlap.  `gpt_loss` passes contiguous tensors (lnf reshaped to (R, C),
    the padded head), which qualify; a view cut at an odd offset, out of a
    row of odd width, or broadcast along the rows does not."""
    es = t.element_size()
    return (t.dim() == 2 and t.stride(1) == 1 and t.data_ptr() % 16 == 0
            and t.stride(0) * es % 16 == 0 and t.stride(0) >= t.shape[1])


def head_ce_fwd_plain(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                      real_vocab: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K8's function in plain PyTorch: x (R, C), w (Vp, C), targets (R,) ->
    (logits (R, Vp) in x's dtype, lse (R,) fp32, picked (R,) fp32), lse and
    picked from the fp32 product with columns >= real_vocab left out.  A
    bf16 product is exact in fp32, so widening first keeps the kernel's
    arithmetic."""
    tile = torch.matmul(x.float(), w.float().t())
    cols = torch.arange(w.shape[0], device=x.device)
    lse = torch.logsumexp(tile.masked_fill(cols >= real_vocab, -torch.inf),
                          dim=-1)
    picked = tile.gather(-1, targets.long()[:, None])[:, 0]
    return tile.to(x.dtype), lse, picked


@functools.cache
def _kernel():
    lib = _build.load("fused_head_ce").lib
    fn = lib.vitrs_head_ce_fwd
    P, I = ctypes.c_void_p, ctypes.c_int
    LL = ctypes.c_longlong
    fn.argtypes = [I, P, P, P, I, I, I, I, LL, LL, P, P, P, P, P, P]
    fn.restype = I
    lib.vitrs_head_ce_tile.argtypes = [I]
    lib.vitrs_head_ce_tile.restype = I
    return fn, lib.vitrs_head_ce_tile


def head_ce_fwd_cuda(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                     real_vocab: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K8 on the current stream (the tile kernel and the merge; one
    count): the contract of `head_ce_fwd_plain`.  A target outside
    [0, real_vocab) gives a NaN pick.  Raises on anything the kernel does
    not take (bf16: x or w a view `tma_mappable` refuses), before any
    launch, and if a launch is refused."""
    if (x.device.type != "cuda" or w.device != x.device
            or targets.device != x.device):
        raise ValueError("head_ce_fwd_cuda: x, w and targets must be on one "
                         "CUDA device")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"head_ce_fwd_cuda takes float32 or bfloat16 x and "
                        f"w of one dtype, got {x.dtype}, {w.dtype}")
    if (x.dim() != 2 or w.dim() != 2 or w.shape[1] != x.shape[1]
            or targets.shape != x.shape[:1]):
        raise ValueError(f"head_ce_fwd_cuda: x (R, C), w (Vp, C), targets "
                         f"(R,), got {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(targets.shape)}")
    R, C = x.shape
    Vp = w.shape[0]
    if not supports(R, Vp, C) or not 0 < real_vocab <= Vp:
        raise ValueError(f"head_ce_fwd_cuda: R={R} > 0, C={C} a multiple "
                         f"of {BLOCK_C}, Vp={Vp} of {_VOCAB_TILE}, and "
                         f"real_vocab {real_vocab} in (0, Vp]")
    if x.dtype == torch.float32:
        x, w = x.contiguous(), w.contiguous()
        x_ld = w_ld = C        # rows back to back (a 1-row view may not say so)
    elif tma_mappable(x) and tma_mappable(w):
        x_ld, w_ld = x.stride(0), w.stride(0)
    else:
        raise ValueError(f"head_ce_fwd_cuda: TMA cannot map x (strides "
                         f"{x.stride()}) or w (strides {w.stride()}): rows "
                         f"contiguous, base and row stride 16-byte multiples")
    fn, tile_of = _kernel()
    tile = tile_of(_DTYPE_CODE[x.dtype])
    tgt = targets.to(torch.int64).contiguous()
    logits = torch.empty((R, Vp), dtype=x.dtype, device=x.device)
    part = torch.empty((2, R, -(-Vp // tile)), dtype=torch.float32,
                       device=x.device)
    lse = torch.empty(R, dtype=torch.float32, device=x.device)
    picked = torch.empty_like(lse)
    with torch.cuda.device(x.device):
        rc = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(),
                tgt.data_ptr(), R, C, Vp, real_vocab, x_ld, w_ld,
                logits.data_ptr(), part[0].data_ptr(),
                part[1].data_ptr(), lse.data_ptr(), picked.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"head_ce_fwd kernel launch failed: CUDA error {rc}")
    head_ce_fwd_cuda.launches += 1
    return logits, lse, picked


head_ce_fwd_cuda.launches = 0


def _head_ce_fake(x, w, targets, real_vocab):
    R = x.shape[0]
    return (x.new_empty((R, w.shape[0])),
            *(x.new_empty((R,), dtype=torch.float32) for _ in range(2)))


# (logits, lse, picked): K8 on a CUDA tensor, its plain version on a CPU one
head_ce_fwd = _build.kernel_op(
    "head_ce_fwd", "(Tensor x, Tensor w, Tensor targets, int real_vocab) -> "
    "(Tensor, Tensor, Tensor)", lambda *a: head_ce_fwd_plain(*a),
    lambda *a: head_ce_fwd_cuda(*a),
    _head_ce_fake)


class _HeadCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lnf, wte_p, targets, real_vocab):
        C = lnf.shape[-1]
        x2 = lnf.reshape(-1, C)
        t = targets.reshape(-1)
        logits, lse, picked = head_ce_fwd(x2, wte_p, t, real_vocab)
        ctx.save_for_backward(x2, wte_p, t, logits, lse)
        ctx.real_vocab = real_vocab
        ctx.lnf_shape = lnf.shape
        return (lse - picked).mean()

    @staticmethod
    def backward(ctx, g):
        x2, wte_p, t, logits, lse = ctx.saved_tensors
        R = logits.shape[0]
        # (softmax - onehot) * g / R per row in the logits' dtype (K6), then
        # the two products with fp32 accumulation, as the JAX _bwd
        gr = (g.float() / R).expand(R)
        dlogits = fused_ce.ce_bwd(logits, t, lse, gr, ctx.real_vocab)
        dx = torch.matmul(dlogits, wte_p.to(dlogits.dtype)).to(x2.dtype)
        dw = torch.matmul(dlogits.t(), x2.to(dlogits.dtype)).to(wte_p.dtype)
        return dx.reshape(ctx.lnf_shape), dw, None, None


def head_ce_mean(lnf: torch.Tensor, wte_p: torch.Tensor,
                 targets: torch.Tensor, real_vocab: int) -> torch.Tensor:
    """Mean CE of softmax(lnf @ wte_p.T) against targets, the head product
    and the CE statistics in one op; differentiable in lnf and wte_p.
    lnf (B, T, C) or (R, C); wte_p (Vp, C) padded with zero rows past
    real_vocab; targets (B, T) or (R,) int."""
    return _HeadCE.apply(lnf, wte_p, targets, real_vocab)
