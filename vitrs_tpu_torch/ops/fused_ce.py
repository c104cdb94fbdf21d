"""K5 and K6: fused large-vocab cross-entropy, forward and backward.

The port of `vitrs_tpu/ops/fused_ce.py`.  The GPT loss pads the tied head
to a multiple of 128 columns (50257 -> 50304) and takes per-row
    loss = logsumexp(logits[:real_vocab]) - logits[target]
in fp32.  Its Pallas forward (`_ce_fwd`, K5) becomes the CUDA kernel
`vitrs_ce_fwd` and its Pallas backward (`_ce_bwd_dlogits`, K6) the kernel
`vitrs_ce_bwd`, both in `csrc/fused_ce.cu`.  The JAX package leaves K6 off
(`PALLAS_BWD = False`) because XLA fuses its jnp backward into the head
matmuls; eager PyTorch has no such fusion, so the port's backward is K6.

* A CUDA tensor goes to the kernels, or the wrappers raise; a CPU tensor
  goes to `ce_fwd_plain` / `ce_bwd_plain`, the same functions in plain
  PyTorch.
* `ce_fwd_cuda.launches` and `ce_bwd_cuda.launches` count launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build, basic

LANES = 128
BLOCK_R = 32            # the JAX kernel's row block; kept in `supports`
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def pad_vocab(v: int) -> int:
    """Next multiple of 128 (50257 -> 50304, llm.c's pad)."""
    return -(-v // LANES) * LANES


def supports(n_rows: int, vocab: int) -> bool:
    """The JAX package's routing rule (fused_ce.py:62), kept so that both
    packages take the fused route for the same shapes: a big, 128-aligned
    vocab and a row count that fills the JAX kernel's row blocks."""
    return vocab >= 16384 and vocab % LANES == 0 and n_rows % BLOCK_R == 0


# ---------------------------------------------------------------- plain

def _real_cols(logits: torch.Tensor, real_vocab: int) -> torch.Tensor:
    return torch.arange(logits.shape[-1], device=logits.device) < real_vocab


def ce_fwd_plain(logits: torch.Tensor, targets: torch.Tensor,
                 real_vocab: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's function: logits (R, Vp), targets (R,) -> (lse, picked), each
    (R,) fp32; columns >= real_vocab are left out of the logsumexp."""
    lf = logits.float()
    lse = torch.logsumexp(lf.masked_fill(~_real_cols(logits, real_vocab),
                                         -torch.inf), dim=-1)
    picked = lf.gather(-1, targets.long()[:, None])[:, 0]
    return lse, picked


def ce_bwd_plain(logits: torch.Tensor, targets: torch.Tensor,
                 lse: torch.Tensor, g: torch.Tensor,
                 real_vocab: int) -> torch.Tensor:
    """K6's function: dlogits = (softmax masked to real_vocab - onehot) * g,
    in the logits' dtype; g (R,) is the per-row upstream gradient."""
    lf = logits.float()
    p = torch.exp(lf - lse[:, None]) * _real_cols(logits, real_vocab)
    cols = torch.arange(logits.shape[-1], device=logits.device)
    onehot = (cols[None, :] == targets.long()[:, None]).float()
    return ((p - onehot) * g.float()[:, None]).to(logits.dtype)


# ---------------------------------------------------------------- CUDA

@functools.cache
def _kernels():
    lib = _build.load("fused_ce").lib
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fwd, bwd = lib.vitrs_ce_fwd, lib.vitrs_ce_bwd
    fwd.argtypes = [I, P, LL, P, I, I, I, P, P, P]
    bwd.argtypes = [I, P, P, LL, P, P, P, I, I, I, P]
    fwd.restype = bwd.restype = I
    return fwd, bwd


def _check(logits: torch.Tensor, targets: torch.Tensor, real_vocab: int):
    if logits.device.type != "cuda" or targets.device != logits.device:
        raise ValueError("fused CE: logits and targets must be on one CUDA "
                         "device")
    if logits.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused CE takes float32 or bfloat16 logits, got "
                        f"{logits.dtype}")
    if logits.dim() != 2 or targets.shape != logits.shape[:1]:
        raise ValueError(f"fused CE: logits (R, Vp) and targets (R,), got "
                         f"{tuple(logits.shape)} and {tuple(targets.shape)}")
    vec = 16 // logits.element_size()
    R, Vp = logits.shape
    if (logits.stride(1) != 1 or logits.stride(0) % vec or Vp % vec
            or logits.data_ptr() % 16):
        raise ValueError(f"fused CE: unsupported layout {tuple(logits.shape)}"
                         f" strides {logits.stride()}: rows must be 16-byte "
                         f"multiples, the last dim contiguous")
    if not 0 < real_vocab <= Vp:
        raise ValueError(f"fused CE: real_vocab {real_vocab} not in (0, {Vp}]")


def ce_fwd_cuda(logits: torch.Tensor, targets: torch.Tensor,
                real_vocab: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K5 on the current stream; same contract as `ce_fwd_plain`.
    A target outside [0, real_vocab) gives a NaN pick."""
    _check(logits, targets, real_vocab)
    R, Vp = logits.shape
    tgt = targets.to(torch.int64).contiguous()
    lse = torch.empty(R, dtype=torch.float32, device=logits.device)
    picked = torch.empty_like(lse)
    with torch.cuda.device(logits.device):
        rc = _kernels()[0](
            _DTYPE_CODE[logits.dtype], logits.data_ptr(), logits.stride(0),
            tgt.data_ptr(), R, real_vocab, Vp, lse.data_ptr(),
            picked.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ce_fwd kernel launch failed: CUDA error {rc}")
    ce_fwd_cuda.launches += 1
    return lse, picked


ce_fwd_cuda.launches = 0


def ce_bwd_cuda(logits: torch.Tensor, targets: torch.Tensor,
                lse: torch.Tensor, g: torch.Tensor,
                real_vocab: int) -> torch.Tensor:
    """Launch K6 on the current stream; same contract as `ce_bwd_plain`.
    dlogits is a new contiguous (R, Vp) tensor in the logits' dtype."""
    _check(logits, targets, real_vocab)
    R, Vp = logits.shape
    tgt = targets.to(torch.int64).contiguous()
    lse = lse.to(torch.float32).contiguous()
    g = g.to(torch.float32).expand(R).contiguous()
    if lse.shape != (R,) or lse.device != logits.device or g.device != lse.device:
        raise ValueError("fused CE: lse and g must be (R,) on the logits' device")
    dlogits = torch.empty((R, Vp), dtype=logits.dtype, device=logits.device)
    with torch.cuda.device(logits.device):
        rc = _kernels()[1](
            _DTYPE_CODE[logits.dtype], logits.data_ptr(), dlogits.data_ptr(),
            logits.stride(0), tgt.data_ptr(), lse.data_ptr(), g.data_ptr(), R,
            real_vocab, Vp, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ce_bwd kernel launch failed: CUDA error {rc}")
    ce_bwd_cuda.launches += 1
    return dlogits


ce_bwd_cuda.launches = 0


# ---------------------------------------------------------------- public

# (lse, picked): K5 on a CUDA tensor, its plain version on a CPU one
ce_fwd = _build.kernel_op(
    "ce_fwd", "(Tensor logits, Tensor targets, int real_vocab) -> "
    "(Tensor, Tensor)", lambda *a: ce_fwd_plain(*a),
    lambda *a: ce_fwd_cuda(*a),
    lambda logits, targets, real_vocab: tuple(
        logits.new_empty(logits.shape[:1], dtype=torch.float32)
        for _ in range(2)))

# dlogits: K6 on a CUDA tensor, its plain version on a CPU one
ce_bwd = _build.kernel_op(
    "ce_bwd", "(Tensor logits, Tensor targets, Tensor lse, Tensor g, "
    "int real_vocab) -> Tensor", lambda *a: ce_bwd_plain(*a),
    lambda *a: ce_bwd_cuda(*a),
    lambda logits, *args: logits.new_empty(logits.shape))


class _CrossEntropyRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, real_vocab):
        lse, picked = ce_fwd(logits, targets, real_vocab)
        ctx.save_for_backward(logits, targets, lse)
        ctx.real_vocab = real_vocab
        return lse - picked

    @staticmethod
    def backward(ctx, g):
        logits, targets, lse = ctx.saved_tensors
        return ce_bwd(logits, targets, lse, g, ctx.real_vocab), None, None


def cross_entropy_rows(logits: torch.Tensor, targets: torch.Tensor,
                       real_vocab: int) -> torch.Tensor:
    """Per-row -log softmax(logits[:real_vocab])[target], fp32 (R,).
    logits (R, Vp), columns >= real_vocab are pad; targets (R,) int in
    [0, real_vocab).  Differentiable with respect to logits."""
    return _CrossEntropyRows.apply(logits, targets, real_vocab)


def cross_entropy_mean(logits: torch.Tensor, targets: torch.Tensor,
                       real_vocab: Optional[int] = None) -> torch.Tensor:
    """Mean-over-rows fused CE; logits (..., Vp).  Shapes `supports` does
    not take go to the dense form on the first real_vocab columns, as in
    the JAX package."""
    Vp = logits.shape[-1]
    rv = Vp if real_vocab is None else real_vocab
    flat = logits.reshape(-1, Vp)
    t = targets.reshape(-1)
    if not supports(flat.shape[0], Vp):
        return basic.cross_entropy_from_logits(flat[:, :rv], t).mean()
    return cross_entropy_rows(flat, t, rv).mean()
