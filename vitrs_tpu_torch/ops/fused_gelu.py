"""GELU forward and backward in one pass each, tanh and exact forms: the
CUDA side of the ops `vitrs::gelu_fwd` (x, erf) -> y and `vitrs::gelu_bwd`
(x, dy, erf) -> dx, which `ops/basic.py` registers beside their plain
versions (`basic.gelu_fwd_plain` / `gelu_bwd_plain`, its eager chain).

The kernels `vitrs_gelu_fwd` / `vitrs_gelu_bwd` in `csrc/gelu.cu` replace no
Pallas kernel: the JAX package's `gelu_cv` / `gelu_erf_cv` are plain jnp,
which XLA fuses into one pass on the TPU, while eager PyTorch runs each of
their operations as a kernel of its own (about 9 passes over the
activation in the tanh forward, 20 in either backward).  The kernels
compute the same function as the eager chain, step for step and rounding
for rounding, reading each input and writing each output once.

* `gelu_fwd_cuda` / `gelu_bwd_cuda` raise ValueError on a tensor the
  kernels do not take (no fallback to the eager chain on the card).
* `gelu_fwd_cuda.launches` and `gelu_bwd_cuda.launches` count launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _kernels():
    lib = _build.load("gelu").lib
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fwd, bwd = lib.vitrs_gelu_fwd, lib.vitrs_gelu_bwd
    fwd.argtypes = [P, P, LL, I, I, P]
    bwd.argtypes = [P, P, P, LL, I, I, P]
    fwd.restype = bwd.restype = I
    return fwd, bwd


def _check(what: str, *ts: torch.Tensor):
    """Raise ValueError unless every tensor is a contiguous, 16-byte aligned
    float32 or bfloat16 CUDA tensor of the first one's shape, dtype and
    device."""
    x = ts[0]
    for t in ts:
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{what}: tensors must be on one CUDA device")
        if t.dtype not in _DTYPE_CODE or t.dtype != x.dtype:
            raise ValueError(f"{what} takes float32 or bfloat16 tensors of "
                             f"one dtype, got {[u.dtype for u in ts]}")
        if t.shape != x.shape or not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous and of "
                             f"one shape")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: tensors must be 16-byte aligned")


def gelu_fwd_cuda(x: torch.Tensor, erf: bool) -> torch.Tensor:
    """Launch `vitrs_gelu_fwd` on the current stream; returns y."""
    _check("gelu_fwd_cuda", x)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel():
        with torch.cuda.device(x.device):
            rc = _kernels()[0](x.data_ptr(), y.data_ptr(), x.numel(),
                               _DTYPE_CODE[x.dtype], int(erf),
                               torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"gelu_fwd kernel launch failed: CUDA error "
                               f"{rc}")
        gelu_fwd_cuda.launches += 1
    return y


gelu_fwd_cuda.launches = 0


def gelu_bwd_cuda(x: torch.Tensor, dy: torch.Tensor,
                  erf: bool) -> torch.Tensor:
    """Launch `vitrs_gelu_bwd` on the current stream; returns dx."""
    _check("gelu_bwd_cuda", x, dy)
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel():
        with torch.cuda.device(x.device):
            rc = _kernels()[1](x.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                               x.numel(), _DTYPE_CODE[x.dtype], int(erf),
                               torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"gelu_bwd kernel launch failed: CUDA error "
                               f"{rc}")
        gelu_bwd_cuda.launches += 1
    return dx


gelu_bwd_cuda.launches = 0

