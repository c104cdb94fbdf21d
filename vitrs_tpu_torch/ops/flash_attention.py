"""K1-fwd: flash-attention forward over packed qkv (B, T, 3C).

The port of the forward of `vitrs_tpu/ops/flash_attention.py`
(`flash_attention_qkv`, whose Pallas drivers `_fwd_single` and `_fwd` run
`_fwd_single_kernel` and `_fwd_kernel`).  One hand-written CUDA kernel,
`csrc/flash_fwd.cu`, replaces both; its source says how.

* A CUDA tensor goes to the kernel, or the wrapper raises: there is no
  fallback.  A CPU tensor goes to `flash_fwd_plain`, the same function in
  plain PyTorch, which the CPU tests hold against the JAX kernels and the
  card's checks hold the kernel against.
* lse comes back compact at (B, NH, T) fp32.
* `flash_fwd_cuda.launches` counts kernel launches, so that a run can show
  that its attention went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import _build

HEAD_DIM = 64       # the kernel's head_dim: D of every GPT-2 preset
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    num_heads: int, causal: bool, sm_scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: q (B, Tq, C), k/v (B, Tk, C)
    -> (out (B, Tq, C) in q's dtype, lse (B, NH, Tq) fp32).

    Same numerics as the Pallas and CUDA kernels: q scaled by sm_scale and
    rounded to its dtype, scores and softmax statistics in fp32, p rounded
    to v's dtype for P.V with an fp32 accumulator, out = acc / l."""
    B, Tq, C = q.shape
    Tk = k.shape[1]
    D = C // num_heads

    def heads(t):
        return t.reshape(B, t.shape[1], num_heads, D).transpose(1, 2)

    qs = (heads(q).float() * sm_scale).to(q.dtype).float()
    s = torch.matmul(qs, heads(k).float().transpose(-1, -2))
    if causal:
        rows = torch.arange(Tq, device=q.device)[:, None]
        cols = torch.arange(Tk, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    # a row that sees no key keeps a finite reference, so p = 0, not NaN
    ref = torch.where(m == -math.inf, torch.zeros_like(m), m)
    p = torch.exp(s - ref)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.matmul(p.to(v.dtype).float(), heads(v).float())
    inv = torch.where(l > 0, 1.0 / l, torch.zeros_like(l))
    out = (pv * inv).to(q.dtype).transpose(1, 2).reshape(B, Tq, C)
    lse = torch.where(l > 0, ref + torch.log(l),
                      torch.full_like(l, -math.inf))[..., 0]
    return out, lse


@functools.cache
def _kernel():
    fn = _build.load("flash_fwd").lib.vitrs_flash_fwd
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [I, P, P, P, P, P, LL, LL, LL, LL, LL, LL, LL, LL,
                   I, I, I, I, I, I, ctypes.c_float, P]
    fn.restype = I
    return fn


def _check(q, k, v, num_heads):
    ts = (q, k, v)
    if any(t.device.type != "cuda" or t.device != q.device for t in ts):
        raise ValueError("flash_fwd_cuda: q, k, v must be on one CUDA device")
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"flash_fwd_cuda takes float32 or bfloat16, got "
                        f"{[t.dtype for t in ts]}")
    if q.dim() != 3 or any(t.shape != q.shape for t in ts):
        raise ValueError(f"flash_fwd_cuda: q, k, v must share one (B, T, C) "
                         f"shape, got {[tuple(t.shape) for t in ts]}")
    if q.shape[2] != num_heads * HEAD_DIM:
        raise ValueError(f"flash_fwd_cuda takes head_dim {HEAD_DIM}, got C="
                         f"{q.shape[2]} with {num_heads} heads")
    for t in ts:
        # inner dim contiguous; rows and the base 16-byte aligned for the
        # kernel's vector loads
        if (t.stride(2) != 1 or t.stride(1) % 8 or t.stride(0) % 8
                or t.data_ptr() % 16):
            raise ValueError(f"flash_fwd_cuda: unsupported layout, strides "
                             f"{t.stride()}")


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   num_heads: int, causal: bool, sm_scale: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1-fwd on q's current stream; same contract as
    `flash_fwd_plain` with Tq == Tk.  q/k/v may be strided views into one
    packed buffer (the last dim must be contiguous).  Raises on anything the
    kernel does not take, and if the launch is refused."""
    _check(q, k, v, num_heads)
    B, T, C = q.shape
    out = torch.empty((B, T, C), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, num_heads, T), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(),
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), out.stride(0), out.stride(1),
            B, num_heads, T, T, 0, int(causal), float(sm_scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {rc}")
    flash_fwd_cuda.launches += 1
    return out, lse


flash_fwd_cuda.launches = 0


def flash_attention_fwd(qkv: torch.Tensor, num_heads: int,
                        causal: bool = True, sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed qkv (B, T, 3C) -> (out (B, T, C), lse (B, NH, T) fp32).
    q, k and v are views into qkv: the kernel reads them in place."""
    B, T, C3 = qkv.shape
    C = C3 // 3
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(C // num_heads)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    if qkv.device.type == "cuda":
        return flash_fwd_cuda(q, k, v, num_heads, causal, sm_scale)
    if qkv.device.type == "cpu":
        return flash_fwd_plain(q, k, v, num_heads, causal, sm_scale)
    raise ValueError(f"flash attention: no path for device {qkv.device}")


def flash_attention_qkv(qkv: torch.Tensor, num_heads: int,
                        causal: bool = True,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention over packed qkv (B, T, 3C) -> (B, T, C)."""
    return flash_attention_fwd(qkv, num_heads, causal, sm_scale)[0]
