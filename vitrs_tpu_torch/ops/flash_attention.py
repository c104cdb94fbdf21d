"""K1-fwd and K2: flash attention over packed qkv (B, T, 3C), forward and
backward.

The port of `vitrs_tpu/ops/flash_attention.py`.  Its Pallas forwards
(`_fwd_single` and `_fwd`, running `_fwd_single_kernel` and `_fwd_kernel`)
become one hand-written CUDA kernel, `csrc/flash_fwd.cu` (K1-fwd); its
Pallas backwards (`_bwd_single` and `_bwd_parts`, running
`_bwd_single_kernel`, `_bwd_combined_kernel`, `_bwd_dkv_kernel` and
`_bwd_dq_kernel`) become `csrc/flash_bwd.cu` (K2).  Each source says how.

* A CUDA tensor goes to the kernel, or the wrapper raises: there is no
  fallback.  A CPU tensor goes to `flash_fwd_plain` / `flash_bwd_plain`,
  the same functions in plain PyTorch, which the CPU tests hold against the
  JAX kernels and the card's checks hold the kernels against.
* lse comes back compact at (B, NH, T) fp32, and the backward reads it so.
* `flash_attention_qkv` is differentiable: an autograd.Function saves
  (qkv, out, lse) as the JAX package's `_flash_packed_fwd` does, and its
  backward returns the packed dqkv.
* `flash_fwd_cuda.launches` and `flash_bwd_cuda.launches` count the
  wrappers' calls into the library, so that a run can show that its
  attention went through the kernels.  A K1-fwd call launches one kernel;
  a K2 call launches three (di, dK/dV, dQ) and counts once.
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
    fn = _build.on_device(qkv.device, flash_fwd_cuda, flash_fwd_plain,
                          "flash attention")
    return fn(q, k, v, num_heads, causal, sm_scale)


def flash_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                    num_heads: int, causal: bool, sm_scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's function in plain PyTorch: q, k, v, out, do (B, T, C), lse
    (B, NH, T) fp32 -> (dq, dk, dv), each (B, T, C) in q's dtype.

    The numerics of the multi-tile Pallas backward bodies (`_bwd_body`):
    q^ = q * sm_scale rounded to its dtype, s = q^ . k^T in fp32,
    p = exp(s - lse) (0 where masked), di = rowsum(out * do) in fp32,
    ds = p * (do . v^T - di) * sm_scale; dv = p^T . do, dk = ds^T . q with
    the unscaled q, dq = ds . k, with p and ds rounded to the input dtype
    before their products and fp32 accumulation."""
    B, T, C = q.shape
    D = C // num_heads
    dtype = q.dtype

    def heads(t):
        return t.reshape(B, T, num_heads, D).transpose(1, 2).float()

    qf, kf, vf, dof = heads(q), heads(k), heads(v), heads(do)
    qh = (qf * sm_scale).to(dtype).float()
    s = torch.matmul(qh, kf.transpose(-1, -2))
    rows = torch.arange(T, device=q.device)[:, None]
    cols = torch.arange(T, device=q.device)[None, :]
    seen = (cols <= rows) if causal else torch.ones_like(rows == cols)
    p = torch.where(seen, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    di = (heads(out) * dof).sum(dim=-1, keepdim=True)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - di) * sm_scale
    pr, dsr = p.to(dtype).float(), ds.to(dtype).float()
    dv = torch.matmul(pr.transpose(-1, -2), dof)
    dk = torch.matmul(dsr.transpose(-1, -2), qf)
    dq = torch.matmul(dsr, kf)

    def packed(t):
        return t.to(dtype).transpose(1, 2).reshape(B, T, C)

    return packed(dq), packed(dk), packed(dv)


@functools.cache
def _bwd_kernel():
    fn = _build.load("flash_bwd").lib.vitrs_flash_bwd
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [I] + [P] * 10 + [LL] * 12 + [I, I, I, I, ctypes.c_float, P]
    fn.restype = I
    return fn


def flash_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                   num_heads: int, causal: bool, sm_scale: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K2 (three kernels: di, dK/dV, dQ; `launches` counts the call
    once) on q's current stream; same contract as `flash_bwd_plain`.
    q/k/v may be strided views into the packed qkv, out and do strided
    (B, T, C) tensors (last dim contiguous).  Raises on anything the kernel
    does not take, and if a launch is refused."""
    _check(q, k, v, num_heads)
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash_bwd_cuda: out {tuple(out.shape)} and do "
                         f"{tuple(do.shape)} must have q's shape "
                         f"{tuple(q.shape)}")
    for t in (out, do):
        if t.device != q.device or t.dtype != q.dtype:
            raise TypeError("flash_bwd_cuda: out and do must share q's device "
                            "and dtype")
        if (t.stride(2) != 1 or t.stride(1) % 8 or t.stride(0) % 8
                or t.data_ptr() % 16):
            raise ValueError(f"flash_bwd_cuda: unsupported layout, strides "
                             f"{t.stride()}")
    B, T, C = q.shape
    if (lse.shape != (B, num_heads, T) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"flash_bwd_cuda: lse must be a contiguous fp32 "
                         f"({B}, {num_heads}, {T}) tensor on q's device")
    dq, dk, dv = (torch.empty((B, T, C), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    di = torch.empty((B, num_heads, T), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _bwd_kernel()(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), out.stride(0), out.stride(1),
            do.stride(0), do.stride(1), dq.stride(0), dq.stride(1),
            B, num_heads, T, int(causal), float(sm_scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash_bwd kernel launch failed: CUDA error {rc}")
    flash_bwd_cuda.launches += 1
    return dq, dk, dv


flash_bwd_cuda.launches = 0


def flash_attention_bwd(qkv: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, num_heads: int,
                        causal: bool = True, sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of `flash_attention_fwd`: (dq, dk, dv), each (B, T, C),
    as the separate arrays the JAX package's `_bwd_parts` returns."""
    C = qkv.shape[-1] // 3
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(C // num_heads)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    fn = _build.on_device(qkv.device, flash_bwd_cuda, flash_bwd_plain,
                          "flash attention backward")
    return fn(q, k, v, out, lse, do, num_heads, causal, sm_scale)


class _FlashPacked(torch.autograd.Function):
    """flash attention over packed qkv with its K2 backward; the packed
    dqkv is the concatenation of dq, dk and dv."""

    @staticmethod
    def forward(ctx, qkv, num_heads, causal, sm_scale):
        out, lse = flash_attention_fwd(qkv, num_heads, causal, sm_scale)
        ctx.save_for_backward(qkv, out, lse)
        ctx.args = (num_heads, causal, sm_scale)
        return out

    @staticmethod
    def backward(ctx, do):
        qkv, out, lse = ctx.saved_tensors
        parts = flash_attention_bwd(qkv, out, lse, do.contiguous(), *ctx.args)
        return torch.cat(parts, dim=-1), None, None, None


def flash_attention_qkv(qkv: torch.Tensor, num_heads: int,
                        causal: bool = True,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention over packed qkv (B, T, 3C) -> (B, T, C);
    differentiable with respect to qkv."""
    return _FlashPacked.apply(qkv, num_heads, causal, sm_scale)
