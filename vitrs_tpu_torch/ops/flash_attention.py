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
* The two CUDA libraries also serve the GQA forward and backward (K3,
  ops/flash_attention_gqa.py) and the continuation-prefill forward (K4,
  ops/flash_prefill.py): `launch_fwd` takes kv_heads, a query length other
  than the key length and a query offset, `launch_bwd` takes kv_heads, and
  the plain versions take the same arguments.  Each kernel's wrapper counts
  its own launches, so a run shows which kernel served it.
* `flash_attention_qkv` is differentiable: an autograd.Function saves
  (qkv, out, lse) as the JAX package's `_flash_packed_fwd` does, and its
  backward returns the packed dqkv.
* `flash_fwd_cuda.launches` and `flash_bwd_cuda.launches` count the
  wrappers' calls into the library, so that a run can show that its
  attention went through the kernels.  A K1-fwd call launches one kernel;
  a K2 call launches three (pre-pass, dK/dV, dQ) and counts once.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import _build
from .rope import rope_table, rotate

HEAD_DIM = 64       # the kernel's head_dim: D of every GPT-2 preset
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _grouped(t: torch.Tensor, heads: int, group: int) -> torch.Tensor:
    """(B, T, heads*D) -> (B, heads, group, T, D) fp32 view-friendly layout:
    query heads fold as (kv head, member of its group); k/v pass group=1
    and broadcast over the group axis (no copy per query head)."""
    B, T, W = t.shape
    return (t.reshape(B, T, heads // group, group, W // heads)
            .permute(0, 2, 3, 1, 4).float())


def _hidden(Tq: int, Tk: int, q_offset: int, window: int,
            device) -> torch.Tensor:
    """True where key j is hidden from query row i in causal mode: j past
    the row's position q_offset + i, or, with a window, j at or before
    q_offset + i - window (query t sees keys in (t - window, t])."""
    rows = q_offset + torch.arange(Tq, device=device)[:, None]
    cols = torch.arange(Tk, device=device)[None, :]
    hidden = cols > rows
    if window:
        hidden |= cols <= rows - window
    return hidden


def _check_window(causal: bool, window: int):
    if window < 0 or (window and not causal):
        raise ValueError(f"window {window}: a sliding window is causal-only "
                         f"and >= 0")


def _rotated(x: torch.Tensor, heads: int, pos0: int, rope: bool,
             scale: Optional[float] = None) -> torch.Tensor:
    """x (B, T, heads*D) rotated at positions pos0.. with the kernels'
    table, scale folded in, rounded to x's dtype: what the kernels compute
    as they load q or k.  Without rope, x * scale rounded (x itself when
    scale is None)."""
    if not rope:
        return x if scale is None else (x.float() * scale).to(x.dtype)
    T = x.shape[1]
    cos, sin = table_for(pos0 + T, x.device)
    return rotate(x, cos[pos0:pos0 + T], sin[pos0:pos0 + T], heads,
                  scale=scale).to(x.dtype)


def table_for(rows: int, device):
    """The rope table the kernels read for `rows` positions: `rope_table`
    at rows rounded up to 256, so that a few table sizes serve every call
    (the rows a table holds do not depend on its length)."""
    return rope_table(-(-rows // 256) * 256, HEAD_DIM, device)


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    num_heads: int, causal: bool, sm_scale: float,
                    kv_heads: int = 0, q_offset: int = 0, window: int = 0,
                    rope: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: q (B, Tq, C) at absolute
    positions q_offset..q_offset+Tq-1, k/v (B, Tk, kv_heads*D) ->
    (out (B, Tq, C) in q's dtype, lse (B, NH, Tq) fp32).  kv_heads 0 means
    num_heads; query head h reads kv head h // (num_heads // kv_heads).  In
    causal mode the keys are cut at the frontier q_offset + Tq before any
    arithmetic, so cache slots beyond it are never read (not even as 0 *
    NaN); the kernel never loads them either.  window > 0 (causal only)
    hides keys at or before position - window.  rope=True rotates q (at
    its positions, sm_scale folded in) and k (at 0..Tk-1) with the fp32
    table and rounds both to their dtype, as the kernel does as it loads
    them; q, k and v arrive unrotated.

    Same numerics as the Pallas and CUDA kernels: q scaled by sm_scale and
    rounded to its dtype, scores and softmax statistics in fp32, p rounded
    to v's dtype for P.V with an fp32 accumulator, out = acc / l."""
    _check_window(causal, window)
    B, Tq, C = q.shape
    KH = kv_heads or num_heads
    R = num_heads // KH
    if causal:
        k, v = k[:, :q_offset + Tq], v[:, :q_offset + Tq]
    Tk = k.shape[1]
    qs = _grouped(_rotated(q, num_heads, q_offset, rope, sm_scale),
                  num_heads, R)
    s = torch.matmul(qs, _grouped(_rotated(k, KH, 0, rope), KH, 1)
                     .transpose(-1, -2))
    if causal:
        s = s.masked_fill(_hidden(Tq, Tk, q_offset, window, q.device),
                          -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    # a row that sees no key keeps a finite reference, so p = 0, not NaN
    ref = torch.where(m == -math.inf, torch.zeros_like(m), m)
    p = torch.exp(s - ref)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.matmul(p.to(v.dtype).float(), _grouped(v, KH, 1))
    inv = torch.where(l > 0, 1.0 / l, torch.zeros_like(l))
    out = (pv * inv).to(q.dtype).permute(0, 3, 1, 2, 4).reshape(B, Tq, C)
    lse = torch.where(l > 0, ref + torch.log(l),
                      torch.full_like(l, -math.inf))[..., 0]
    return out, lse.reshape(B, num_heads, Tq)


@functools.cache
def _kernel():
    fn = _build.load("flash_fwd").lib.vitrs_flash_fwd
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [I, P, P, P, P, P, LL, LL, LL, LL, LL, LL, LL, LL,
                   I, I, I, I, I, I, I, I, ctypes.c_float, P, P, P]
    fn.restype = I
    return fn


def _check_layout(what: str, ts, ref: torch.Tensor):
    """The kernels' layout rules for every tensor they read or write: on
    ref's CUDA device, in its dtype (float32 or bfloat16), (B, T, W) with
    the inner dim contiguous and rows and base 16-byte aligned for the
    kernels' vector loads."""
    for t in ts:
        if t.device.type != "cuda" or t.device != ref.device:
            raise ValueError(f"{what}: tensors must be on one CUDA device")
        if ref.dtype not in _DTYPE_CODE or t.dtype != ref.dtype:
            raise TypeError(f"{what} takes float32 or bfloat16, got "
                            f"{[x.dtype for x in ts]}")
        if t.dim() != 3 or t.shape[0] != ref.shape[0]:
            raise ValueError(f"{what}: (B, T, W) tensors of one batch, got "
                             f"{[tuple(x.shape) for x in ts]}")
        if (t.stride(2) != 1 or t.stride(1) % 8 or t.stride(0) % 8
                or t.data_ptr() % 16):
            raise ValueError(f"{what}: unsupported layout, strides "
                             f"{t.stride()}")


def _check_heads(what: str, q, k, num_heads: int, kv_heads: int):
    if q.shape[2] != num_heads * HEAD_DIM:
        raise ValueError(f"{what} takes head_dim {HEAD_DIM}, got C="
                         f"{q.shape[2]} with {num_heads} heads")
    if kv_heads <= 0 or num_heads % kv_heads or k.shape[2] != kv_heads * HEAD_DIM:
        raise ValueError(f"{what}: k/v width {k.shape[2]} is not kv_heads="
                         f"{kv_heads} (dividing {num_heads}) x {HEAD_DIM}")


def _table_ptrs(rope: bool, rows: int, device):
    """(cos, sin) data pointers of the rope table for `rows` positions, or
    two nulls without rope."""
    if not rope:
        return None, None
    cos, sin = table_for(rows, device)
    return cos.data_ptr(), sin.data_ptr()


def launch_fwd(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               num_heads: int, kv_heads: int, causal: bool, sm_scale: float,
               q_offset: int = 0, window: int = 0, rope: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/flash_fwd.cu on q's current stream: the contract of
    `flash_fwd_plain`.  Counts nothing: each kernel's public wrapper (K1
    `flash_fwd_cuda`, K3 `flash_gqa_fwd_cuda`, K4 `flash_prefill_cuda`)
    counts its own launches.  q, k, v may be strided views (last dim
    contiguous).  Raises on anything the kernel does not take, and if the
    launch is refused."""
    _check_layout(what, (q, k, v), q)
    _check_heads(what, q, k, num_heads, kv_heads)
    _check_window(causal, window)
    B, Tq, C = q.shape
    Tk = k.shape[1]
    if v.shape != k.shape or q_offset < 0 or (causal and q_offset + Tq > Tk):
        raise ValueError(f"{what}: q {tuple(q.shape)} at offset {q_offset} "
                         f"does not fit k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    # the causal frontier: keys past the last query's position are never
    # loaded, so a cache tail may hold anything
    seq_len = q_offset + Tq if causal else Tk
    out = torch.empty((B, Tq, C), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, num_heads, Tq), dtype=torch.float32,
                      device=q.device)
    cos, sin = _table_ptrs(rope, max(seq_len, q_offset + Tq), q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(),
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), out.stride(0), out.stride(1),
            B, num_heads, kv_heads, Tq, seq_len, q_offset, int(causal),
            int(window), float(sm_scale), cos, sin, stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    return out, lse


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   num_heads: int, causal: bool, sm_scale: float,
                   window: int = 0, rope: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1-fwd on q's current stream: MHA self-attention, the
    contract of `flash_fwd_plain` with q, k and v of one shape.  q/k/v may
    be strided views into one packed buffer (the last dim must be
    contiguous).  Raises on anything the kernel does not take, and if the
    launch is refused."""
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_fwd_cuda: q, k, v must share one (B, T, C) "
                         f"shape, got {[tuple(t.shape) for t in (q, k, v)]}")
    res = launch_fwd("flash_fwd_cuda", q, k, v, num_heads, num_heads, causal,
                     sm_scale, window=window, rope=rope)
    flash_fwd_cuda.launches += 1
    return res


flash_fwd_cuda.launches = 0


def flash_attention_fwd(qkv: torch.Tensor, num_heads: int,
                        causal: bool = True, sm_scale: Optional[float] = None,
                        window: int = 0, rope: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed qkv (B, T, 3C) -> (out (B, T, C), lse (B, NH, T) fp32).
    q, k and v are views into qkv: the kernel reads them in place.  rope
    rotates q and k at positions 0..T-1 inside the kernel; window > 0 is
    the causal band (t - window, t]."""
    B, T, C3 = qkv.shape
    C = C3 // 3
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(C // num_heads)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    fn = _build.on_device(qkv.device, flash_fwd_cuda, flash_fwd_plain,
                          "flash attention")
    return fn(q, k, v, num_heads, causal, sm_scale, window=window, rope=rope)


def scale_in_fp32(sm_scale: float) -> bool:
    """Whether the backward scales s in fp32 instead of forming q^ = q *
    sm_scale rounded: when sm_scale is a power of two (1/8 at D = 64), the
    product q * sm_scale is exact in bf16 and fp32, so (q * sm_scale) . k^T
    and sm_scale * (q . k^T) are the same bits."""
    return sm_scale > 0 and math.frexp(sm_scale)[0] == 0.5


def flash_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                    num_heads: int, causal: bool, sm_scale: float,
                    kv_heads: int = 0, window: int = 0, rope: bool = False,
                    *, fp32_scale: Optional[bool] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's and K3-bwd's function in plain PyTorch: q, out, do (B, T, C),
    k, v (B, T, kv_heads*D), lse (B, NH, T) fp32 -> (dq (B, T, C), dk, dv
    (B, T, kv_heads*D)) in q's dtype.  kv_heads 0 means num_heads; dk and
    dv are summed over each kv head's group of query heads in fp32, then
    rounded once, as the kernel does.

    The numerics of the multi-tile Pallas backward bodies (`_bwd_body`):
    q^ = q * sm_scale rounded to its dtype, s = q^ . k^T in fp32,
    p = exp(s - lse) (0 where masked), di = rowsum(out * do) in fp32,
    ds = p * (do . v^T - di) * sm_scale; dv = p^T . do, dk = ds^T . q with
    the unscaled q, dq = ds . k, with p and ds rounded to the input dtype
    before their products and fp32 accumulation.  rope=True: q and k are
    first rotated at 0..T-1 and rounded to their dtype (q^ is then the
    rotated q times sm_scale, rounded again), and dq and dk are rotated
    back by -theta in fp32 before their rounding, as the Pallas kernels'
    epilogues do.  window: the forward's band.  fp32_scale: compute s as
    sm_scale * (q . k^T) in fp32 instead of through q^; None takes the
    kernel's choice, `scale_in_fp32(sm_scale)` (the same bits where it
    applies)."""
    _check_window(causal, window)
    B, T, C = q.shape
    KH = kv_heads or num_heads
    R = num_heads // KH
    dtype = q.dtype
    qr, kr = _rotated(q, num_heads, 0, rope), _rotated(k, KH, 0, rope)
    qf, dof = _grouped(qr, num_heads, R), _grouped(do, num_heads, R)
    kf, vf = _grouped(kr, KH, 1), _grouped(v, KH, 1)
    if scale_in_fp32(sm_scale) if fp32_scale is None else fp32_scale:
        s = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale
    else:
        qh = (qf * sm_scale).to(dtype).float()
        s = torch.matmul(qh, kf.transpose(-1, -2))
    lse = lse.reshape(B, KH, R, T)[..., None]
    p = torch.exp(s - lse)
    if causal:
        p = p.masked_fill(_hidden(T, T, 0, window, q.device), 0.0)
    di = (_grouped(out, num_heads, R) * dof).sum(dim=-1, keepdim=True)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - di) * sm_scale
    pr, dsr = p.to(dtype).float(), ds.to(dtype).float()
    dv = torch.matmul(pr.transpose(-1, -2), dof).sum(dim=2)
    dk = torch.matmul(dsr.transpose(-1, -2), qf).sum(dim=2)
    dq = torch.matmul(dsr, kf)

    def packed(t, heads):   # (B, heads, [group,] T, D) fp32 -> (B, T, heads*D)
        if t.dim() == 5:
            t = t.flatten(1, 2)
        t = t.transpose(1, 2).reshape(B, T, -1)
        if rope and heads:
            cos, sin = table_for(T, q.device)
            t = rotate(t, cos[:T], sin[:T], heads, inverse=True)
        return t.to(dtype)

    return packed(dq, num_heads), packed(dk, KH), packed(dv, 0)


@functools.cache
def _bwd_kernel():
    fn = _build.load("flash_bwd").lib.vitrs_flash_bwd
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = ([I] + [P] * 13 + [LL] * 14 + [I] * 6
                   + [ctypes.c_float, P, P, P])
    fn.restype = I
    return fn


def launch_bwd(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
               num_heads: int, kv_heads: int, causal: bool, sm_scale: float,
               window: int = 0, rope: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch csrc/flash_bwd.cu (three kernels: the pre-pass, dK/dV, dQ) on
    q's current stream: the contract of `flash_bwd_plain`.  Counts nothing:
    K2's `flash_bwd_cuda` and K3's `flash_gqa_bwd_cuda` count their own
    launches.  q/k/v may be strided views into the packed qkv, out and do
    strided (B, T, C) tensors (last dim contiguous).  Raises on anything
    the kernel does not take, and if a launch is refused."""
    _check_layout(what, (q, k, v, out, do), q)
    _check_heads(what, q, k, num_heads, kv_heads)
    _check_window(causal, window)
    B, T, C = q.shape
    if (k.shape[1] != T or v.shape != k.shape or out.shape != q.shape
            or do.shape != q.shape):
        raise ValueError(f"{what}: q/out/do {[tuple(t.shape) for t in (q, out, do)]}"
                         f" and k/v {[tuple(t.shape) for t in (k, v)]} do not "
                         f"match")
    if (lse.shape != (B, num_heads, T) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"{what}: lse must be a contiguous fp32 "
                         f"({B}, {num_heads}, {T}) tensor on q's device")
    dq = torch.empty((B, T, C), dtype=q.dtype, device=q.device)
    dk, dv = (torch.empty(k.shape, dtype=q.dtype, device=q.device)
              for _ in range(2))
    di = torch.empty((B, num_heads, T), dtype=torch.float32, device=q.device)
    # the bf16 pre-pass's scratch: q and k rotated under rope, q^ when
    # sm_scale is not a power of two (fp32 takes none)
    bf16 = q.dtype == torch.bfloat16
    q_rot, k_rot, q_hat = (
        torch.empty((B, T, w), dtype=q.dtype, device=q.device) if need else None
        for w, need in ((C, bf16 and rope), (k.shape[2], bf16 and rope),
                        (C, bf16 and not scale_in_fp32(sm_scale))))
    cos, sin = _table_ptrs(rope, T, q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _bwd_kernel()(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *(t.data_ptr() if t is not None else None
              for t in (q_rot, k_rot, q_hat)),
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), out.stride(0), out.stride(1),
            do.stride(0), do.stride(1), dq.stride(0), dq.stride(1),
            dk.stride(0), dk.stride(1),
            B, num_heads, kv_heads, T, int(causal), int(window),
            float(sm_scale), cos, sin, stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    return dq, dk, dv


def flash_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                   num_heads: int, causal: bool, sm_scale: float,
                   window: int = 0, rope: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K2 (three kernels: pre-pass, dK/dV, dQ; `launches` counts
    the call once) on q's current stream: MHA, the contract of
    `flash_bwd_plain` with q, k and v of one shape."""
    if k.shape != q.shape:
        raise ValueError(f"flash_bwd_cuda: k {tuple(k.shape)} must have q's "
                         f"shape {tuple(q.shape)}")
    res = launch_bwd("flash_bwd_cuda", q, k, v, out, lse, do, num_heads,
                     num_heads, causal, sm_scale, window, rope)
    flash_bwd_cuda.launches += 1
    return res


flash_bwd_cuda.launches = 0


def flash_attention_bwd(qkv: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, num_heads: int,
                        causal: bool = True, sm_scale: Optional[float] = None,
                        window: int = 0, rope: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of `flash_attention_fwd`: (dq, dk, dv), each (B, T, C),
    as the separate arrays the JAX package's `_bwd_parts` returns (under
    rope, dq and dk are gradients of the unrotated q and k)."""
    C = qkv.shape[-1] // 3
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(C // num_heads)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    fn = _build.on_device(qkv.device, flash_bwd_cuda, flash_bwd_plain,
                          "flash attention backward")
    return fn(q, k, v, out, lse, do, num_heads, causal, sm_scale,
              window=window, rope=rope)


class _FlashPacked(torch.autograd.Function):
    """flash attention over packed qkv with its K2 backward; the packed
    dqkv is the concatenation of dq, dk and dv."""

    @staticmethod
    def forward(ctx, qkv, num_heads, causal, sm_scale, window, rope):
        out, lse = flash_attention_fwd(qkv, num_heads, causal, sm_scale,
                                       window, rope)
        ctx.save_for_backward(qkv, out, lse)
        ctx.args = (num_heads, causal, sm_scale, window, rope)
        return out

    @staticmethod
    def backward(ctx, do):
        qkv, out, lse = ctx.saved_tensors
        parts = flash_attention_bwd(qkv, out, lse, do.contiguous(), *ctx.args)
        return torch.cat(parts, dim=-1), None, None, None, None, None


def flash_attention_qkv(qkv: torch.Tensor, num_heads: int,
                        causal: bool = True,
                        sm_scale: Optional[float] = None, window: int = 0,
                        rope: bool = False) -> torch.Tensor:
    """Flash attention over packed qkv (B, T, 3C) -> (B, T, C);
    differentiable with respect to qkv.  qkv arrives unrotated: rope=True
    rotates q and k at positions 0..T-1 inside the kernels, and the
    gradient is that of the unrotated qkv."""
    return _FlashPacked.apply(qkv, num_heads, causal, sm_scale, window, rope)
