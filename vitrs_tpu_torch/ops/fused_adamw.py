"""K7: fused AdamW over the flat fp32 parameter vector.

The port of `vitrs_tpu/ops/fused_adamw.py`: its Pallas kernel
(`adamw_pallas`, body `_adamw_kernel`) becomes the CUDA kernel
`vitrs_adamw` in `csrc/fused_adamw.cu`.  One pass over device memory reads
(p, g, m, v) and writes (p, m, v).  The JAX kernel returns new arrays that
alias its inputs; the port updates p, m and v in place, which is what the
aliasing achieves there.

* The kernel is the custom op `vitrs::adamw_` (`_build.kernel_op`), which
  mutates p, m and v and returns nothing.  A CUDA tensor goes to the
  kernel, or the wrapper raises; a CPU tensor goes to `adamw_plain`, the same update in plain PyTorch, operation by
  operation in the kernel's order.
* The bias corrections are formed as the Pallas body forms them,
  1 - exp(t * log(beta)) in fp32 (`adamw_step_jnp` uses beta ** t; both
  packages' plain versions follow their kernels).
* `adamw_cuda.launches` counts launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from . import _build

_G_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BLOCKS = 132 * 16      # 16 blocks of 256 threads per H100 SM


def adamw_plain(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, step, lr, beta1: float = 0.9,
                beta2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.0
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K7's function in plain PyTorch, in place on p, m and v (fp32, any
    shape); returns them.  Every operation is an fp32 operation of the
    kernel's, in its order."""
    f32 = dict(dtype=torch.float32, device=p.device)
    with torch.no_grad():
        t = torch.tensor(float(step), **f32)
        lb1 = torch.tensor(math.log(beta1), **f32)
        lb2 = torch.tensor(math.log(beta2), **f32)
        bc1 = 1.0 - torch.exp(t * lb1)
        bc2 = 1.0 - torch.exp(t * lb2)
        gf = g.float()
        m.mul_(beta1).add_(gf * (1.0 - beta1))
        v.mul_(beta2).add_(gf * (1.0 - beta2) * gf)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + eps) + p * weight_decay
        p.sub_(upd * lr)
    return p, m, v


@functools.cache
def _kernel():
    fn = _build.load("fused_adamw").lib.vitrs_adamw
    P, LL, I, F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    fn.argtypes = [I, P, P, P, P, LL] + [F] * 10 + [I, I, P]
    fn.restype = I
    return fn


def adamw_cuda(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
               v: torch.Tensor, step, lr, beta1: float = 0.9,
               beta2: float = 0.999, eps: float = 1e-8,
               weight_decay: float = 0.0
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K7 on the current stream: in place on contiguous fp32 p, m, v
    of one shape, g fp32 or bf16 of that shape.  Returns (p, m, v)."""
    ts = (p, g, m, v)
    if any(t.device.type != "cuda" or t.device != p.device for t in ts):
        raise ValueError("adamw_cuda: p, g, m, v must be on one CUDA device")
    if any(t.dtype != torch.float32 for t in (p, m, v)) or g.dtype not in _G_CODE:
        raise TypeError(f"adamw_cuda: p, m, v fp32 and g fp32 or bf16, got "
                        f"{[t.dtype for t in ts]}")
    if any(t.shape != p.shape or not t.is_contiguous() for t in ts):
        raise ValueError("adamw_cuda: p, g, m, v must be contiguous and of "
                         "one shape")
    n = p.numel()
    if n == 0:
        return p, m, v
    vec = int(all(t.data_ptr() % 16 == 0 for t in (p, m, v))
              and g.data_ptr() % (4 * g.element_size()) == 0)
    blocks = max(1, min(_MAX_BLOCKS, -(-n // (4 * 256))))
    with torch.cuda.device(p.device):
        rc = _kernel()(
            _G_CODE[g.dtype], p.data_ptr(), g.data_ptr(), m.data_ptr(),
            v.data_ptr(), n, float(step), float(lr), beta1, 1.0 - beta1,
            math.log(beta1), beta2, 1.0 - beta2, math.log(beta2), eps,
            float(weight_decay), vec, blocks,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"adamw kernel launch failed: CUDA error {rc}")
    adamw_cuda.launches += 1
    return p, m, v


adamw_cuda.launches = 0


def _adamw_op_plain(p, g, m, v, step, lr, beta1, beta2, eps, weight_decay):
    adamw_plain(p, g, m, v, step, lr, beta1, beta2, eps, weight_decay)


def _adamw_op_cuda(p, g, m, v, step, lr, beta1, beta2, eps, weight_decay):
    adamw_cuda(p, g, m, v, step, lr, beta1, beta2, eps, weight_decay)


adamw_op = _build.kernel_op(
    "adamw_", "(Tensor(a!) p, Tensor g, Tensor(b!) m, Tensor(c!) v, "
    "float step, float lr, float beta1, float beta2, float eps, "
    "float weight_decay) -> ()", _adamw_op_plain, _adamw_op_cuda,
    lambda *args: None, mutates_args=("p", "m", "v"))
