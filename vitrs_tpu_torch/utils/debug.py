"""NaN / Inf guards: the port of `vitrs_tpu/utils/debug.py`.

The JAX module turns on `jax_debug_nans` (`debug_mode`) and wraps a step in
checkify's float and index checks (`checked`).  PyTorch's public hook for
the same per-op check is `torch.overrides.TorchFunctionMode`: every torch
function, tensor method and `torch.ops` call made under the mode passes
through `_Checks.__torch_function__`, which

* before `embedding`, `gather`, `index_select` and a lookup `t[indices]`
  (the token embedding's) checks the indices against the dimension they
  index, so that an index out of range is a
  structured error on the host and not a CUDA device assert (which kills
  the context) or a read past the table;
* after the call raises at the first op whose floating output holds a NaN,
  or an Inf that no input held (an overflow, log(0), x/0): a mask that
  fills -inf on purpose reads -inf as an argument and passes.

The error, `CheckError`, names the op and the kind of violation.  A custom
kernel op (`vitrs::*`) is one op to the mode: its output is checked, its
inside is not.  Each check reads the output on the host, so a checked run
synchronises with the device at every op: a debugging tool, not a
production path.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Callable

import torch
from torch.overrides import TorchFunctionMode


class CheckError(RuntimeError):
    """A check failed: `op` is the function's name, `kind` one of "nan",
    "inf" or "index"."""

    def __init__(self, op: str, kind: str, detail: str):
        super().__init__(f"{kind} check failed at {op}: {detail}")
        self.op, self.kind = op, kind


def _leaves(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _leaves(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _leaves(y)


def _any_nonfinite(args, kwargs) -> bool:
    for a in (*args, *kwargs.values()):
        if isinstance(a, float) and not math.isfinite(a):
            return True
        for t in _leaves(a):
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                return True
    return False


def _index_args(name: str, args, kwargs):
    """(indices, size of the indexed dimension) of an indexing op, else
    None."""
    def arg(i, key):
        return args[i] if len(args) > i else kwargs.get(key)

    if name == "embedding":
        return arg(0, "input"), arg(1, "weight").shape[0]
    if name in ("gather", "index_select"):
        src, dim = arg(0, "input"), arg(1, "dim")
        return arg(2, "index"), src.shape[dim]
    if (name == "__getitem__" and isinstance(args[1], torch.Tensor)
            and not args[1].is_floating_point()
            and args[1].dtype != torch.bool):
        return args[1], args[0].shape[0]     # a table lookup, t[indices]
    return None


def _name(func) -> str:
    return getattr(func, "__name__", None) or str(func)


class _Checks(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _name(func)
        idx = _index_args(name, args, kwargs)
        if idx is not None and idx[0] is not None and idx[0].numel():
            ind, size = idx
            lo, hi = int(ind.min()), int(ind.max())
            if lo < 0 or hi >= size:
                raise CheckError(name, "index", f"indices in [{lo}, {hi}] "
                                 f"for a dimension of {size}")
        out = func(*args, **kwargs)
        for t in _leaves(out):
            if not t.is_floating_point() or t.is_meta:
                continue
            if bool(torch.isnan(t).any()):
                raise CheckError(name, "nan", f"output {tuple(t.shape)}")
            if (bool(torch.isinf(t).any())
                    and not _any_nonfinite(args, kwargs)):
                raise CheckError(name, "inf", f"output {tuple(t.shape)}")
        return out


@contextlib.contextmanager
def debug_mode(nans: bool = True):
    """Raise at the first op whose output is NaN or a new Inf (`nans`), and
    turn on `torch.autograd.set_detect_anomaly` for the backward; both are
    restored on exit."""
    prev = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(nans)
    try:
        with _Checks() if nans else contextlib.nullcontext():
            yield
    finally:
        torch.autograd.set_detect_anomaly(prev)


def checked(fn: Callable) -> Callable:
    """fn under the per-op float and index checks: returns a callable that
    raises `CheckError`, naming the op, on a violation (the checkify
    counterpart; there is nothing to jit)."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _Checks():
            return fn(*args, **kwargs)

    return wrapper


def global_norm(tree) -> torch.Tensor:
    """L2 norm over every tensor of a dict / list tree, summed in fp32 (the
    grad-norm metric)."""
    return torch.sqrt(sum(t.float().square().sum() for t in _leaves(tree)))
