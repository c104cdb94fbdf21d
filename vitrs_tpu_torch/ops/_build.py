"""Builds the package's CUDA sources into shared libraries, at first use.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by nvcc
alone, for sm_90a, into `vitrs_tpu_torch/_build/` (listed in .gitignore),
then loaded with ctypes.  No PyTorch header is included, so a build takes
seconds; the library is named by a hash of the sources and flags, so an
edited source builds anew and an unchanged one is reused.  The flash
sources are built once per head dim (`load(name, head_dim)`: the same
source with -DVITRS_HEAD_DIM=D into `lib<name>_d<D>_<hash>.so`), each at
the first call that needs it.  Nothing here runs at import time: the CPU
tests import every module without a CUDA toolkit.

`kernel_op` registers each kernel as a `torch.library` custom op in the
`vitrs` namespace, the one rule every kernel's caller follows: the kernel
for a CUDA tensor, its plain PyTorch version for a CPU tensor, a fake
(shape-only) version for tracing (`torch.export`, FakeTensor), and no
implementation for any other device, where the dispatcher raises.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Optional

import numpy as np

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the sources built once per head dim; they have no default head dim
PER_HEAD_DIM = ("flash_fwd", "flash_bwd")


@dataclasses.dataclass(frozen=True)
class Library:
    lib: ctypes.CDLL
    path: str
    build_seconds: float    # 0.0 when an earlier build was reused
    log: str                # nvcc's output (ptxas registers/smem per kernel)


def nvcc() -> str:
    """The nvcc of $CUDA_HOME, else of the toolkit PyTorch finds, else PATH's."""
    home = os.environ.get("CUDA_HOME")
    if home is None:
        from torch.utils import cpp_extension
        home = cpp_extension.CUDA_HOME
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to a CUDA toolkit "
                           "with sm_90a support")
    return found


def flags_for(head_dim: Optional[int] = None) -> tuple:
    """nvcc's flags for a source, with head_dim one built for that head dim
    (-DVITRS_HEAD_DIM=D)."""
    if head_dim is None:
        return NVCC_FLAGS
    return NVCC_FLAGS + (f"-DVITRS_HEAD_DIM={int(head_dim)}",)


def _digest(src: str, flags=NVCC_FLAGS) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for path in [src] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


@functools.cache
def load(name: str, head_dim: Optional[int] = None) -> Library:
    """Build (once per source version) and load `csrc/<name>.cu`.  A source
    of PER_HEAD_DIM takes a head_dim and is built for it (-DVITRS_HEAD_DIM,
    which enters the hash and the file name, so each head dim has one
    library of its own); any other takes none (ValueError otherwise).
    nvcc's output is kept beside the library (`.log`), so a reused build
    still reports its ptxas lines.  Raises RuntimeError with nvcc's output
    when the build fails."""
    if (head_dim is None) == (name in PER_HEAD_DIM):
        raise ValueError(f"load({name!r}, head_dim={head_dim}): the sources "
                         f"{PER_HEAD_DIM} take a head_dim, the others none")
    src = os.path.join(CSRC_DIR, name + ".cu")
    flags = flags_for(head_dim)
    tag = name if head_dim is None else f"{name}_d{int(head_dim)}"
    path = os.path.join(BUILD_DIR, f"lib{tag}_{_digest(src, flags)}.so")
    seconds, log = 0.0, ""
    if os.path.exists(path) and os.path.exists(path + ".log"):
        with open(path + ".log") as f:
            log = f.read()
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        res = subprocess.run([nvcc(), *flags, "-o", tmp, src],
                             capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = res.stdout + res.stderr
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        with open(tmp + ".log", "w") as f:
            f.write(log)
        os.replace(tmp + ".log", path + ".log")
        os.replace(tmp, path)    # atomic: concurrent builders never see half a file
    return Library(ctypes.CDLL(path), path, seconds, log)


def resolve_device(name) -> "torch.device":
    """torch.device(name) for an entry point; a CUDA device must exist (no
    fallback to the CPU)."""
    import torch
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --cpu (device='cpu') to "
                           "run on the CPU")
    return device


def to_device(a, device) -> "torch.Tensor":
    """A numpy array or a tensor on `device`.  Host data bound for a CUDA
    device goes through pinned memory with a non-blocking copy, so the
    host does not wait for the stream's queued work (a copy from pageable
    memory synchronises the stream)."""
    import torch
    device = torch.device(device)
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def kernel_op(name: str, schema: str, cpu, cuda, fake,
              mutates_args=()):
    """Register `vitrs::<name>` with `schema`: `cuda` (the kernel's
    wrapper, which validates, launches and counts) for CUDA tensors, `cpu`
    (its plain PyTorch version) for CPU tensors, `fake` for tracing.
    Callers pass `lambda *a: wrapper(*a)`, so that the module attribute is
    read at each call (a test may stand a recording function in for it).  There
    is no fallback from one to the other: the wrapper itself raises on what
    its kernel does not take, and a tensor on any other device finds no
    implementation.  Returns the op's overload, the cheapest handle to call
    (the dispatcher's host cost a call is in PERF.md)."""
    import torch
    op = torch.library.custom_op(f"vitrs::{name}", cpu,
                                 mutates_args=mutates_args,
                                 device_types="cpu", schema=schema)
    op.register_kernel("cuda")(cuda)
    op.register_fake(fake)
    return getattr(torch.ops.vitrs, name).default


def load_all(names) -> dict:
    """`load` each of `names` (a name per `csrc/<name>.cu`, or a (name,
    head_dim) pair), running their nvcc builds at the same time.  Returns
    {name or pair: Library}."""
    names = list(names)

    def one(n):
        return load(*n) if isinstance(n, tuple) else load(n)
    with concurrent.futures.ThreadPoolExecutor(max(1, len(names))) as ex:
        return dict(zip(names, ex.map(one, names)))
