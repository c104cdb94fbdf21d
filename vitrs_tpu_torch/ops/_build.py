"""Builds the package's CUDA sources into shared libraries, at first use.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by nvcc
alone, for sm_90a, into `vitrs_tpu_torch/_build/` (listed in .gitignore),
then loaded with ctypes.  No PyTorch header is included, so a build takes
seconds; the library is named by a hash of the sources and flags, so an
edited source builds anew and an unchanged one is reused.  Nothing here runs
at import time: the CPU tests import every module without a CUDA toolkit.
"""

from __future__ import annotations

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

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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


def _digest(src: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


@functools.cache
def load(name: str) -> Library:
    """Build (once per source version) and load `csrc/<name>.cu`.  Raises
    RuntimeError with nvcc's output when the build fails."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    path = os.path.join(BUILD_DIR, f"lib{name}_{_digest(src)}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        res = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                             capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = res.stdout + res.stderr
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        os.replace(tmp, path)    # atomic: concurrent builders never see half a file
    return Library(ctypes.CDLL(path), path, seconds, log)
