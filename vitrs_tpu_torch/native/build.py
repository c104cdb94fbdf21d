"""Build + load the native host-side components (C++ -> .so via g++, ctypes):
a copy of `vitrs_tpu/native/build.py`.

Compiled lazily on first use into `vitrs_tpu_torch/_build/native/` (listed
in .gitignore), keyed by a source hash, so a fresh checkout builds once and
stays warm.  A build goes to a temporary file named by the process and is
renamed into place, so concurrent builds (test workers) never load half
a file.  Every caller has a path without the library, as in the JAX
package: `data/augment.py` its NumPy path, `data/imagenet.py` its PIL path
(recorded as the loader's `decoder`), `checkpoint_async.py` plain file
writes.  These are host C++, not kernels of the model.

The port's additions: `load` keeps the compiler's output of a failed build
in `ERRORS[name]`, so a caller can say why a component is missing (the
card's machine may have no libjpeg headers), and `imagepipe.cpp` has a
uint8 entry point (see data/augment.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(os.path.dirname(_DIR), "_build", "native")
_LOCK = threading.Lock()
_CACHE: Dict[str, Optional[ctypes.CDLL]] = {}
ERRORS: Dict[str, str] = {}

CXX = os.environ.get("CXX", "g++")
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread",
            "-march=native", "-Wall"]
# per-component extra link/compile flags
EXTRA_FLAGS = {"jpegpipe": ["-ljpeg"]}


def _source_hash(src_path: str) -> str:
    with open(src_path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def load(name: str) -> Optional[ctypes.CDLL]:
    """Compile (if needed) and dlopen native/<name>.cpp.  None on failure,
    with the reason in ERRORS[name]."""
    with _LOCK:
        if name in _CACHE:
            return _CACHE[name]
        src = os.path.join(_DIR, f"{name}.cpp")
        if not os.path.exists(src):
            ERRORS[name] = f"no source {src}"
            _CACHE[name] = None
            return None
        tag = _source_hash(src)
        so_path = os.path.join(_BUILD, f"lib{name}-{tag}.so")
        if not os.path.exists(so_path):
            os.makedirs(_BUILD, exist_ok=True)
            tmp = so_path + f".tmp{os.getpid()}"
            cmd = [CXX, *CXXFLAGS, "-o", tmp, src, *EXTRA_FLAGS.get(name, [])]
            try:
                subprocess.run(cmd, check=True, capture_output=True,
                               text=True, timeout=180)
                os.replace(tmp, so_path)
            except subprocess.CalledProcessError as e:
                ERRORS[name] = (e.stderr or e.stdout or str(e)).strip()
                _CACHE[name] = None
                return None
            except (subprocess.SubprocessError, OSError) as e:
                ERRORS[name] = str(e)
                _CACHE[name] = None
                return None
        try:
            lib = ctypes.CDLL(so_path)
        except OSError as e:
            ERRORS[name] = str(e)
            lib = None
        _CACHE[name] = lib
        return lib
