"""Generic flat-binary pytree checkpoint — the port's copy of
`vitrs_tpu/checkpoint_tree.py` (numpy only, the same format), so that a tree
written by one package loads in the other.  The port keeps its optimizer
states that are not the flat AdamW m/v (Adafactor, Muon) in such side trees,
as the JAX loop does.

Format: 1024-byte header [magic2, version, n_tensors, manifest length] + a
UTF-8 JSON manifest of (name, shape, dtype) in order + raw contiguous
payloads.  Nested dicts flatten to "a/b" names; an empty dict writes
nothing, so a reader defaults it back.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

MAGIC2 = 20240817
HEADER_BYTES = 1024


def _flatten(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_tree(path: str, tree: dict, meta: dict | None = None) -> None:
    flat = _flatten(tree)
    manifest = json.dumps({
        "tensors": [{"name": k, "shape": list(v.shape), "dtype": str(v.dtype)}
                    for k, v in flat.items()],
        "meta": meta or {},
    }).encode()
    header = np.zeros(HEADER_BYTES // 4, np.int32)
    header[0] = MAGIC2
    header[1] = 1
    header[2] = len(flat)
    header[3] = len(manifest)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(header.tobytes())
        f.write(manifest)
        for v in flat.values():
            f.write(np.ascontiguousarray(v).tobytes())
    os.replace(tmp, path)


def load_tree(path: str):
    with open(path, "rb") as f:
        header = np.frombuffer(f.read(HEADER_BYTES), np.int32)
        if int(header[0]) != MAGIC2:
            raise ValueError(f"bad tree-checkpoint magic in {path}")
        manifest = json.loads(f.read(int(header[3])).decode())
        flat = {}
        for t in manifest["tensors"]:
            n = int(np.prod(t["shape"])) if t["shape"] else 1
            dt = np.dtype(t["dtype"])
            buf = f.read(n * dt.itemsize)
            if len(buf) != n * dt.itemsize:
                raise ValueError(f"truncated tree checkpoint at {t['name']}")
            flat[t["name"]] = np.frombuffer(buf, dt).reshape(t["shape"]).copy()
    return _unflatten(flat), manifest["meta"]
