"""The parameter layout the reference and the benchmark's weights use: the
canonical tensors of GPT-2 and ViT as the port stores them (a frozen copy
of `vitrs_tpu_torch/params.py`'s `param_shapes` and order for the dense
configurations), per-layer tensors stacked on a leading L axis, matmul
weights (out, in).  The names are the interface with the program: the
benchmark hands it these tensors by name.

`leaves` splits the tensors into the units the training comparison takes
norms of: each canonical tensor, with the packed qkv weight and bias split
into their q, k and v thirds, as three projections.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

GPT = ("wte", "wpe", "ln1w", "ln1b", "qkvw", "qkvb", "attprojw", "attprojb",
       "ln2w", "ln2b", "fcw", "fcb", "fcprojw", "fcprojb", "lnfw", "lnfb")
VIT = GPT + ("patchw", "patchb", "cls", "headw", "headb")


def order(s) -> Tuple[str, ...]:
    return VIT if s.mode == "vit" else GPT


def shapes(s) -> Dict[str, Tuple[int, ...]]:
    L, C = s.num_layers, s.channels
    H = s.mlp_ratio * C
    V = s.num_classes if s.mode == "vit" else s.vocab_size
    T = s.seq_len if s.mode == "vit" else s.max_seq_len
    out = {
        "wte": (V, C), "wpe": (T, C),
        "ln1w": (L, C), "ln1b": (L, C),
        "qkvw": (L, 3 * C, C), "qkvb": (L, 3 * C),
        "attprojw": (L, C, C), "attprojb": (L, C),
        "ln2w": (L, C), "ln2b": (L, C),
        "fcw": (L, H, C), "fcb": (L, H),
        "fcprojw": (L, C, H), "fcprojb": (L, C),
        "lnfw": (C,), "lnfb": (C,),
    }
    if s.mode == "vit":
        P = s.patch_size
        out.update({"patchw": (C, P * P * s.in_chans), "patchb": (C,),
                    "cls": (1, 1, C), "headw": (s.num_classes, C),
                    "headb": (s.num_classes,)})
    return out


def num_parameters(s) -> int:
    n = 0
    for shp in shapes(s).values():
        k = 1
        for d in shp:
            k *= d
        n += k
    return n


def leaves(tensors: Dict[str, torch.Tensor], s) -> Dict[str, torch.Tensor]:
    """Views of `tensors` (canonical names) by leaf: qkvw / qkvb as
    q, k and v thirds, every other tensor whole."""
    C = s.channels
    out = {}
    for name in order(s):
        t = tensors[name]
        if name in ("qkvw", "qkvb"):
            for i, part in enumerate("qkv"):
                out[f"{name}.{part}"] = t[:, i * C:(i + 1) * C]
        else:
            out[name] = t
    return out


def decayed(name: str, s) -> bool:
    """The weight-decay rule of the cells' AdamW: tensors of two or more
    axes in this stacked layout (so the per-layer biases and LN parameters,
    stacked (L, C), are decayed; the final LN and the vit patch bias and
    head bias are not)."""
    return len(shapes(s)[name]) >= 2
