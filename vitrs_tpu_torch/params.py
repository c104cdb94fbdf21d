"""Parameter memory model — the port of `vitrs_tpu/params.py`.

The 16 reference tensors keep their canonical order and shapes (they define
the checkpoint payload), per-layer tensors stay stacked on a leading L axis,
and matmul weights stay in (OC, C) form used as y = x @ W.T + b.  So a
parameter dict of this package holds the same arrays, under the same names,
as the JAX package's pytree, and `from_numpy` / `to_numpy` carry one into the
other.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .config import ViTConfig

CANONICAL_16 = (
    "wte", "wpe", "ln1w", "ln1b", "qkvw", "qkvb", "attprojw", "attprojb",
    "ln2w", "ln2b", "fcw", "fcb", "fcprojw", "fcprojb", "lnfw", "lnfb",
)
VIT_EXT = ("patchw", "patchb", "cls", "headw", "headb")
MOE_EXT = ("routerw",)


def param_shapes(cfg: ViTConfig) -> Dict[str, Tuple[int, ...]]:
    """Shapes in canonical order. Leading L axis on per-layer tensors."""
    L, C, V, T = cfg.num_layers, cfg.channels, cfg.vocab_size, cfg.max_seq_len
    shapes = {
        "wte": (V, C),
        "wpe": (T, C),
        "ln1w": (L, C), "ln1b": (L, C),
        "qkvw": (L, cfg.qkv_dim, C), "qkvb": (L, cfg.qkv_dim),
        "attprojw": (L, C, C), "attprojb": (L, C),
        "ln2w": (L, C), "ln2b": (L, C),
        "fcw": (L, 4 * C, C), "fcb": (L, 4 * C),
        "fcprojw": (L, C, 4 * C), "fcprojb": (L, C),
        "lnfw": (C,), "lnfb": (C,),
    }
    if cfg.num_experts:
        E = cfg.num_experts
        shapes.update({
            "fcw": (L, E, 4 * C, C), "fcb": (L, E, 4 * C),
            "fcprojw": (L, E, C, 4 * C), "fcprojb": (L, E, C),
            "routerw": (L, E, C),
        })
    if cfg.mode == "vit":
        P, IC, NC = cfg.patch_size, cfg.in_chans, cfg.num_classes
        shapes.update({
            "patchw": (C, P * P * IC),
            "patchb": (C,),
            "cls": (1, 1, C),
            "headw": (NC, C),
            "headb": (NC,),
        })
    return shapes


def tensor_order(cfg: ViTConfig) -> Tuple[str, ...]:
    return (CANONICAL_16 + (VIT_EXT if cfg.mode == "vit" else ())
            + (MOE_EXT if cfg.num_experts else ()))


def num_parameters(cfg: ViTConfig, core_only: bool = False) -> int:
    shapes = param_shapes(cfg)
    names = CANONICAL_16 if core_only else tensor_order(cfg)
    return int(sum(int(np.prod(shapes[n])) for n in names))


def init_params(cfg: ViTConfig, generator: torch.Generator,
                scheme: str = "production") -> Dict[str, torch.Tensor]:
    """Initialise the parameter dict on `generator.device`.

    Same schemes as the JAX package: "reference" = uniform [0, 0.02) weights;
    "production" = trunc-normal(0.02) clipped at ±2 std, with the residual
    projections scaled by 1/sqrt(2L).  LN scales are 1 and biases 0 in both.
    The numbers differ from jax.random's for the same seed; tests hand both
    packages the same numpy arrays through `from_numpy` instead."""
    if scheme not in ("production", "reference"):
        raise ValueError(f"unknown init scheme {scheme!r}")
    shapes = param_shapes(cfg)
    dtype = getattr(torch, cfg.param_dtype)
    device = generator.device
    params = {}
    for name in tensor_order(cfg):
        shp = shapes[name]
        if name in ("ln1w", "ln2w", "lnfw"):
            params[name] = torch.ones(shp, dtype=dtype, device=device)
        elif name.endswith("b") or name == "cls":
            params[name] = torch.zeros(shp, dtype=dtype, device=device)
        elif scheme == "reference":
            params[name] = torch.rand(shp, generator=generator, device=device,
                                      dtype=torch.float32).mul_(0.02).to(dtype)
        else:
            std = 0.02
            if name in ("attprojw", "fcprojw"):
                std = 0.02 / np.sqrt(2.0 * cfg.num_layers)
            t = torch.empty(shp, dtype=torch.float32, device=device)
            torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                        generator=generator)
            params[name] = t.to(dtype)
    return params


def from_numpy(np_params: Mapping[str, np.ndarray], cfg: ViTConfig,
               device="cpu", dtype: Optional[torch.dtype] = None
               ) -> Dict[str, torch.Tensor]:
    """The JAX package's parameters, as numpy arrays (`jax.device_get` of its
    pytree, or `checkpoint.load_checkpoint`), as a tensor dict on `device`.
    dtype defaults to cfg.param_dtype.  Shapes are checked against the
    canonical ones."""
    dtype = dtype or getattr(torch, cfg.param_dtype)
    shapes = param_shapes(cfg)
    out = {}
    for name in tensor_order(cfg):
        arr = np.asarray(np_params[name])
        if tuple(arr.shape) != shapes[name]:
            raise ValueError(f"{name}: shape {arr.shape}, expected "
                             f"{shapes[name]}")
        # np.array copies: the source may be a read-only view (jax arrays)
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32)).to(
            device=device, dtype=dtype)
    return out


def to_numpy(params: Mapping[str, torch.Tensor], cfg: ViTConfig
             ) -> Dict[str, np.ndarray]:
    """Inverse of `from_numpy`: f32 numpy arrays in canonical order."""
    return {name: params[name].detach().to("cpu", torch.float32).numpy()
            for name in tensor_order(cfg)}
