"""Parameter memory model — the port of `vitrs_tpu/params.py`.

The 16 reference tensors keep their canonical order and shapes (they define
the checkpoint payload), per-layer tensors stay stacked on a leading L axis,
and matmul weights stay in (OC, C) form used as y = x @ W.T + b.  So a
parameter dict of this package holds the same arrays, under the same names,
as the JAX package's pytree, and `from_numpy` / `to_numpy` carry one into the
other.

`flatten_params` / `unflatten_params` map a parameter dict to the flat fp32
vector in canonical order (the reference's params arena) and back.  Where
the JAX package copies, `unflatten_params` returns views into the flat
vector: a trainer keeps its parameters (and gradients) as such views, so
that the fused AdamW runs once over the whole vector with no copy;
`flat_base` finds that vector again from the dict.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .config import ViTConfig
from .ops._build import resolve_device

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


def _tensor(arr, name, shape, device, dtype):
    arr = np.asarray(arr)
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {arr.shape}, expected {shape}")
    # np.array copies: the source may be a read-only view (jax arrays)
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(
        device=device, dtype=dtype)


def _is_lora(tree: Mapping) -> bool:
    from .models.lora import LORA_TARGETS
    return bool(tree) and all(k[:-2] in LORA_TARGETS and k[-2:] in ("_a", "_b")
                              for k in tree)


def from_numpy(np_params: Mapping[str, np.ndarray], cfg: ViTConfig,
               device="cuda", dtype: Optional[torch.dtype] = None
               ) -> Dict[str, torch.Tensor]:
    """The JAX package's parameters, as numpy arrays (`jax.device_get` of its
    pytree, or `checkpoint.load_checkpoint`), as a tensor dict on `device`:
    the card unless the caller asks for the CPU (raises when torch sees no
    CUDA device).  dtype defaults to cfg.param_dtype.  Shapes are checked
    against the canonical ones.

    Besides the canonical dict (and CLIP's fp32 `logit_scale` beside it),
    it carries the JAX package's other trees: the MAE tree {"encoder",
    "decoder"} (the decoder's shapes from its own width and depth,
    models/mae.py) and a LoRA adapter tree ({target + "_a", target + "_b"},
    fp32, models/lora.py).

    The JAX package's `ops/quant.quantize_params` output is taken too: a
    tensor with a `<name>_scale` companion must be int8 and stays
    torch.int8, its scale (the tensor's shape without the last axis) fp32,
    which is the dict `vitrs_tpu_torch.ops.quant.quantize_params` makes."""
    device = resolve_device(device)
    dtype = dtype or getattr(torch, cfg.param_dtype)
    if "encoder" in np_params and "decoder" in np_params:
        from .models import mae
        dec = np_params["decoder"]
        shapes = mae.decoder_shapes(cfg, mae._infer_decoder_config(cfg, dec))
        return {"encoder": from_numpy(np_params["encoder"], cfg, device,
                                      dtype),
                "decoder": {k: _tensor(dec[k], k, shp, device, dtype)
                            for k, shp in shapes.items()}}
    if _is_lora(np_params):
        shapes = param_shapes(cfg)
        out = {}
        for k in sorted(np_params):
            L, OC, IC = shapes[k[:-2]]
            r = np.shape(np_params[k])[1 if k.endswith("_a") else 2]
            shp = (L, r, IC) if k.endswith("_a") else (L, OC, r)
            out[k] = _tensor(np_params[k], k, shp, device, torch.float32)
        return out
    shapes = param_shapes(cfg)
    out = {}
    for name in tensor_order(cfg):
        arr = np.asarray(np_params[name])
        scale = np_params.get(name + "_scale")
        if scale is None:
            out[name] = _tensor(arr, name, shapes[name], device, dtype)
            continue
        if tuple(arr.shape) != shapes[name]:
            raise ValueError(f"{name}: shape {arr.shape}, expected "
                             f"{shapes[name]}")
        scale = np.asarray(scale)
        if arr.dtype != np.int8 or scale.shape != shapes[name][:-1]:
            raise ValueError(f"{name}: a quantized weight is int8 with a "
                             f"scale of shape {shapes[name][:-1]}, got "
                             f"{arr.dtype} and {scale.shape}")
        out[name] = torch.from_numpy(np.array(arr)).to(device)
        out[name + "_scale"] = torch.from_numpy(
            np.array(scale, dtype=np.float32)).to(device)
    if "logit_scale" in np_params:
        out["logit_scale"] = _tensor(np_params["logit_scale"], "logit_scale",
                                     (), device, torch.float32)
    return out


def to_numpy(params: Mapping[str, torch.Tensor], cfg: ViTConfig
             ) -> Dict[str, np.ndarray]:
    """Inverse of `from_numpy`: f32 numpy arrays, in canonical order for a
    parameter dict (+ logit_scale), the MAE tree nested, a LoRA tree by
    name."""
    def host(t):
        return t.detach().to("cpu", torch.float32).numpy()

    if "encoder" in params and "decoder" in params:
        return {"encoder": to_numpy(params["encoder"], cfg),
                "decoder": {k: host(t) for k, t in params["decoder"].items()}}
    if _is_lora(params):
        return {k: host(t) for k, t in params.items()}
    names = tensor_order(cfg) + (("logit_scale",) if "logit_scale" in params
                                 else ())
    return {name: host(params[name]) for name in names}


def flatten_params(params: Mapping[str, torch.Tensor], cfg: ViTConfig
                   ) -> torch.Tensor:
    """A new flat 1-D fp32 tensor in canonical order, on the params' device."""
    return torch.cat([params[n].detach().to(torch.float32).reshape(-1)
                      for n in tensor_order(cfg)])


def unflatten_params(flat: torch.Tensor, cfg: ViTConfig
                     ) -> Dict[str, torch.Tensor]:
    """The parameter dict as views into `flat` (canonical order and shapes);
    copies instead where cfg.param_dtype is not flat's dtype."""
    shapes = param_shapes(cfg)
    dtype = getattr(torch, cfg.param_dtype)
    out, off = {}, 0
    for n in tensor_order(cfg):
        size = int(np.prod(shapes[n]))
        out[n] = flat[off:off + size].view(shapes[n]).to(dtype)
        off += size
    if off != flat.shape[0]:
        raise ValueError(f"flat vector of {flat.shape[0]} values, the config "
                         f"has {off} parameters")
    return out


def flat_base(params: Mapping[str, torch.Tensor], cfg: ViTConfig
              ) -> Optional[torch.Tensor]:
    """The flat fp32 vector that `params` are views into, in canonical order
    with nothing between them (as `unflatten_params` makes them), or None."""
    base = params[CANONICAL_16[0]]._base
    if (base is None or base.dim() != 1 or base.dtype != torch.float32
            or base.shape[0] != num_parameters(cfg) or not base.is_contiguous()):
        return None
    off = base.storage_offset()
    for n in tensor_order(cfg):
        t = params[n]
        if (t._base is not base or t.storage_offset() != off
                or not t.is_contiguous()):
            return None
        off += t.numel()
    return base
