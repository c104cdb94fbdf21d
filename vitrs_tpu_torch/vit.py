"""The flat model API — the port of `vitrs_tpu/vit.py` (gpt and vit mode).

Keeps the reference's five-call surface:
    build_from_checkpoint / from_config
    forward(inputs, targets) -> mean_loss
    backward()
    optimizer_step(lr)
    save_checkpoint / load_checkpoint
plus `train_step`, forward + backward + AdamW in one call.

Inputs are token ids (B, T) in gpt mode, images (B, H, W, C) with integer
labels in vit mode.  Semantics kept from the reference, as in the JAX
package:
  * forward with no targets is inference mode and returns mean_loss = -1.0;
  * grads accumulate with += across backward() calls and are cleared with
    zero_grad() between steps;
  * optimizer state m/v mirrors the parameter dict in fp32; a checkpoint
    holds it as the flat vectors of num_parameters floats;
  * a tensor the loss does not read gets exact zero gradients (wpe under
    rope; wte in vit mode), as under jax.grad.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from . import checkpoint as ckpt_io
from . import params as P
from .config import ViTConfig, get_config
from .models import model as M
from .ops import optimizer as opt
from .ops._build import resolve_device


class ViT:
    def __init__(self, cfg: ViTConfig, params: Mapping[str, torch.Tensor],
                 step: int = 0, seed: int = 0,
                 m: Optional[np.ndarray] = None,
                 v: Optional[np.ndarray] = None):
        self.config = cfg.validate()
        self.device = params["wte"].device
        self._set_params({k: p.detach() for k, p in params.items()})
        self.num_parameters = P.num_parameters(cfg)
        self.m = self._state(m)
        self.v = self._state(v)
        self.step = step
        self.seed = seed
        self.grads: Optional[Dict[str, torch.Tensor]] = None
        self.mean_loss = -1.0
        self.logits: Optional[torch.Tensor] = None
        self._inputs: Optional[torch.Tensor] = None
        self._targets: Optional[torch.Tensor] = None

    def _set_params(self, params: Dict[str, torch.Tensor]):
        self.params = params
        # the forward's weights, cast once to the compute dtype
        self._compute = M.prepare_params(params, self.config)

    def _state(self, flat) -> Dict[str, torch.Tensor]:
        """AdamW state as a dict mirroring params: zeros, or a flat vector
        from a checkpoint cut into tensors."""
        if flat is None:
            return {k: torch.zeros(p.shape, dtype=torch.float32,
                                   device=self.device)
                    for k, p in self.params.items()}
        flat = torch.as_tensor(np.asarray(flat, np.float32), device=self.device)
        return P.unflatten_params(flat, self.config)

    # -- construction -------------------------------------------------------

    @classmethod
    def from_config(cls, cfg_or_name, seed: int = 0,
                    scheme: str = "production", device="cuda",
                    **overrides) -> "ViT":
        """Random init from `seed`, drawn on the CPU so that every device
        gets the same weights, then moved to `device`: the card unless the
        caller asks for the CPU (raises when torch sees no CUDA device)."""
        device = resolve_device(device)
        cfg = (get_config(cfg_or_name, **overrides)
               if isinstance(cfg_or_name, str)
               else cfg_or_name.replace(**overrides))
        params = P.init_params(cfg, torch.Generator().manual_seed(seed),
                               scheme=scheme)
        return cls(cfg, {k: v.to(device) for k, v in params.items()},
                   seed=seed)

    @classmethod
    def build_from_checkpoint(cls, path: str, device="cuda",
                              **overrides) -> "ViT":
        """The file header is the config's source of truth; overrides may
        change implementation switches such as dtype.  The model lives on
        the card unless the caller asks for the CPU."""
        device = resolve_device(device)
        np_params, cfg, extras = ckpt_io.load_checkpoint(path)
        if overrides:
            cfg = cfg.replace(**overrides).validate()
        return cls(cfg, P.from_numpy(np_params, cfg, device),
                   step=extras["step"], seed=extras["seed"], m=extras["m"],
                   v=extras["v"])

    # -- the reference's five-call API ---------------------------------------

    def _tokens(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.long, device=self.device)

    def _model_inputs(self, x) -> torch.Tensor:
        """Token ids as int64 (gpt mode), images as fp32 (vit mode)."""
        if self.config.mode == "vit":
            return torch.as_tensor(x, dtype=torch.float32, device=self.device)
        return self._tokens(x)

    def forward(self, inputs, targets=None) -> float:
        """Fills self.logits ((B, T, V) in gpt mode, (B, num_classes) fp32
        in vit mode); returns the mean loss, or -1.0 in inference mode (no
        targets), the reference's sentinel (rusty_vit.rs:348-350).  Logits
        and loss come from one pass."""
        self._inputs = self._model_inputs(inputs)
        self._targets = None if targets is None else self._tokens(targets)
        with torch.no_grad():
            if targets is None:
                fwd = (M.vit_forward if self.config.mode == "vit"
                       else M.gpt_forward)
                self.logits = fwd(self._compute, self._inputs, self.config)
                self.mean_loss = -1.0
            else:
                self.logits, loss = M.forward_with_loss(
                    self._compute, self._inputs, self._targets, self.config)
                self.mean_loss = float(loss)
        return self.mean_loss

    def _loss_and_grads(self, inputs: torch.Tensor, targets: torch.Tensor):
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in self.params.items()}
        loss = M.loss_fn(leaves, inputs, targets, self.config)
        # a tensor the loss does not read (wpe under rope, wte in vit mode)
        # gets exact zeros
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        return loss.detach(), {k: torch.zeros_like(p) if g is None else g
                               for (k, p), g in zip(leaves.items(), grads)}

    def zero_grad(self):
        self.grads = None

    def backward(self) -> Dict[str, torch.Tensor]:
        """Gradients at the last forward's (inputs, targets), added += into
        self.grads like the reference's arena (zero_grad clears them)."""
        if self._targets is None:
            raise RuntimeError("backward requires a forward with targets")
        loss, grads = self._loss_and_grads(self._inputs, self._targets)
        self.mean_loss = float(loss)
        if self.grads is None:
            self.grads = grads
        else:
            self.grads = {k: self.grads[k] + g for k, g in grads.items()}
        return self.grads

    def optimizer_step(self, lr: float, optimizer: str = "adamw",
                       weight_decay: float = 0.0):
        """"sgd": the reference-as-written update over the flat arena
        (train_vit.rs:737-743); anything else: AdamW per tensor."""
        if self.grads is None:
            raise RuntimeError("call backward() first")
        cfg = self.config
        if optimizer == "sgd":
            flat_p = P.flatten_params(self.params, cfg)
            opt.sgd_step(flat_p, P.flatten_params(self.grads, cfg), lr)
            self._set_params(P.unflatten_params(flat_p, cfg))
        else:
            self.step += 1
            params, self.m, self.v = opt.adamw_tree(
                self.params, self.grads, self.m, self.v, self.step, lr,
                weight_decay=weight_decay)
            self._set_params(params)

    # -- forward + backward + update in one call -------------------------------

    def train_step(self, inputs, targets, lr: float,
                   weight_decay: float = 0.0) -> float:
        """forward + backward + AdamW; returns the loss before the update."""
        self.step += 1
        loss, grads = self._loss_and_grads(self._model_inputs(inputs),
                                           self._tokens(targets))
        params, self.m, self.v = opt.adamw_tree(
            self.params, grads, self.m, self.v, self.step, lr,
            weight_decay=weight_decay)
        self._set_params(params)
        self.mean_loss = float(loss)
        return self.mean_loss

    # -- checkpoint ------------------------------------------------------------

    def save_checkpoint(self, path: str, with_opt: bool = True,
                        cursor: int = 0):
        """Parameters, and the AdamW state as flat m/v unless with_opt is
        False."""
        cfg = self.config
        ckpt_io.save_checkpoint(
            path, self.params, cfg,
            m=P.flatten_params(self.m, cfg) if with_opt else None,
            v=P.flatten_params(self.v, cfg) if with_opt else None,
            step=self.step, seed=self.seed, cursor=cursor)

    def load_checkpoint(self, path: str):
        np_params, cfg, extras = ckpt_io.load_checkpoint(path, self.config)
        self._set_params(P.from_numpy(np_params, cfg, self.device))
        self.step = extras["step"]
        if extras["m"] is not None:
            self.m = self._state(extras["m"])
            self.v = self._state(extras["v"])
