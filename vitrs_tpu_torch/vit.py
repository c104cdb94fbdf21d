"""The flat model API — the port of `vitrs_tpu/vit.py`, inference half.

    build_from_checkpoint / from_config
    forward(inputs)            -> -1.0, logits in .logits (inference mode)
    save_checkpoint(path)

forward with targets, backward and optimizer_step come with the
training slice (ROADMAP.md Queue 1 item 6) and raise NotImplementedError
until then.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from . import checkpoint as ckpt_io
from . import params as P
from .config import ViTConfig, get_config
from .models import model as M

_TRAINING = "training: ROADMAP.md Queue 1 item 6 (ops/optimizer.py + vit.py)"


class ViT:
    def __init__(self, cfg: ViTConfig, params: Mapping[str, torch.Tensor],
                 step: int = 0, seed: int = 0):
        self.config = cfg.validate()
        self.params = {k: v.detach() for k, v in params.items()}
        # the forward's weights, cast once to the compute dtype
        self._compute = M.prepare_params(self.params, self.config)
        self.device = self.params["wte"].device
        self.num_parameters = P.num_parameters(cfg)
        self.step = step
        self.seed = seed
        self.mean_loss = -1.0
        self.logits: Optional[torch.Tensor] = None

    @classmethod
    def from_config(cls, cfg_or_name, seed: int = 0,
                    scheme: str = "production", device="cpu",
                    **overrides) -> "ViT":
        """Random init from `seed`, drawn on the CPU so that every device
        gets the same weights, then moved to `device`."""
        cfg = (get_config(cfg_or_name, **overrides)
               if isinstance(cfg_or_name, str)
               else cfg_or_name.replace(**overrides))
        params = P.init_params(cfg, torch.Generator().manual_seed(seed),
                               scheme=scheme)
        return cls(cfg, {k: v.to(device) for k, v in params.items()},
                   seed=seed)

    @classmethod
    def build_from_checkpoint(cls, path: str, device="cpu",
                              **overrides) -> "ViT":
        """The file header is the config's source of truth; overrides may
        change implementation switches such as dtype."""
        np_params, cfg, extras = ckpt_io.load_checkpoint(path)
        if overrides:
            cfg = cfg.replace(**overrides).validate()
        return cls(cfg, P.from_numpy(np_params, cfg, device),
                   step=extras["step"], seed=extras["seed"])

    def forward(self, inputs, targets=None) -> float:
        """Inference mode: fills self.logits (B, T, V) and returns -1.0, the
        reference's no-target sentinel (rusty_vit.rs:348-350)."""
        if targets is not None:
            raise NotImplementedError(f"forward with targets: {_TRAINING}")
        tokens = torch.as_tensor(inputs, dtype=torch.long, device=self.device)
        self.logits = M.gpt_forward(self._compute, tokens, self.config)
        self.mean_loss = -1.0
        return self.mean_loss

    def backward(self):
        raise NotImplementedError(f"backward: {_TRAINING}")

    def optimizer_step(self, lr: float, optimizer: str = "adamw",
                       weight_decay: float = 0.0):
        raise NotImplementedError(f"optimizer_step: {_TRAINING}")

    def save_checkpoint(self, path: str):
        """Parameters only (no optimizer state: none exists yet)."""
        ckpt_io.save_checkpoint(path, self.params, self.config,
                                step=self.step, seed=self.seed)
