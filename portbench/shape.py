"""The benchmark's own view of a model configuration: the sizes in a
`portbench/configs/<name>.json` file's "shape", under the port's field
names, so that the yardstick and the reference read them without the
program.  The harness checks them against the config the program builds
from the file's preset (`harness.program_config`)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Shape:
    mode: str                  # "gpt" | "vit"
    num_layers: int
    channels: int
    num_heads: int
    max_seq_len: int
    vocab_size: int = 0        # gpt: the token vocabulary
    mlp_ratio: int = 4
    act: str = "gelu_tanh"     # "gelu_tanh" | "gelu_erf"
    ln_eps: float = 1e-5
    img_size: int = 0          # vit
    patch_size: int = 0
    in_chans: int = 3
    num_classes: int = 0
    dtype: str = "bfloat16"    # compute; the masters are fp32
    # fields the yardstick reads that these configurations do not use
    num_kv_heads: int = 0
    num_experts: int = 0
    moe_top_k: int = 2
    window: int = 0

    @property
    def head_size(self) -> int:
        return self.channels // self.num_heads

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def qkv_dim(self) -> int:
        return self.channels + 2 * self.kv_heads * self.head_size

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1 if self.mode == "vit" else self.max_seq_len

    def replace(self, **kw) -> "Shape":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_config(cls, conf: dict) -> "Shape":
        return cls(dtype=conf["dtype"], **conf["shape"])
