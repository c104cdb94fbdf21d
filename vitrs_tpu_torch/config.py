"""Model configuration — the port's copy of `vitrs_tpu/config.py`.

The fields, properties, validation and presets are copied unchanged, and
tests/test_torch_config_params.py pins every preset equal to the JAX
package's.  The copy exists because `import vitrs_tpu.config` runs
`vitrs_tpu/__init__.py`, which imports jax; this package never does.

Switches that only the JAX package acts on (use_flash, remat, scan_unroll)
are kept so that configs and checkpoints stay interchangeable; the port's
models raise NotImplementedError for the variants its slice does not cover
(models/model.check_supported).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    # --- the reference's five header fields (rusty_vit.rs:9-16) ---
    max_seq_len: int = 1024
    vocab_size: int = 50257
    num_layers: int = 12
    num_heads: int = 12
    channels: int = 768

    # --- grouped-query attention (beyond-reference: the reference is MHA-only,
    # rusty_vit.rs:512-563 always walks num_heads K/V heads) ---
    num_kv_heads: int = 0             # 0 = MHA (num_heads K/V heads);
                                      # k>0 = GQA with k K/V heads shared by
                                      # num_heads/k query heads each; 1 = MQA.
                                      # KV cache memory scales with this.

    # --- mixture-of-experts MLP (beyond-reference: the reference MLP is a
    # single dense fc/fcproj pair, rusty_vit.rs:112-117; ops/moe.py) ---
    num_experts: int = 0              # 0 = dense MLP; E>0 = E experts per
                                      # layer, fcw/fcb/fcprojw/fcprojb grow a
                                      # leading E axis and a routerw (L,E,C)
                                      # tensor appears
    moe_top_k: int = 2                # experts run per token
    moe_cap_factor: float = 1.25      # static per-expert capacity =
                                      # ceil(S·K/E · factor); overflow tokens
                                      # are dropped (Switch-style)
    moe_aux_weight: float = 0.01      # load-balance loss weight
    moe_zloss_weight: float = 1e-3    # router z-loss weight

    # --- vision front-end (the undefined-encoder seam, rusty_vit.rs:282) ---
    mode: str = "gpt"                 # "gpt" | "vit"
    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    num_classes: int = 1000
    pool: str = "cls"                 # "cls" | "mean"

    # --- numerics / implementation switches ---
    dtype: str = "float32"            # compute dtype for activations ("float32"|"bfloat16")
    param_dtype: str = "float32"      # storage dtype for params
    quirks: bool = False              # reproduce reference-as-written math (G5/G6/G11)
    use_flash: bool = True            # flash attention kernel (JAX: Pallas on TPU)
    remat: object = False             # activation checkpointing: False |
                                      # True = selective (save flash out+lse
                                      # + LN stats; recompute qkv/MLP only —
                                      # models/selective.py) | "full" =
                                      # blanket recompute incl. attention
    scan_unroll: int = 0              # 0 = fully unroll the layer scan (fastest
                                      # backward: no per-layer dynamic-update-slice
                                      # of the stacked grads); N>0 = unroll factor
    window: int = 0                   # sliding-window attention (gpt mode,
                                      # causal): query t attends keys in
                                      # (t-window, t].  0 = full attention.
                                      # Tiles outside the band are skipped in
                                      # the flash kernels fwd AND bwd, so
                                      # attention compute is O(T·window).
    pos_emb: str = "learned"          # positional scheme: "learned" (the
                                      # reference's wpe table, rusty_vit.rs:107)
                                      # | "rope" (rotary — relative positions,
                                      # no table read; ops/rope.py).  With
                                      # rope the wpe tensor stays in the
                                      # canonical layout but is unused.
    act: str = "gelu_tanh"            # MLP activation: "gelu_tanh" (the
                                      # reference's approximation,
                                      # rusty_vit.rs:614-623) | "gelu_erf"
                                      # (exact — what HF ViT checkpoints
                                      # were trained with; import_hf sets it)
    drop_rate: float = 0.0            # head dropout (train-time)
    drop_path: float = 0.0            # stochastic depth: per-layer residual-
                                      # branch drop, linearly 0..drop_path
                                      # over depth (the ViT-L regularizer)
    mask_ratio: float = 0.0           # MAE-style random patch masking (0 = off)
    label_smoothing: float = 0.0      # ViT supervised-training CE smoothing

    @property
    def head_size(self) -> int:
        assert self.channels % self.num_heads == 0
        return self.channels // self.num_heads

    @property
    def kv_heads(self) -> int:
        """Effective K/V head count (== num_heads for standard MHA)."""
        return self.num_kv_heads or self.num_heads

    @property
    def kv_dim(self) -> int:
        """Channels of ONE of K or V after the qkv projection."""
        return self.kv_heads * self.head_size

    @property
    def qkv_dim(self) -> int:
        """Output channels of the packed qkv projection: C + 2*kv_dim
        (== 3C for MHA — the reference layout, rusty_vit.rs:112)."""
        return self.channels + 2 * self.kv_dim

    @property
    def is_gqa(self) -> bool:
        return self.kv_heads != self.num_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def num_patches(self) -> int:
        assert self.img_size % self.patch_size == 0
        return (self.img_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        """Token count actually processed per example."""
        if self.mode == "vit":
            return self.num_patches + (1 if self.pool == "cls" else 0)
        return self.max_seq_len

    def validate(self) -> "ViTConfig":
        assert self.mode in ("gpt", "vit"), self.mode
        assert self.pool in ("cls", "mean"), self.pool
        assert self.act in ("gelu_tanh", "gelu_erf"), self.act
        # tri-state knob: False = off, True = selective policy, "full" =
        # blanket recompute — anything else (a typo'd string is truthy)
        # would silently select the selective path
        assert self.remat in (False, True, "full"), self.remat
        assert self.channels % self.num_heads == 0
        if self.num_kv_heads:
            assert self.num_heads % self.num_kv_heads == 0, (
                f"num_heads {self.num_heads} must be a multiple of "
                f"num_kv_heads {self.num_kv_heads}")
            assert not self.quirks, "quirks mode is MHA-only (reference parity)"
        if self.window:
            assert self.mode == "gpt", "window attention is causal-only"
            assert not self.quirks, "quirks mode uses full attention"
            assert self.window > 0
        if self.num_experts:
            assert not self.quirks, "quirks mode is dense-MLP-only"
            assert 1 <= self.moe_top_k <= self.num_experts, (
                self.moe_top_k, self.num_experts)
            assert self.moe_cap_factor > 0.0
        assert self.pos_emb in ("learned", "rope"), self.pos_emb
        if self.pos_emb == "rope":
            assert self.mode == "gpt", "rope is a gpt-mode option"
            assert not self.quirks, "quirks mode uses the reference's wpe"
            assert self.head_size % 2 == 0, "rope needs an even head_size"
        if self.mode == "vit":
            assert self.img_size % self.patch_size == 0
            assert self.seq_len <= self.max_seq_len, (
                f"seq_len {self.seq_len} > max_seq_len {self.max_seq_len}")
        return self

    def replace(self, **kw) -> "ViTConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Named presets, matching BASELINE.json configs.
# ---------------------------------------------------------------------------

def _vit(depth, heads, width, patch, img, classes, **kw) -> ViTConfig:
    n_tok = (img // patch) ** 2 + 1
    return ViTConfig(
        mode="vit", num_layers=depth, num_heads=heads, channels=width,
        patch_size=patch, img_size=img, num_classes=classes,
        # max_seq_len bounds the learned positional table (wpe analogue)
        max_seq_len=n_tok, vocab_size=classes, **kw,
    ).validate()


PRESETS = {
    # the reference test-suite config: GPT-2 124M (tests/vit_tests.rs:10-15)
    "gpt2-124m": ViTConfig().validate(),
    # the rest of the GPT-2 family (llm.c checkpoint-compatible geometries)
    "gpt2-350m": ViTConfig(num_layers=24, num_heads=16,
                           channels=1024).validate(),
    "gpt2-774m": ViTConfig(num_layers=36, num_heads=20,
                           channels=1280).validate(),
    "gpt2-1558m": ViTConfig(num_layers=48, num_heads=25,
                            channels=1600).validate(),
    # long-context GPT-2: wpe sized to 4096 (the reference's cap is
    # wpe = max_seq_len, rusty_vit.rs:107 — same table, 4x the length);
    # selective remat recommended at this activation footprint
    "gpt2-124m-4k": ViTConfig(max_seq_len=4096, remat=True).validate(),
    # sparse-MLP GPT-2: 124M geometry, 8 experts/layer, top-2 routing —
    # ~520M params at ~2x the dense per-token MLP FLOPs (ops/moe.py)
    "gpt2-moe-8e": ViTConfig(num_experts=8).validate(),
    # tiny GPT config for parity/gradient tests
    "gpt-nano": ViTConfig(max_seq_len=16, vocab_size=97, num_layers=2,
                          num_heads=2, channels=16).validate(),
    # BASELINE.json configs[0..4]
    "vit-tiny-4-cifar10": _vit(12, 3, 192, 4, 32, 10),
    "vit-s-16": _vit(12, 6, 384, 16, 224, 1000),
    "vit-b-16": _vit(12, 12, 768, 16, 224, 1000),
    "vit-l-16": _vit(24, 16, 1024, 16, 224, 1000),
    "clip-l-14": _vit(24, 16, 1024, 14, 224, 768),   # CLIP image tower: projects to embed dim
}


def get_config(name: str, **overrides) -> ViTConfig:
    cfg = PRESETS[name]
    return cfg.replace(**overrides).validate() if overrides else cfg
