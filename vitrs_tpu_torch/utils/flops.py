"""Model FLOPs accounting for MFU reporting — a copy of
`vitrs_tpu/utils/flops.py` (forward 2PD + backward 4PD per token plus
explicit attention terms), with an H100 entry.  Unlike the JAX package's
`peak_flops`, which falls back to the v5e peak for a device kind it does
not know (ROADMAP.md Queue 3 #3), an unknown kind raises here."""

from __future__ import annotations

from ..config import ViTConfig

# per-device peak dense-matmul throughput, FLOP/s.  "h100": NVIDIA's H100
# SXM datasheet, dense (no sparsity), 989 TFLOP/s bf16 and 67 TFLOP/s fp32
# outside the tensor cores (TF32 is off in the port), at the 700 W limit.
# The TPU rows are the JAX package's; its placeholder "cpu" row is left
# out, so no MFU is claimed for a CPU run.
PEAK_FLOPS = {
    "nvidia h100": {"bfloat16": 989e12, "float32": 67e12},
    "tpu v5e": {"bfloat16": 197e12, "float32": 49e12},
    "tpu v5p": {"bfloat16": 459e12, "float32": 115e12},
}


def peak_flops(device_kind: str, dtype: str) -> float:
    """The peak of the first PEAK_FLOPS entry whose last word is in
    device_kind (e.g. "NVIDIA H100 80GB HBM3" -> "h100"); raises ValueError
    for a kind none names."""
    kind = device_kind.lower()
    for key, tbl in PEAK_FLOPS.items():
        if key.split()[-1] in kind:
            return tbl.get(dtype, tbl["float32"])
    raise ValueError(f"no peak FLOP/s known for device kind {device_kind!r}; "
                     f"add it to PEAK_FLOPS with its source")


def forward_flops_per_example(cfg: ViTConfig) -> float:
    """Matmul FLOPs for one example's forward pass (2·MACs)."""
    C, L = cfg.channels, cfg.num_layers
    T = cfg.seq_len
    # qkv (C+2*kv_dim wide under GQA; 3C for MHA), proj, fc, fcproj.
    # MoE: each token runs top_k expert MLPs plus the (C, E) router —
    # the standard sparse-MFU convention counts only EXECUTED FLOPs
    # (dropped assignments still occupy their dispatch slot, so this is
    # the ceiling of useful work, matching Switch/GShard reporting)
    mlp_mult = cfg.moe_top_k if cfg.is_moe else 1
    router = 2 * C * cfg.num_experts if cfg.is_moe else 0
    per_tok_layer = 2 * (cfg.qkv_dim * C + C * C
                         + mlp_mult * (4 * C * C + 4 * C * C)) + router
    # QK^T + PV: 2 matmuls x 2 flops.  Convention: the full T x T square is
    # counted for causal (the standard MFU convention — llm.c/PaLM count
    # unmasked FLOPs); the windowed analogue is the full T x window band, so
    # windowed MFU stays comparable to the causal numbers.
    attn_width = min(cfg.window, T) if (cfg.mode == "gpt" and cfg.window) \
        else T
    attn_layer = 4 * T * attn_width * C
    if cfg.mode == "vit":
        embed = 2 * T * (cfg.patch_size ** 2 * cfg.in_chans) * C
        head = 2 * C * cfg.num_classes
    else:
        embed = 0                          # table lookup
        head = 2 * T * C * cfg.vocab_size  # tied vocab projection
    return T * per_tok_layer * L + attn_layer * L + embed + head


def train_flops_per_example(cfg: ViTConfig) -> float:
    """fwd + bwd ≈ 3x forward (backward re-does each matmul twice)."""
    return 3.0 * forward_flops_per_example(cfg)


def mfu(examples_per_sec: float, cfg: ViTConfig, device_kind: str,
        n_chips: int = 1, train: bool = True) -> float:
    f = train_flops_per_example(cfg) if train else forward_flops_per_example(cfg)
    achieved = examples_per_sec * f
    return achieved / (peak_flops(device_kind, cfg.dtype) * n_chips)
