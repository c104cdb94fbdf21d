"""Model FLOPs accounting for MFU: a frozen copy of the port's
`vitrs_tpu_torch/utils/flops.py` (itself a copy of the JAX package's), kept
here so that no later change to the program moves the benchmark's
yardstick.

Conventions (PERF.md section 2): a token's forward is 2 FLOPs per
multiply-accumulate of every matmul (qkv, proj, fc, fcproj; the tied vocab
head in gpt mode, the patch embedding and the classifier in vit mode), plus
4 T C per token and layer for QK^T and PV with the full T x T square
counted under a causal mask (the llm.c / PaLM convention); training is 3x
the forward.  The functions read the attributes of any config object with
the port's field names (`portbench.shape.Shape`); nothing of the program is
imported.  The peaks live in `portbench/yardstick/peaks.py`.
"""

from __future__ import annotations


def forward_flops_per_example(cfg) -> float:
    """Matmul FLOPs for one example's forward pass (2·MACs)."""
    C, L = cfg.channels, cfg.num_layers
    T = cfg.seq_len
    # qkv (C+2*kv_dim wide under GQA; 3C for MHA), proj, fc, fcproj.
    # MoE: each token runs top_k expert MLPs plus the (C, E) router (the
    # sparse-MFU convention counts only executed FLOPs)
    mlp_mult = cfg.moe_top_k if cfg.is_moe else 1
    router = 2 * C * cfg.num_experts if cfg.is_moe else 0
    per_tok_layer = 2 * (cfg.qkv_dim * C + C * C
                         + mlp_mult * (4 * C * C + 4 * C * C)) + router
    # QK^T + PV: 2 matmuls x 2 flops; the full T x T square under causal,
    # the T x window band under a window
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


def train_flops_per_example(cfg) -> float:
    """fwd + bwd ≈ 3x forward (backward re-does each matmul twice)."""
    return 3.0 * forward_flops_per_example(cfg)
