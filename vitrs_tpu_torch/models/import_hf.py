"""HuggingFace GPT-2 and ViT weight import into the canonical layout — the
port's copy of `vitrs_tpu/models/import_hf.py`.  The converters are numpy
on a state dict and carry over as they are; their output goes to a tensor
dict through `params.from_numpy`.  `load_gpt2` / `load_vit` import
`transformers` inside the function (the port does not need it otherwise)
and read local files only (`local_files_only=True`): nothing is fetched.

The reference's checkpoint loader expects llm.c's GPT-2 export (SURVEY.md
§2.6); this converter produces the same canonical tensors directly from a
`transformers` GPT-2 model, giving (a) a path for users with HF checkpoints
and (b) an independent cross-framework parity oracle: tests instantiate a
randomly-initialized torch GPT-2, convert, and require the port's forward
to match its logits.

Layout notes: HF GPT-2 stores its projection weights as Conv1D — (C_in,
C_out) — while the canonical layout is (OC, C) row-major consumed as
y = x·Wᵀ (rusty_vit.rs:484-498), so every matmul weight transposes on the way
in.  Ordering of the packed qkv channels (Q|K|V thirds) is identical.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..config import ViTConfig


def convert_gpt2_state_dict(sd: Dict[str, "np.ndarray"], cfg: ViTConfig
                            ) -> Dict[str, np.ndarray]:
    """torch state_dict (or {name: ndarray}) -> canonical params pytree."""
    def get(name):
        t = sd[name]
        return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach")
                          else t, np.float32)

    L = cfg.num_layers
    out = {
        "wte": get("transformer.wte.weight"),
        "wpe": get("transformer.wpe.weight"),
        "lnfw": get("transformer.ln_f.weight"),
        "lnfb": get("transformer.ln_f.bias"),
    }
    stack = {k: [] for k in ("ln1w", "ln1b", "qkvw", "qkvb", "attprojw",
                             "attprojb", "ln2w", "ln2b", "fcw", "fcb",
                             "fcprojw", "fcprojb")}
    for l in range(L):
        p = f"transformer.h.{l}."
        stack["ln1w"].append(get(p + "ln_1.weight"))
        stack["ln1b"].append(get(p + "ln_1.bias"))
        stack["qkvw"].append(get(p + "attn.c_attn.weight").T)     # (3C,C)
        stack["qkvb"].append(get(p + "attn.c_attn.bias"))
        stack["attprojw"].append(get(p + "attn.c_proj.weight").T)  # (C,C)
        stack["attprojb"].append(get(p + "attn.c_proj.bias"))
        stack["ln2w"].append(get(p + "ln_2.weight"))
        stack["ln2b"].append(get(p + "ln_2.bias"))
        stack["fcw"].append(get(p + "mlp.c_fc.weight").T)          # (4C,C)
        stack["fcb"].append(get(p + "mlp.c_fc.bias"))
        stack["fcprojw"].append(get(p + "mlp.c_proj.weight").T)    # (C,4C)
        stack["fcprojb"].append(get(p + "mlp.c_proj.bias"))
    for k, v in stack.items():
        out[k] = np.stack(v)
    # geometry sanity
    assert out["wte"].shape == (cfg.vocab_size, cfg.channels), out["wte"].shape
    assert out["qkvw"].shape == (L, 3 * cfg.channels, cfg.channels)
    return out


def export_gpt2_state_dict(params: Dict[str, np.ndarray], cfg: ViTConfig
                           ) -> Dict[str, np.ndarray]:
    """Canonical params pytree -> HF GPT-2 state_dict arrays — the exact
    inverse of convert_gpt2_state_dict (pinned by a round-trip test), so a
    model trained here can load into `transformers.GPT2LMHeadModel` via
    `model.load_state_dict({k: torch.from_numpy(v) ...})`.

    The Conv1D transposes reverse ((OC, C) -> (C_in, C_out)), the weight-tied
    head is emitted as `lm_head.weight` sharing wte's values (HF ties them
    on load), and the stacked-L slabs unstack to per-layer entries."""
    assert cfg.mode == "gpt" and not cfg.is_gqa, (
        "HF GPT-2 export is the MHA gpt layout")
    g = lambda k: np.asarray(params[k], np.float32)
    sd = {
        "transformer.wte.weight": g("wte"),
        "transformer.wpe.weight": g("wpe"),
        "transformer.ln_f.weight": g("lnfw"),
        "transformer.ln_f.bias": g("lnfb"),
        "lm_head.weight": g("wte"),
    }
    for l in range(cfg.num_layers):
        p = f"transformer.h.{l}."
        sd[p + "ln_1.weight"] = g("ln1w")[l]
        sd[p + "ln_1.bias"] = g("ln1b")[l]
        sd[p + "attn.c_attn.weight"] = g("qkvw")[l].T        # (C, 3C)
        sd[p + "attn.c_attn.bias"] = g("qkvb")[l]
        sd[p + "attn.c_proj.weight"] = g("attprojw")[l].T    # (C, C)
        sd[p + "attn.c_proj.bias"] = g("attprojb")[l]
        sd[p + "ln_2.weight"] = g("ln2w")[l]
        sd[p + "ln_2.bias"] = g("ln2b")[l]
        sd[p + "mlp.c_fc.weight"] = g("fcw")[l].T            # (C, 4C)
        sd[p + "mlp.c_fc.bias"] = g("fcb")[l]
        sd[p + "mlp.c_proj.weight"] = g("fcprojw")[l].T      # (4C, C)
        sd[p + "mlp.c_proj.bias"] = g("fcprojb")[l]
    return sd


def config_from_hf(hf_config) -> ViTConfig:
    return ViTConfig(
        max_seq_len=hf_config.n_positions,
        vocab_size=hf_config.vocab_size,
        num_layers=hf_config.n_layer,
        num_heads=hf_config.n_head,
        channels=hf_config.n_embd,
        mode="gpt",
    ).validate()


def convert_vit_state_dict(sd: Dict[str, "np.ndarray"], cfg: ViTConfig
                           ) -> Dict[str, np.ndarray]:
    """HF `ViTForImageClassification` state_dict -> canonical params pytree.

    Closes the 'pretrained weights' seam of BASELINE.json configs[1]: the
    reference's checkpoint contract (train_vit.rs:89-186) generalized to the
    HF ViT family the same way load_gpt2 generalizes it for GPT-2.

    Layout notes:
      * HF's patch embed is a Conv2d with weight (C, IC, P, P), NCHW; our
        patchw is the (C, P·P·IC) matmul form consumed against
        basic.patchify's (P_row, P_col, chan)-flattened patch vectors — so
        the conv kernel transposes to (C, P, P, IC) then flattens.
      * q/k/v are three separate torch Linears, already (OC, C) row-major;
        the packed qkvw is their axis-0 concatenation (head split order is
        identical: leading D-blocks per head).
      * position_embeddings is (1, N+1, C) with row 0 the CLS position —
        exactly our wpe semantics (vit_encode adds wpe[0] to cls).
      * wte exists in the canonical order but is unused in vit mode
        (vocab head is the vit `headw`); zero-filled.
      * HF ViT was trained with exact erf-GELU — config_from_hf_vit sets
        cfg.act="gelu_erf" so the imported forward matches torch.  (HF's
        layer_norm_eps default 1e-12 vs our reference-pinned 1e-5 remains;
        relative effect ~eps/(2σ²) ≈ 5e-6, below bf16 resolution.)
    """
    def get(name):
        t = sd[name]
        return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach")
                          else t, np.float32)

    L, C = cfg.num_layers, cfg.channels
    P, IC = cfg.patch_size, cfg.in_chans
    conv = get("vit.embeddings.patch_embeddings.projection.weight")
    assert conv.shape == (C, IC, P, P), conv.shape
    out = {
        "patchw": conv.transpose(0, 2, 3, 1).reshape(C, P * P * IC),
        "patchb": get("vit.embeddings.patch_embeddings.projection.bias"),
        "cls": get("vit.embeddings.cls_token"),
        "wpe": get("vit.embeddings.position_embeddings")[0],
        "wte": np.zeros((cfg.vocab_size, C), np.float32),
        "lnfw": get("vit.layernorm.weight"),
        "lnfb": get("vit.layernorm.bias"),
        "headw": get("classifier.weight"),
        "headb": get("classifier.bias"),
    }
    stack = {k: [] for k in ("ln1w", "ln1b", "qkvw", "qkvb", "attprojw",
                             "attprojb", "ln2w", "ln2b", "fcw", "fcb",
                             "fcprojw", "fcprojb")}
    for l in range(L):
        p = f"vit.encoder.layer.{l}."
        a = p + "attention.attention."
        stack["ln1w"].append(get(p + "layernorm_before.weight"))
        stack["ln1b"].append(get(p + "layernorm_before.bias"))
        stack["qkvw"].append(np.concatenate(
            [get(a + "query.weight"), get(a + "key.weight"),
             get(a + "value.weight")], axis=0))                    # (3C, C)
        stack["qkvb"].append(np.concatenate(
            [get(a + "query.bias"), get(a + "key.bias"),
             get(a + "value.bias")]))
        stack["attprojw"].append(get(p + "attention.output.dense.weight"))
        stack["attprojb"].append(get(p + "attention.output.dense.bias"))
        stack["ln2w"].append(get(p + "layernorm_after.weight"))
        stack["ln2b"].append(get(p + "layernorm_after.bias"))
        stack["fcw"].append(get(p + "intermediate.dense.weight"))   # (4C, C)
        stack["fcb"].append(get(p + "intermediate.dense.bias"))
        stack["fcprojw"].append(get(p + "output.dense.weight"))     # (C, 4C)
        stack["fcprojb"].append(get(p + "output.dense.bias"))
    for k, v in stack.items():
        out[k] = np.stack(v)
    assert out["qkvw"].shape == (L, 3 * C, C)
    assert out["wpe"].shape == (cfg.num_patches + 1, C), out["wpe"].shape
    return out


def export_vit_state_dict(params: Dict[str, np.ndarray], cfg: ViTConfig
                          ) -> Dict[str, np.ndarray]:
    """Canonical vit params -> HF `ViTForImageClassification` state_dict —
    the inverse of convert_vit_state_dict (round-trip pinned in tests).
    The (C, P·P·IC) patch matmul reshapes back to the NCHW Conv2d kernel,
    the packed qkv splits into the three torch Linears, and the unused
    gpt-layout wte is simply not emitted."""
    assert cfg.mode == "vit" and cfg.pool == "cls"
    g = lambda k: np.asarray(params[k], np.float32)
    L, C = cfg.num_layers, cfg.channels
    P, IC = cfg.patch_size, cfg.in_chans
    sd = {
        "vit.embeddings.patch_embeddings.projection.weight":
            g("patchw").reshape(C, P, P, IC).transpose(0, 3, 1, 2),
        "vit.embeddings.patch_embeddings.projection.bias": g("patchb"),
        "vit.embeddings.cls_token": g("cls"),
        "vit.embeddings.position_embeddings": g("wpe")[None],
        "vit.layernorm.weight": g("lnfw"),
        "vit.layernorm.bias": g("lnfb"),
        "classifier.weight": g("headw"),
        "classifier.bias": g("headb"),
    }
    for l in range(L):
        p = f"vit.encoder.layer.{l}."
        a = p + "attention.attention."
        qkvw, qkvb = g("qkvw")[l], g("qkvb")[l]
        sd[a + "query.weight"] = qkvw[:C]
        sd[a + "key.weight"] = qkvw[C:2 * C]
        sd[a + "value.weight"] = qkvw[2 * C:]
        sd[a + "query.bias"] = qkvb[:C]
        sd[a + "key.bias"] = qkvb[C:2 * C]
        sd[a + "value.bias"] = qkvb[2 * C:]
        sd[p + "layernorm_before.weight"] = g("ln1w")[l]
        sd[p + "layernorm_before.bias"] = g("ln1b")[l]
        sd[p + "attention.output.dense.weight"] = g("attprojw")[l]
        sd[p + "attention.output.dense.bias"] = g("attprojb")[l]
        sd[p + "layernorm_after.weight"] = g("ln2w")[l]
        sd[p + "layernorm_after.bias"] = g("ln2b")[l]
        sd[p + "intermediate.dense.weight"] = g("fcw")[l]
        sd[p + "intermediate.dense.bias"] = g("fcb")[l]
        sd[p + "output.dense.weight"] = g("fcprojw")[l]
        sd[p + "output.dense.bias"] = g("fcprojb")[l]
    return sd


def config_from_hf_vit(hf_config) -> ViTConfig:
    assert hf_config.intermediate_size == 4 * hf_config.hidden_size, (
        "canonical layout pins the 4C MLP (rusty_vit.rs:117-120)")
    n_tok = (hf_config.image_size // hf_config.patch_size) ** 2 + 1
    num_classes = int(hf_config.num_labels)
    return ViTConfig(
        mode="vit",
        img_size=hf_config.image_size,
        patch_size=hf_config.patch_size,
        in_chans=hf_config.num_channels,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        channels=hf_config.hidden_size,
        num_classes=num_classes,
        pool="cls",
        max_seq_len=n_tok,
        vocab_size=num_classes,
        act="gelu_erf" if hf_config.hidden_act == "gelu" else "gelu_tanh",
    ).validate()


def load_vit(model_name_or_path: str = "google/vit-base-patch16-224"):
    """Load a HF ViT classifier from a local directory or the local cache
    (nothing is fetched) and convert.  Returns (numpy params, config)."""
    from transformers import ViTForImageClassification
    model = ViTForImageClassification.from_pretrained(model_name_or_path,
                                                      local_files_only=True)
    cfg = config_from_hf_vit(model.config)
    return convert_vit_state_dict(model.state_dict(), cfg), cfg


def load_gpt2(model_name_or_path: str = "gpt2"):
    """Load a HF GPT-2 from a local directory or the local cache (nothing
    is fetched) and convert.  Returns (numpy params, config)."""
    from transformers import GPT2LMHeadModel
    model = GPT2LMHeadModel.from_pretrained(model_name_or_path,
                                            local_files_only=True)
    cfg = config_from_hf(model.config)
    return convert_gpt2_state_dict(model.state_dict(), cfg), cfg
