"""PyTorch port: the HF import (models/import_hf.py) on the CPU.

The converters are numpy on a state dict: on the same state dict they give
the JAX package's arrays exactly, both ways and for both families.  The
port's forward on the converted weights matches a random `transformers`
GPT-2 and ViT (no download; skipped without `transformers`, as
tests/test_hf_parity.py is) within 2e-4, fp32; `load_gpt2` / `load_vit`
read a saved model from a local directory only.
"""

import os
import types

import numpy as np
import pytest
import torch

from vitrs_tpu.models import import_hf as JIH
from vitrs_tpu_torch import params as TP
from vitrs_tpu_torch.models import import_hf as TIH
from vitrs_tpu_torch.models import model as TM

from test_torch_helpers import jax_config, np_params, torch_config
from test_torch_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GPT = dict(num_layers=3, num_heads=4, channels=48, vocab_size=211,
           max_seq_len=32)
VIT = dict(num_layers=3, num_heads=4, channels=48, img_size=16,
           patch_size=4, num_classes=7, max_seq_len=17, vocab_size=7)


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


@pytest.mark.parametrize("family", ["gpt2", "vit"])
def test_converters_match_jax_both_ways(family):
    if family == "gpt2":
        tcfg = torch_config("gpt-nano").replace(**GPT)
        jcfg = jax_config("gpt-nano").replace(**GPT)
    else:
        tcfg = torch_config("vit-tiny-4-cifar10").replace(**VIT)
        jcfg = jax_config("vit-tiny-4-cifar10").replace(**VIT)
    arrs = np_params(tcfg, seed=1)
    sd_t = getattr(TIH, f"export_{family}_state_dict")(arrs, tcfg)
    sd_j = getattr(JIH, f"export_{family}_state_dict")(arrs, jcfg)
    _same(sd_t, sd_j)
    back_t = getattr(TIH, f"convert_{family}_state_dict")(sd_j, tcfg)
    _same(back_t, getattr(JIH, f"convert_{family}_state_dict")(sd_j, jcfg))
    keys = TP.tensor_order(tcfg) if family == "gpt2" else \
        [k for k in TP.tensor_order(tcfg) if k != "wte"]
    for k in keys:                              # the round trip is exact
        np.testing.assert_array_equal(back_t[k], arrs[k], err_msg=k)
    torch_sd = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd_j.items()}       # torch tensors in, too
    _same(getattr(TIH, f"convert_{family}_state_dict")(torch_sd, tcfg),
          back_t)


def test_configs_from_hf_match_jax():
    g = types.SimpleNamespace(n_positions=64, vocab_size=300, n_layer=2,
                              n_head=4, n_embd=64)
    assert TIH.config_from_hf(g).__dict__ == JIH.config_from_hf(g).__dict__
    v = types.SimpleNamespace(intermediate_size=256, hidden_size=64,
                              image_size=32, patch_size=8, num_labels=5,
                              num_channels=3, num_hidden_layers=2,
                              num_attention_heads=4, hidden_act="gelu")
    tv, jv = TIH.config_from_hf_vit(v), JIH.config_from_hf_vit(v)
    assert tv.__dict__ == jv.__dict__ and tv.act == "gelu_erf"


@pytest.fixture(scope="module")
def transformers():
    # the port needs transformers' torch models only: importing its
    # TensorFlow and Flax halves too costs seconds
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    return pytest.importorskip("transformers")


def _gpt2(transformers):
    cfg = transformers.GPT2Config(vocab_size=211, n_positions=32, n_embd=128,
                                  n_layer=2, n_head=2, resid_pdrop=0.0,
                                  embd_pdrop=0.0, attn_pdrop=0.0)
    torch.manual_seed(0)
    return transformers.GPT2LMHeadModel(cfg).eval()


def test_gpt2_logits_match_transformers(transformers):
    """n_embd 128 over 2 heads: head_dim 64, the flash route's plain
    versions; then the dense route (use_flash=False)."""
    hf = _gpt2(transformers)
    cfg = TIH.config_from_hf(hf.config)
    params = TP.from_numpy(TIH.convert_gpt2_state_dict(hf.state_dict(), cfg),
                           cfg, "cpu")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, 211, (2, 16)))
    with torch.no_grad():
        want = hf(tokens).logits.numpy()
    for c in (cfg, cfg.replace(use_flash=False)):
        got = TM.gpt_forward(TM.prepare_params(params, c), tokens, c)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_vit_logits_match_transformers(transformers):
    cfg_hf = transformers.ViTConfig(
        image_size=16, patch_size=4, num_channels=3, hidden_size=128,
        num_hidden_layers=2, num_attention_heads=2, intermediate_size=512,
        hidden_act="gelu", layer_norm_eps=1e-5, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, num_labels=7)
    torch.manual_seed(0)
    hf = transformers.ViTForImageClassification(cfg_hf).eval()
    cfg = TIH.config_from_hf_vit(hf.config)
    params = TP.from_numpy(TIH.convert_vit_state_dict(hf.state_dict(), cfg),
                           cfg, "cpu")
    imgs = np.random.default_rng(1).standard_normal((2, 16, 16, 3)).astype(
        np.float32)
    with torch.no_grad():
        want = hf(pixel_values=torch.from_numpy(imgs).permute(0, 3, 1, 2)
                  ).logits.numpy()
    got = TM.vit_forward(TM.prepare_params(params, cfg),
                         torch.from_numpy(imgs), cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_load_gpt2_reads_a_local_directory(transformers, tmp_path):
    hf = _gpt2(transformers)
    hf.save_pretrained(str(tmp_path))
    arrs, cfg = TIH.load_gpt2(str(tmp_path))
    _same(arrs, TIH.convert_gpt2_state_dict(hf.state_dict(), cfg))
    with pytest.raises((OSError, ValueError)):     # nothing is fetched
        TIH.load_gpt2(str(tmp_path / "absent"))
