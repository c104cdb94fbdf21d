"""PyTorch port: the vit.py inference API and the generation CLI."""

import jax
import numpy as np
import pytest
import torch

from vitrs_tpu.vit import ViT as JaxViT
from vitrs_tpu_torch.cli import generate as cli
from vitrs_tpu_torch.vit import ViT

from test_torch_helpers import small_cfgs

JCFG, TCFG = small_cfgs()


def _toks(seed, shape=(2, 24)):
    return np.random.default_rng(seed).integers(0, TCFG.vocab_size, shape)


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    """A JAX model, its checkpoint (with AdamW state) and its logits."""
    path = str(tmp_path_factory.mktemp("ckpt") / "jax.bin")
    jm = JaxViT.from_config(JCFG, seed=0)
    jm.save_checkpoint(path)
    assert jm.forward(_toks(0)) == -1.0
    return jm, path


def test_build_from_jax_checkpoint_forward_matches(jax_model):
    jm, path = jax_model
    toks = _toks(0)
    m = ViT.build_from_checkpoint(path)
    assert m.config.channels == 128 and m.num_parameters == jm.num_parameters
    assert m.forward(toks) == -1.0 and m.mean_loss == -1.0
    np.testing.assert_allclose(m.logits.numpy(), np.asarray(jm.logits),
                               rtol=1e-4, atol=1e-4)


def test_port_checkpoint_loads_in_jax(tmp_path):
    path = str(tmp_path / "t.bin")
    m = ViT.from_config(TCFG, seed=1)
    m.save_checkpoint(path)
    jm = JaxViT.build_from_checkpoint(path)
    toks = _toks(1)
    m.forward(toks)
    jm.forward(toks)
    np.testing.assert_allclose(m.logits.numpy(), np.asarray(jm.logits),
                               rtol=1e-4, atol=1e-4)


def test_from_config_is_seeded_and_validates():
    a, b = ViT.from_config(TCFG, seed=2), ViT.from_config(TCFG, seed=2)
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ViT.from_config("vit-tiny-4-cifar10", num_layers=1)


def test_training_calls_raise_until_the_training_slice():
    m = ViT.from_config(TCFG, seed=3)
    toks = _toks(3)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        m.forward(toks, toks)
    for call in (m.backward, lambda: m.optimizer_step(1e-3)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()


def test_cli_runs_at_gpt_nano(capsys):
    cli.main(["--preset", "gpt-nano", "--device", "cpu", "-p", "hi",
              "-p", "there", "--max-new", "4", "--max-len", "16"])
    out, err = capsys.readouterr()
    assert len(out.splitlines()) >= 1
    assert '"prompts": 2' in err and '"device": "cpu"' in err


def test_cli_from_checkpoint_with_trained_tokenizer(tmp_path, capsys):
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("hello world, hello there " * 30, encoding="utf-8")
    cfg = TCFG.replace(vocab_size=300)
    ckpt = str(tmp_path / "m.bin")
    ViT.from_config(cfg, seed=4).save_checkpoint(ckpt)
    cli.main(["--ckpt", ckpt, "--device", "cpu", "--train-tokenizer",
              str(corpus), "--vocab-size", "290", "-p", "hello",
              "--max-new", "5", "--chunk", "2", "--echo"])
    out, _ = capsys.readouterr()
    assert out.startswith("hello")


def test_jax_preset_init_differs_but_layout_matches(jax_model):
    """Same seed, other generator: different numbers, same layout."""
    jm, _ = jax_model
    m = ViT.from_config(TCFG, seed=0)
    assert list(m.params) == list(jm.params)
    for k, v in m.params.items():
        assert tuple(v.shape) == jm.params[k].shape
    assert not np.allclose(m.params["wte"].numpy(),
                           np.asarray(jax.device_get(jm.params["wte"])))
