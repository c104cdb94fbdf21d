"""PyTorch port: the vit.py inference API and the generation CLI."""

import jax
import numpy as np
import pytest
import torch

from vitrs_tpu.vit import ViT as JaxViT
from vitrs_tpu_torch.cli import generate as cli
from vitrs_tpu_torch.models import model as M
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
    m = ViT.build_from_checkpoint(path, device="cpu")
    assert m.config.channels == 128 and m.num_parameters == jm.num_parameters
    assert m.forward(toks) == -1.0 and m.mean_loss == -1.0
    np.testing.assert_allclose(m.logits.numpy(), np.asarray(jm.logits),
                               rtol=1e-4, atol=1e-4)


def test_port_checkpoint_loads_in_jax(tmp_path):
    path = str(tmp_path / "t.bin")
    m = ViT.from_config(TCFG, seed=1, device="cpu")
    m.save_checkpoint(path)
    jm = JaxViT.build_from_checkpoint(path)
    toks = _toks(1)
    m.forward(toks)
    jm.forward(toks)
    np.testing.assert_allclose(m.logits.numpy(), np.asarray(jm.logits),
                               rtol=1e-4, atol=1e-4)


def test_from_config_is_seeded_and_validates():
    a, b = (ViT.from_config(TCFG, seed=2, device="cpu") for _ in range(2))
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    vm = ViT.from_config("vit-tiny-4-cifar10", num_layers=1, device="cpu")
    imgs = np.random.default_rng(2).standard_normal((2, 32, 32, 3))
    assert vm.forward(imgs) == -1.0 and vm.logits.shape == (2, 10)
    qm = ViT.from_config("vit-tiny-4-cifar10", num_layers=1, quirks=True,
                         device="cpu")          # the quirk path is ported
    assert qm.forward(imgs) == -1.0 and qm.logits.shape == (2, 10)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(jax_model,
                                                         monkeypatch):
    """from_config and build_from_checkpoint run on the card by default and
    raise when torch sees none; device="cpu" is the caller's choice."""
    _, path = jax_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ViT.from_config(TCFG, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ViT.build_from_checkpoint(path)
    assert ViT.build_from_checkpoint(path, device="cpu").device.type == "cpu"


def test_training_calls_raise_until_the_training_slice():
    """The training slice is in: the calls run in gpt mode and raise when
    called out of order; vit mode's loss runs too (tests/test_torch_vit.py
    holds it against JAX)."""
    m = ViT.from_config(TCFG, seed=3, device="cpu")
    toks = _toks(3)
    with pytest.raises(RuntimeError, match="forward with targets"):
        m.backward()
    with pytest.raises(RuntimeError, match="backward"):
        m.optimizer_step(1e-3)
    loss = m.forward(toks, toks)
    assert np.isfinite(loss) and loss > 0
    m.backward()
    m.optimizer_step(1e-3)
    assert m.step == 1
    vm = ViT.from_config("vit-tiny-4-cifar10", num_layers=1, device="cpu")
    imgs = torch.randn(2, 32, 32, 3)
    vloss = M.loss_fn(vm.params, imgs, torch.tensor([1, 7]), vm.config)
    assert np.isfinite(vloss.item()) and vloss.item() > 0


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
    ViT.from_config(cfg, seed=4, device="cpu").save_checkpoint(ckpt)
    cli.main(["--ckpt", ckpt, "--device", "cpu", "--train-tokenizer",
              str(corpus), "--vocab-size", "290", "-p", "hello",
              "--max-new", "5", "--chunk", "2", "--echo"])
    out, _ = capsys.readouterr()
    assert out.startswith("hello")


def test_jax_preset_init_differs_but_layout_matches(jax_model):
    """Same seed, other generator: different numbers, same layout."""
    jm, _ = jax_model
    m = ViT.from_config(TCFG, seed=0, device="cpu")
    assert list(m.params) == list(jm.params)
    for k, v in m.params.items():
        assert tuple(v.shape) == jm.params[k].shape
    assert not np.allclose(m.params["wte"].numpy(),
                           np.asarray(jax.device_get(jm.params["wte"])))
