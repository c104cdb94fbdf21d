"""PyTorch port: MAE pretraining and the CLIP tower against the JAX
package, on the CPU, fp32, at a vit-tiny width whose head_dim is 64 (so the
port's attention takes the flash route, here its plain versions: encoder
T = 1 + 16 kept patches, decoder 128 wide x 4 layers at T = 65; the JAX
package is dense on the CPU).  Parameters come from the JAX initialisers
and are carried across with `params.from_numpy`; the masking noise is the
JAX draw's, fed to the port's `masking_from_noise`.

Tolerances: masks and indices exact; outputs and losses rtol 2e-5 (atol
1e-5 on outputs that cross zero); gradients rtol 5e-4 with atol 2e-5 of
the tensor's largest value (fp32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitrs_tpu import checkpoint as JC
from vitrs_tpu import checkpoint_tree as JCT
from vitrs_tpu.models import clip as JCLIP
from vitrs_tpu.models import mae as JMAE
from vitrs_tpu_torch import checkpoint_tree as TCT
from vitrs_tpu_torch import params as TP
from vitrs_tpu_torch.cli import pretrain_mae
from vitrs_tpu_torch.models import clip as TCLIP
from vitrs_tpu_torch.models import mae as TMAE
from vitrs_tpu_torch.train import loop as TL

from test_torch_helpers import jax_config, torch_config
from test_torch_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KW = dict(num_layers=2, channels=128, num_heads=2, dtype="float32")
JCFG = jax_config("vit-tiny-4-cifar10").replace(**KW)
TCFG = torch_config("vit-tiny-4-cifar10").replace(**KW)
B = 4
# the JAX side under jit: one compile a function instead of one an op
J_INIT_MAE = jax.jit(JMAE.init_mae_params, static_argnums=0)
J_MAE_FWD = jax.jit(JMAE.mae_forward, static_argnums=2)
J_MAE_LOSS = jax.jit(JMAE.mae_loss, static_argnums=(2, 4, 5))
J_RECON = jax.jit(JMAE.reconstruct, static_argnums=2)
J_MAE_GRAD = jax.jit(jax.grad(JMAE.mae_loss), static_argnums=2)
J_INIT_CLIP = jax.jit(JCLIP.init_clip_params, static_argnums=0)
J_EMBED = jax.jit(JCLIP.image_embed, static_argnums=2)
J_ZERO_SHOT = jax.jit(JCLIP.zero_shot_classify, static_argnums=3)
J_CLIP_GRAD = jax.jit(jax.value_and_grad(JCLIP.clip_loss), static_argnums=3)


def _images(n=B, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 32, 32, 3)).astype(np.float32)


def _grad_close(got, want, name):
    w = np.asarray(want)
    scale = max(float(np.abs(w).max()), 1e-12)
    np.testing.assert_allclose(got.numpy(), w, rtol=5e-4, atol=2e-5 * scale,
                               err_msg=name)


@pytest.fixture(scope="module")
def mae():
    jp = J_INIT_MAE(JCFG, jax.random.PRNGKey(0))
    host = jax.device_get(jp)
    return jp, host, TP.from_numpy(host, TCFG, "cpu")


def _noise(key, n=B):
    return jax.random.uniform(key, (n, JCFG.num_patches))


def test_masking_from_the_jax_noise_matches_random_masking():
    key = jax.random.PRNGKey(3)
    want = JMAE.random_masking(key, B, JCFG.num_patches, 0.75)
    got = TMAE.masking_from_noise(torch.tensor(np.asarray(_noise(key))),
                                  0.75)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].shape == (B, 16) and float(got[2].sum()) == B * 48
    gen = torch.Generator().manual_seed(5)
    noise = TMAE.draw_noise(torch.Generator().manual_seed(5), B, 64)
    for g, w in zip(TMAE.random_masking(gen, B, 64, 0.75),
                    TMAE.masking_from_noise(noise, 0.75)):
        assert torch.equal(g, w)
    # ties break by index, as jnp.argsort's stable sort does
    flat = torch.zeros(2, 8)
    keep, restore, _ = TMAE.masking_from_noise(flat, 0.5)
    assert keep.tolist() == [[0, 1, 2, 3]] * 2
    assert restore.tolist() == [list(range(8))] * 2


def test_mae_forward_loss_and_reconstruct_match_jax(mae):
    jp, _, tp = mae
    imgs, key = _images(), jax.random.PRNGKey(1)
    noise = torch.tensor(np.asarray(_noise(key)))
    jpred, jtgt, jmask = J_MAE_FWD(jp, jnp.asarray(imgs), JCFG, key)
    tpred, ttgt, tmask = TMAE.mae_forward(tp, torch.from_numpy(imgs), TCFG,
                                          noise)
    assert tpred.dtype == ttgt.dtype == torch.float32
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(ttgt.numpy(), np.asarray(jtgt))
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred), rtol=2e-5,
                               atol=1e-5)
    for norm_pix in (True, False):
        jl = J_MAE_LOSS(jp, jnp.asarray(imgs), JCFG, key, 0.75, norm_pix)
        tl = TMAE.mae_loss(tp, torch.from_numpy(imgs), TCFG, noise,
                           norm_pix=norm_pix)
        np.testing.assert_allclose(float(tl), float(jl), rtol=2e-5)
    jr = J_RECON(jp, jnp.asarray(imgs), JCFG, key)
    tr = TMAE.reconstruct(tp, torch.from_numpy(imgs), TCFG, noise)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=2e-5,
                               atol=1e-5)


def test_mae_grads_of_encoder_and_decoder_match_jax(mae):
    jp, _, tp = mae
    imgs, key = _images(seed=2), jax.random.PRNGKey(2)
    noise = torch.tensor(np.asarray(_noise(key)))
    jg = J_MAE_GRAD(jp, jnp.asarray(imgs), JCFG, key)
    leaves = {part: {k: t.clone().requires_grad_(True)
                     for k, t in tree.items()} for part, tree in tp.items()}
    TMAE.mae_loss(leaves, torch.from_numpy(imgs), TCFG, noise).backward()
    for part in ("encoder", "decoder"):
        for k, t in leaves[part].items():
            if t.grad is None:          # wte and the head: unread, 0 in JAX
                assert not np.asarray(jg[part][k]).any(), (part, k)
                continue
            _grad_close(t.grad, jg[part][k], f"{part}/{k}")


def test_mae_tree_round_trips_both_ways(mae, tmp_path):
    _, host, tp = mae
    JCT.save_tree(str(tmp_path / "jax.tree"), host, meta={"mask_ratio": 0.75})
    tree, meta = TCT.load_tree(str(tmp_path / "jax.tree"))
    back = TP.from_numpy(tree, TCFG, "cpu")
    assert meta["mask_ratio"] == 0.75 and set(back) == {"encoder", "decoder"}
    for part in back:
        assert set(back[part]) == set(host[part])
        for k, t in back[part].items():
            np.testing.assert_array_equal(t.numpy(), np.asarray(host[part][k]))
    TCT.save_tree(str(tmp_path / "torch.tree"), TP.to_numpy(tp, TCFG))
    jtree, _ = JCT.load_tree(str(tmp_path / "torch.tree"))
    for part in host:
        for k, v in host[part].items():
            np.testing.assert_array_equal(jtree[part][k], np.asarray(v))
    with pytest.raises(ValueError, match="predw"):
        bad = {p: dict(t) for p, t in tree.items()}
        bad["decoder"]["predw"] = bad["decoder"]["predw"][:, :-1]
        TP.from_numpy(bad, TCFG, "cpu")


def test_pretrain_cli_encoder_warm_starts_the_trainer(tmp_path):
    """The CLI's loop (2 steps), then its encoder_final.bin: the JAX
    package reads it, and the port's trainer starts from it (one step at
    lr 0 leaves the weights as loaded)."""
    summary = pretrain_mae.main([
        "--preset", "vit-tiny-4-cifar10", "--cpu", "--steps", "2",
        "--batch-size", "8", "--dtype", "float32", "--dataset",
        "synthetic-shapes", "--dataset-size", "16", "--log-every", "1",
        "--workdir", str(tmp_path / "mae")])
    assert len(summary["losses"]) == 2 and np.isfinite(summary["losses"]).all()
    enc = summary["params"]["encoder"]
    jarrs, jcfg, _ = JC.load_checkpoint(summary["encoder"])
    assert jcfg.mode == "vit"
    for k, v in jarrs.items():
        np.testing.assert_array_equal(v, enc[k].numpy(), err_msg=k)
    tree, _ = JCT.load_tree(str(tmp_path / "mae" / "mae_final.tree"))
    np.testing.assert_array_equal(tree["decoder"]["predw"],
                                  summary["params"]["decoder"]["predw"])
    TL.train(TL.TrainConfig(
        preset="vit-tiny-4-cifar10", dataset="synthetic-shapes",
        dataset_size=16, steps=1, batch_size=8, lr=0.0, warmup=1,
        min_lr=0.0, weight_decay=0.0, dtype="float32", log_every=1,
        ckpt_every=0, workdir=str(tmp_path / "ft"), device="cpu",
        init_ckpt=summary["encoder"]))
    ft, _, _ = JC.load_checkpoint(str(tmp_path / "ft" / "ckpt_00000001.bin"))
    for k in ("qkvw", "patchw", "cls", "wpe"):
        np.testing.assert_array_equal(ft[k], jarrs[k], err_msg=k)


@pytest.fixture(scope="module")
def clip():
    jp = J_INIT_CLIP(JCFG, jax.random.PRNGKey(4))
    host = jax.device_get(jp)
    tp = TP.from_numpy(host, TCFG, "cpu")
    assert tp["logit_scale"].dtype == torch.float32
    return jp, host, tp


def _txt(n=B, e=10, seed=1):
    return np.random.default_rng(seed).standard_normal((n, e)).astype(
        np.float32)


def test_image_embed_and_zero_shot_match_jax(clip):
    jp, host, tp = clip
    imgs = _images(seed=3)
    je = J_EMBED(jp, jnp.asarray(imgs), JCFG)
    te = TCLIP.image_embed(tp, torch.from_numpy(imgs), TCFG)
    assert te.shape == (B, TCFG.num_classes) and te.dtype == torch.float32
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=2e-5,
                               atol=1e-6)
    protos = _txt(5, TCFG.num_classes, seed=2)
    np.testing.assert_allclose(
        TCLIP.zero_shot_classify(tp, torch.from_numpy(imgs),
                                 torch.from_numpy(protos), TCFG).numpy(),
        np.asarray(J_ZERO_SHOT(jp, jnp.asarray(imgs), jnp.asarray(protos),
                               JCFG)),
        rtol=2e-5, atol=1e-6)
    back = TP.to_numpy(tp, TCFG)
    assert set(back) == set(host)
    np.testing.assert_array_equal(back["logit_scale"], host["logit_scale"])


@pytest.mark.parametrize("scale", [np.log(1 / 0.07), 5.0])
def test_contrastive_loss_matches_jax(scale):
    """5.0 lies above the clamp at log 100."""
    img = _txt(8, 16, seed=5)
    img /= np.linalg.norm(img, axis=-1, keepdims=True)
    txt = _txt(8, 16, seed=6)
    s = np.float32(scale)
    jl = JCLIP.contrastive_loss(jnp.asarray(img), jnp.asarray(txt),
                                jnp.asarray(s))
    tl = TCLIP.contrastive_loss(torch.from_numpy(img), torch.from_numpy(txt),
                                torch.tensor(s))
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-5)
    aligned = TCLIP.contrastive_loss(torch.from_numpy(img),
                                     torch.from_numpy(img), torch.tensor(s))
    assert float(aligned) < float(tl)


def test_clip_loss_grads_including_logit_scale_match_jax(clip):
    jp, _, tp = clip
    imgs, txt = _images(seed=4), _txt(seed=7)
    jl, jg = J_CLIP_GRAD(jp, jnp.asarray(imgs), jnp.asarray(txt), JCFG)
    leaves = {k: t.clone().requires_grad_(True) for k, t in tp.items()}
    tl = TCLIP.clip_loss(leaves, torch.from_numpy(imgs),
                         torch.from_numpy(txt), TCFG)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-5)
    assert leaves["logit_scale"].grad is not None
    for k, t in leaves.items():
        if t.grad is None:                      # wte: unread, 0 in JAX
            assert not np.asarray(jg[k]).any(), k
            continue
        _grad_close(t.grad, jg[k], k)
