"""PyTorch port: vit mode against the JAX package, on the CPU, from the same
numpy parameters, images and labels.

  * patchify / unpatchify, `vit_encode` (CLS pool, mean pool, keep_ids),
    `vit_forward` logits and `vit_loss` with every gradient against
    jax.value_and_grad, at head_dim 64 and 32 (the port's kernel route: the
    kernels' plain versions on the CPU) and head_dim 16 (the dense route);
  * stochastic depth and head dropout given the same keep flags; the mixup
    loss given the same lambda and permutation; uint8 normalisation;
  * one `make_dp_train_step` step in vit mode against the JAX step on a
    one-device mesh;
  * the copies of data/augment.py and data/datasets.py pinned to the
    originals, the DataLoader resumed from its cursor;
  * the five-call API in vit mode, vit checkpoints in both directions, the
    trainer and `evaluate`, the infer CLI;
  * K1-fwd's and K2's plain versions at causal=False and T in {17, 65,
    197} (the CPU test model's, vit-tiny-4-cifar10's and ViT-B/16's token
    counts) against the single-tile Pallas kernels in interpret mode.

Tolerances (ROADMAP.md's CPU parity tolerances): loss rtol 2e-5, gradients
rtol 5e-4 with atol 1e-6 for values near 0, and atol 2e-4 for the packed
qkv bias (its K third has an exactly-zero gradient, so both sides hold
fp32 noise there); logits and activations rtol/atol 2e-5; the plain flash
versions 2e-5 (fp32, the same rounding points, another summation order).
bf16 (fp32 masters, bf16 compute): the two packages round at the same
points except inside attention (the JAX package's CPU route is dense, the
port's the flash kernels' plain version), so the loss is held at rtol
1e-2 and each gradient at 5e-2 of its largest value.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitrs_tpu import params as JP
from vitrs_tpu.config import get_config as jax_config
from vitrs_tpu.data import augment as JA
from vitrs_tpu.data import datasets as JD
from vitrs_tpu.models import model as JM
from vitrs_tpu.ops import basic as JB
from vitrs_tpu.ops import flash_attention as JFA
from vitrs_tpu.parallel import data_parallel as JDP
from vitrs_tpu.train import loop as JL
from vitrs_tpu.utils import flops as JF
from vitrs_tpu.vit import ViT as JaxViT
from vitrs_tpu_torch import params as TP
from vitrs_tpu_torch.cli import infer as infer_cli
from vitrs_tpu_torch.cli import train as train_cli
from vitrs_tpu_torch.config import get_config as torch_config
from vitrs_tpu_torch.data import augment as TA
from vitrs_tpu_torch.data import datasets as TD
from vitrs_tpu_torch.models import model as TM
from vitrs_tpu_torch.ops import basic as TB
from vitrs_tpu_torch.ops import flash_attention as TFA
from vitrs_tpu_torch.parallel import data_parallel as TDP
from vitrs_tpu_torch.train import loop as TL
from vitrs_tpu_torch.utils import flops as TF
from vitrs_tpu_torch.vit import ViT

from test_torch_helpers import np_params

B = 4
# a small vit: 16x16 images, 4x4 patches -> 16 patches + CLS = T 17
SMALL_VIT = dict(num_layers=2, channels=128, num_heads=2, img_size=16,
                 patch_size=4, num_classes=10, vocab_size=10, max_seq_len=17)
# each route's (heads, use_flash): head dims 64 and 32 take the port's
# kernel route, d16 its dense route (use_flash=False; D = 16 itself is on
# the kernels, which tile every divisor of 128)
ROUTES = {"d64": (2, True), "d32": (4, True), "d16": (8, False)}


def _route(route):
    heads, flash = ROUTES[route]
    return dict(num_heads=heads, use_flash=flash)


def vit_cfgs(**overrides):
    """The same small vit config from both packages: (jax, torch)."""
    kw = dict(SMALL_VIT, **overrides)
    return (jax_config("vit-tiny-4-cifar10").replace(**kw),
            torch_config("vit-tiny-4-cifar10").replace(**kw))


def _params(tcfg, seed=0):
    arrs = np_params(tcfg, seed)
    return arrs, {k: jnp.asarray(v) for k, v in arrs.items()}


def _images(cfg, seed=0, n=B):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, cfg.img_size, cfg.img_size, cfg.in_chans),
                            dtype=np.float32)
    return x, rng.integers(0, cfg.num_classes, n).astype(np.int32)


def _leaves(arrs, tcfg):
    return {k: v.requires_grad_(True)
            for k, v in TP.from_numpy(arrs, tcfg, "cpu").items()}


def _assert_grads(got, want, rtol=5e-4):
    for k, w in want.items():
        w = np.asarray(w)
        g = (np.zeros_like(w) if got[k] is None
             else got[k].detach().float().numpy())
        atol = 2e-4 if k == "qkvb" else 1e-6
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=k)


# ---------------------------------------------------------------------------
# patchify, the encoder, the forward and the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("patch", [4, 16])
def test_patchify_and_unpatchify_match_jax(patch):
    rng = np.random.default_rng(patch)
    img = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    got = TB.patchify(torch.from_numpy(img), patch)
    want = np.asarray(JB.patchify(jnp.asarray(img), patch))
    assert got.shape == ((2, (32 // patch) ** 2, patch * patch * 3))
    np.testing.assert_array_equal(got.numpy(), want)
    back = TB.unpatchify(got, patch, 32)
    np.testing.assert_array_equal(back.numpy(), img)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(JB.unpatchify(jnp.asarray(want), patch, 32)))


@pytest.mark.parametrize("case", ["cls", "mean", "keep_ids"])
def test_vit_encode_matches_jax(case):
    jcfg, tcfg = vit_cfgs(pool="mean" if case == "mean" else "cls",
                          max_seq_len=17)
    arrs, jp = _params(tcfg, 1)
    x, _ = _images(tcfg, 1)
    keep = None
    if case == "keep_ids":
        keep = np.stack([np.random.default_rng(i).permutation(16)[:5]
                         for i in range(B)]).astype(np.int32)
    want = JM.vit_encode(jnp.asarray(x), jp, jcfg,
                         None if keep is None else jnp.asarray(keep))
    got = TM.vit_encode(torch.from_numpy(x), TP.from_numpy(arrs, tcfg, "cpu"),
                        tcfg, None if keep is None else torch.from_numpy(keep))
    T = {"cls": 17, "mean": 16, "keep_ids": 6}[case]
    assert got.shape == (B, T, tcfg.channels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("pool", ["cls", "mean"])
@pytest.mark.parametrize("route", ["d64", "d32", "d16"])
def test_vit_logits_match_jax(route, pool):
    jcfg, tcfg = vit_cfgs(pool=pool, **_route(route))
    arrs, jp = _params(tcfg, 2)
    x, _ = _images(tcfg, 2)
    want = JM.vit_forward(jp, jnp.asarray(x), jcfg)
    got = TM.vit_forward(TM.prepare_params(TP.from_numpy(arrs, tcfg, "cpu"),
                                           tcfg), torch.from_numpy(x), tcfg)
    assert got.dtype == torch.float32 and got.shape == (B, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_routes_are_the_ones_named(monkeypatch):
    """d64 and d32 run the flash route (the kernels' plain versions), d16
    the dense route."""
    calls = []
    plain = TFA.flash_fwd_plain
    monkeypatch.setattr(TFA, "flash_fwd_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    for route in ("d64", "d32", "d16"):
        _, tcfg = vit_cfgs(**_route(route))
        arrs, _ = _params(tcfg)
        x, _ = _images(tcfg)
        calls.clear()
        TM.vit_forward(TP.from_numpy(arrs, tcfg, "cpu"), torch.from_numpy(x),
                       tcfg)
        assert len(calls) == (tcfg.num_layers if tcfg.use_flash else 0)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("route", ["d64", "d32", "d16"])
def test_vit_loss_and_all_grads_match_jax(route, smoothing):
    jcfg, tcfg = vit_cfgs(label_smoothing=smoothing, **_route(route))
    arrs, jp = _params(tcfg, 3)
    x, y = _images(tcfg, 3)
    jloss, jgrads = jax.value_and_grad(JM.loss_fn)(jp, jnp.asarray(x),
                                                   jnp.asarray(y), jcfg)
    leaves = _leaves(arrs, tcfg)
    loss = TM.loss_fn(leaves, torch.from_numpy(x), torch.from_numpy(y), tcfg)
    loss.backward()
    assert len(leaves) == 21 and leaves["wte"].grad is None
    assert not np.asarray(jgrads["wte"]).any()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-5)
    _assert_grads({k: p.grad for k, p in leaves.items()}, jgrads)


def test_vit_bf16_loss_and_grads_match_jax():
    """fp32 masters, bf16 compute: the casts (patch embedding, wpe slice,
    cls + wpe[0] in fp32 then cast, the head in bf16, logits back to fp32)
    follow the JAX package; held at the bf16 tolerance of the module
    docstring."""
    jcfg, tcfg = vit_cfgs(dtype="bfloat16", num_layers=1)
    arrs, jp = _params(tcfg, 4)
    x, y = _images(tcfg, 4)
    jloss, jgrads = jax.value_and_grad(JM.loss_fn)(jp, jnp.asarray(x),
                                                   jnp.asarray(y), jcfg)
    leaves = _leaves(arrs, tcfg)
    loss = TM.loss_fn(leaves, torch.from_numpy(x), torch.from_numpy(y), tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-2)
    for k, w in jgrads.items():
        if k == "wte":
            continue
        w = np.asarray(w, np.float32)
        g = leaves[k].grad.numpy()
        assert leaves[k].grad.dtype == torch.float32
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-12)
        assert err <= 5e-2, f"{k}: {err:.3e}"
    logits = TM.vit_forward(TM.prepare_params(TP.from_numpy(arrs, tcfg, "cpu"),
                                              tcfg), torch.from_numpy(x), tcfg)
    assert logits.dtype == torch.float32


def test_prepare_params_casts_what_jax_casts():
    _, tcfg = vit_cfgs(dtype="bfloat16")
    arrs, _ = _params(tcfg)
    pp = TM.prepare_params(TP.from_numpy(arrs, tcfg, "cpu"), tcfg)
    cast = set(TM.MATMUL_KEYS + TM.VIT_MATMUL_KEYS)
    assert "head" not in pp
    for k, t in pp.items():
        assert t.dtype == (torch.bfloat16 if k in cast else torch.float32), k


# ---------------------------------------------------------------------------
# stochastic depth, head dropout, mixup, normalisation
# ---------------------------------------------------------------------------

def test_drop_path_matches_jax_given_the_keep_flags(monkeypatch):
    rng = np.random.default_rng(5)
    branch = rng.standard_normal((6, 5, 8)).astype(np.float32)
    keep = np.array([True, False, True, True, False, True])
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(keep).reshape(shape))
    want = JM._drop_path(jnp.asarray(branch), jax.random.PRNGKey(0),
                         jnp.float32(0.25))
    got = TM._drop_path(torch.from_numpy(branch), torch.from_numpy(keep), 0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7)
    assert not got[1].any() and not got[4].any()
    bf = TM._drop_path(torch.from_numpy(branch).bfloat16(),
                       torch.from_numpy(keep), 0.25)
    assert bf.dtype == torch.bfloat16


def test_head_dropout_matches_jax_given_the_keep_flags(monkeypatch):
    jcfg, tcfg = vit_cfgs(drop_rate=0.3)
    arrs, jp = _params(tcfg, 6)
    x, y = _images(tcfg, 6)
    keep = TM.draw_masks(tcfg, B, torch.Generator().manual_seed(9),
                         "cpu")["head"]
    assert keep.shape == (B, tcfg.channels) and not keep.all()
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(keep.numpy()))
    jloss, jgrads = jax.value_and_grad(JM.loss_fn)(
        jp, jnp.asarray(x), jnp.asarray(y), jcfg, rng=jax.random.PRNGKey(1))
    leaves = _leaves(arrs, tcfg)
    loss = TM.loss_fn(leaves, torch.from_numpy(x), torch.from_numpy(y), tcfg,
                      generator=torch.Generator().manual_seed(9))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-5)
    _assert_grads({k: p.grad for k, p in leaves.items()}, jgrads)


def test_stochastic_depth_flags_and_rates():
    """Rates linspace(0, drop_path, L) as in JAX; layer 0 always kept; the
    same generator seed gives the same flags; a dropped branch leaves the
    residual stream untouched."""
    _, tcfg = vit_cfgs(num_layers=4, drop_path=0.5)
    assert TM.drop_path_rates(tcfg) == pytest.approx(
        np.asarray(jnp.linspace(0.0, 0.5, 4)).tolist())
    a, b = (TM.draw_masks(tcfg, 64, torch.Generator().manual_seed(3), "cpu")
            for _ in range(2))
    keep = a["drop_path"]
    assert keep.shape == (4, 2, 64) and torch.equal(keep, b["drop_path"])
    assert keep[0].all() and not keep[3].all()
    arrs, _ = _params(tcfg)
    p = TM.layer(TP.from_numpy(arrs, tcfg, "cpu"), 1)
    x = torch.randn(2, 17, tcfg.channels)
    dropped = TM._block(x, p, tcfg, False, torch.zeros(2, 2, dtype=torch.bool),
                        0.5)
    assert torch.equal(dropped, x)


def _jax_mixup_loss(jp, x, y, lam, perm, jcfg):
    """The JAX step's `_mixup_loss` composition, with lambda and the
    permutation given."""
    lam = jnp.float32(lam)
    mixed = lam * x + (1.0 - lam) * x[perm]
    logits = JM.vit_forward(jp, mixed, jcfg, train=True)
    if jcfg.label_smoothing > 0.0:
        ce = lambda t: jnp.mean(JB.cross_entropy_smoothed(
            logits, t, jcfg.label_smoothing))
    else:
        ce = lambda t: jnp.mean(JB.cross_entropy_from_logits(logits, t))
    return lam * ce(y) + (1.0 - lam) * ce(y[perm])


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_mixup_loss_matches_jax_given_lambda_and_perm(smoothing):
    jcfg, tcfg = vit_cfgs(label_smoothing=smoothing)
    arrs, jp = _params(tcfg, 7)
    x, y = _images(tcfg, 7)
    lam, perm = TDP.mixup_draw(0.4, 11, B)
    jloss, jgrads = jax.value_and_grad(_jax_mixup_loss)(
        jp, jnp.asarray(x), jnp.asarray(y), lam, jnp.asarray(perm), jcfg)
    leaves = _leaves(arrs, tcfg)
    loss = TDP.mixup_loss(leaves, torch.from_numpy(x), torch.from_numpy(y),
                          lam, torch.from_numpy(perm), tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-5)
    _assert_grads({k: p.grad for k, p in leaves.items()}, jgrads)


def test_mixup_draw_is_explicit_and_repeatable():
    a, b, c = (TDP.mixup_draw(0.2, s, 16) for s in (5, 5, 6))
    assert a[0] == b[0] and np.array_equal(a[1], b[1])
    assert a[0] != c[0]
    assert 0.0 < a[0] < 1.0 and sorted(a[1]) == list(range(16))
    rng = np.random.default_rng([0x31A5, 5])
    assert a[0] == float(np.float32(rng.beta(0.2, 0.2)))


def test_normalize_uint8_matches_jax_formula():
    rng = np.random.default_rng(8)
    x = rng.integers(0, 256, (3, 8, 8, 3)).astype(np.uint8)
    mean, std = TD.CIFAR10_MEAN, TD.CIFAR10_STD
    want = (jnp.asarray(x).astype(jnp.float32) * (1.0 / 255.0)
            - jnp.asarray(mean, jnp.float32)) * jnp.asarray(1.0 / std,
                                                            jnp.float32)
    got = TDP.normalize_images(torch.from_numpy(x), mean, std)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the data-parallel step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("accum", [1, 2])
def test_dp_step_matches_jax_in_vit_mode(accum):
    """uint8 images normalised on the device, clip and the >= 2-axis decay,
    against the JAX step at world size 1.  The two cases differ in their
    config: the JAX step's lru-cached decay mask is built inside its jit
    trace, so a second trace with an equal config would reuse a leaked
    tracer."""
    jcfg, tcfg = vit_cfgs(label_smoothing=0.1 * (2 - accum))
    arrs = np_params(tcfg, 9)
    rng = np.random.default_rng(9)
    x = rng.integers(0, 256, (B, 16, 16, 3)).astype(np.uint8)
    y = rng.integers(0, 10, B).astype(np.int32)
    stats = (TD.CIFAR10_MEAN, TD.CIFAR10_STD)
    kw = dict(accum_steps=accum, clip_norm=0.5, decay_2d_only=True,
              return_grad_norm=True, normalize=stats)
    n = TP.num_parameters(tcfg)
    jstep = JDP.make_dp_train_step(jcfg, JDP.make_mesh(1), **kw)
    jp, jm, jv, jloss, jnorm = jstep(
        {k: jnp.asarray(a) for k, a in arrs.items()},
        jnp.zeros(n, jnp.float32), jnp.zeros(n, jnp.float32), jnp.asarray(x),
        jnp.asarray(y), np.int32(1), np.float32(1e-3), np.float32(0.05))
    flat = TP.flatten_params(TP.from_numpy(arrs, tcfg, "cpu"), tcfg)
    tstep = TDP.make_dp_train_step(tcfg, TDP.make_mesh(devices=["cpu"]), **kw)
    m, v = TDP.init_sharded_opt_state(tcfg, TDP.make_mesh(devices=["cpu"]))
    params, m, v, loss, gnorm = tstep(TP.unflatten_params(flat, tcfg), m, v,
                                      x, y, 1, 1e-3, 0.05)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-5)
    np.testing.assert_allclose(gnorm.item(), float(jnorm), rtol=2e-5)
    jp = jax.device_get(jp)
    g = np.asarray(jm) / 0.1               # AdamW's m after step 1 = 0.1 g
    for k, w in jp.items():
        atol = np.full(w.shape, 1e-6, np.float32)
        gk = TP.unflatten_params(torch.from_numpy(g), tcfg)[k].numpy()
        atol[np.abs(gk) < 1e-6] = 1e-3     # lr g / (|g| + eps) magnifies noise
        d = np.abs(params[k].detach().numpy() - w)
        assert not (d > atol + 2e-5 * np.abs(w)).any(), k


def test_dp_step_drop_path_is_seeded_per_step():
    """Stochastic depth in the step draws from `step_generator`: the same
    step repeats its loss, another step draws other flags."""
    _, tcfg = vit_cfgs(drop_path=0.5, num_layers=4)
    arrs = np_params(tcfg, 10)
    x, y = _images(tcfg, 10, n=8)
    losses = []
    for step in (3, 3, 4):
        flat = TP.flatten_params(TP.from_numpy(arrs, tcfg, "cpu"), tcfg)
        mesh = TDP.make_mesh(devices=["cpu"])
        m, v = TDP.init_sharded_opt_state(tcfg, mesh)
        out = TDP.make_dp_train_step(tcfg, mesh)(
            TP.unflatten_params(flat, tcfg), m, v, x, y, step, 0.0, 0.0)
        losses.append(out[3].item())
    assert losses[0] == losses[1] and losses[0] != losses[2]
    a, b = TDP.step_generator(3), TDP.step_generator(3, 0)
    assert not torch.equal(torch.rand(8, generator=a),
                           torch.rand(8, generator=b))


def test_dp_step_refuses_mixup_with_accumulation():
    _, tcfg = vit_cfgs()
    with pytest.raises(ValueError, match="accumulation"):
        TDP.make_dp_train_step(tcfg, TDP.make_mesh(devices=["cpu"]),
                               accum_steps=2, mixup_alpha=0.2)


# ---------------------------------------------------------------------------
# the data copies
# ---------------------------------------------------------------------------

def test_synthetic_datasets_match_the_originals():
    for name, kw in (("cifar10", {}), ("synthetic-shapes", {"n": 64}),
                     ("synthetic-imagenet", {"n": 8, "img_size": 48,
                                             "num_classes": 5})):
        for train in (True, False):
            a = TD.get_dataset(name, train=train, **kw)
            b = JD.get_dataset(name, train=train, **kw)
            np.testing.assert_array_equal(a.images, b.images)
            np.testing.assert_array_equal(a.labels, b.labels)
            assert a.num_classes == b.num_classes
            np.testing.assert_array_equal(a.mean, b.mean)
            np.testing.assert_array_equal(a.std, b.std)
    with pytest.raises(ValueError):
        TD.get_dataset("nope")


def test_load_cifar10_matches_the_original(tmp_path):
    import pickle
    rng = np.random.default_rng(11)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        d = {b"data": rng.integers(0, 256, (4, 3072)).astype(np.uint8),
             b"labels": list(rng.integers(0, 10, 4))}
        with open(tmp_path / name, "wb") as f:
            pickle.dump(d, f)
    for train in (True, False):
        a = TD.get_dataset("cifar10", str(tmp_path), train=train)
        b = JD.load_cifar10(str(tmp_path), train)
        assert a.images.shape == ((20 if train else 4), 32, 32, 3)
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)


@pytest.mark.parametrize("crop_pad,flip", [(0, False), (4, True)])
def test_augment_matches_the_original(crop_pad, flip):
    ds = TD.synthetic_dataset(n=32, img_size=16, seed=2)
    idx = np.array([3, 0, 31, 7, 7, 12])
    args = (crop_pad, flip, 5, 2)
    norm = dict(mean=ds.mean, std=ds.std)
    # the NumPy paths equal; augment_batch takes the native library in
    # both packages, and their builds of imagepipe.cpp give the same bits
    got = TA._augment_numpy(ds.images, idx, crop_pad, int(flip), 5, 2,
                            ds.mean, ds.std)
    np.testing.assert_array_equal(got, JA._augment_numpy(
        ds.images, idx, crop_pad, int(flip), 5, 2, ds.mean, ds.std))
    np.testing.assert_array_equal(
        TA.augment_batch(ds.images, idx, *args, **norm),
        JA.augment_batch(ds.images, idx, *args, **norm))
    got8 = TA.augment_batch(ds.images, idx, *args, out_uint8=True)
    assert got8.dtype == np.uint8
    np.testing.assert_array_equal(got8, JA.augment_batch(
        ds.images, idx, *args, out_uint8=True))


@pytest.mark.parametrize("device_normalize", [False, True])
def test_dataloader_matches_the_original_and_resumes(device_normalize):
    ds = TD.synthetic_dataset(n=40, img_size=8, seed=3)
    jds = JD.synthetic_dataset(n=40, img_size=8, seed=3)
    kw = dict(seed=4, train=True, device_normalize=device_normalize)
    ta, ja = TD.DataLoader(ds, 16, **kw), JD.DataLoader(jds, 16, **kw)
    batches = [ta.next_batch() for _ in range(5)]      # wraps two epochs
    for x, y in batches:
        jx, jy = ja.next_batch()
        np.testing.assert_allclose(x, jx, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(y, jy)
    assert ta.cursor == 80
    resumed = TD.DataLoader(ds, 16, cursor=48, **kw)
    for x, y in batches[3:]:
        rx, ry = resumed.next_batch()
        np.testing.assert_array_equal(rx, x)
        np.testing.assert_array_equal(ry, y)


# ---------------------------------------------------------------------------
# the five-call API, checkpoints, the trainer, the CLIs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_vit_ckpt(tmp_path_factory):
    """The path of a one-layer JAX vit model's checkpoint (with AdamW
    state)."""
    jcfg, _ = vit_cfgs(num_layers=1)
    path = str(tmp_path_factory.mktemp("vit") / "jax.bin")
    JaxViT.from_config(jcfg, seed=0).save_checkpoint(path)
    return path


def test_vit_from_jax_checkpoint_forward_and_backward(jax_vit_ckpt):
    """forward (the sentinel, then the loss) and backward in vit mode, from
    a JAX checkpoint, against the JAX model."""
    jm = JaxViT.build_from_checkpoint(jax_vit_ckpt)
    m = ViT.build_from_checkpoint(jax_vit_ckpt, device="cpu")
    assert m.config.mode == "vit" and m.num_parameters == jm.num_parameters
    x, y = _images(m.config, 12)
    assert m.forward(x) == -1.0 and jm.forward(x) == -1.0
    np.testing.assert_allclose(m.logits.numpy(), np.asarray(jm.logits),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(m.forward(x, y), jm.forward(x, y), rtol=2e-5)
    grads = m.backward()
    assert not grads["wte"].any()
    _assert_grads(grads, jm.backward())


def test_vit_optimizer_step_and_train_step_match_jax(jax_vit_ckpt):
    """forward + backward + optimizer_step is train_step in the port, and
    train_step matches the JAX model's (AdamW with decay, the checkpoint's
    step count and moments)."""
    jm = JaxViT.build_from_checkpoint(jax_vit_ckpt)
    m, m2 = (ViT.build_from_checkpoint(jax_vit_ckpt, device="cpu")
             for _ in range(2))
    x, y = _images(m.config, 13)
    m.forward(x, y)
    m.backward()
    m.optimizer_step(1e-3, weight_decay=0.05)
    loss = m2.train_step(x, y, 1e-3, weight_decay=0.05)
    np.testing.assert_allclose(loss, jm.train_step(x, y, 1e-3,
                                                   weight_decay=0.05),
                               rtol=2e-5)
    assert m.step == m2.step == jm.step == 1
    for k, w in jax.device_get(jm.params).items():
        assert torch.equal(m.params[k], m2.params[k]), k
        # qkvb's K third has a zero gradient up to fp32 noise, which an AdamW
        # step from zero moments magnifies to lr g / (|g| + eps): atol lr
        np.testing.assert_allclose(m2.params[k].numpy(), w, rtol=2e-5,
                                   atol=1e-3 if k == "qkvb" else 2e-5,
                                   err_msg=k)


def test_vit_port_checkpoint_loads_in_jax(tmp_path):
    _, tcfg = vit_cfgs(pool="mean")
    path = str(tmp_path / "t.bin")
    m = ViT.from_config(tcfg, seed=1, device="cpu")
    x, y = _images(tcfg, 13)
    m.train_step(x, y, 1e-3)
    m.save_checkpoint(path)
    jm = JaxViT.build_from_checkpoint(path)
    assert jm.config.mode == "vit" and jm.config.pool == "mean"
    assert jm.step == 1
    m.forward(x)
    jm.forward(x)
    np.testing.assert_allclose(m.logits.numpy(), np.asarray(jm.logits),
                               rtol=2e-5, atol=2e-5)
    back = ViT.build_from_checkpoint(path, device="cpu")
    assert all(torch.equal(back.params[k], m.params[k]) for k in m.params)
    assert all(torch.equal(back.m[k], m.m[k]) for k in m.m)


def test_vit_presets_build_with_the_jax_parameter_counts():
    for name, n in (("vit-s-16", 22_434_664), ("vit-b-16", 87_335_656)):
        assert TP.num_parameters(torch_config(name)) == n
        assert JP.num_parameters(jax_config(name)) == n
    m = ViT.from_config("vit-tiny-4-cifar10", num_layers=1, device="cpu")
    assert m.config.seq_len == 65


def test_vit_flops_copy_matches_the_original():
    for name in ("vit-s-16", "vit-b-16", "vit-tiny-4-cifar10"):
        tc, jc = torch_config(name), jax_config(name)
        assert TF.forward_flops_per_example(tc) == \
            JF.forward_flops_per_example(jc)
        assert TF.train_flops_per_example(tc) == JF.train_flops_per_example(jc)


def test_trainer_runs_a_tiny_vit_with_a_falling_loss(tmp_path):
    """16 images, one batch an epoch: the loss falls as the model fits
    them; then evaluation, and a resumed run."""
    tc = TL.TrainConfig(preset="vit-tiny-4-cifar10",
                        dataset="synthetic-shapes", dataset_size=16, steps=8, batch_size=16, lr=3e-3,
                        warmup=1, dtype="float32", log_every=1,
                        ckpt_every=0, workdir=str(tmp_path), device="cpu",
                        label_smoothing=0.1,
                        model_overrides=dict(num_layers=2, channels=64,
                                             num_heads=1))
    summary = TL.train(tc)
    recs = [__import__("json").loads(l)
            for l in open(tmp_path / "metrics.jsonl")]
    losses = [r["loss"] for r in recs]
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.2, losses
    assert all(r["loader_ms"] >= 0 and r["mfu"] is None for r in recs)
    # both rates are logged to 0.1
    assert recs[0]["tok_per_sec"] == pytest.approx(
        recs[0]["imgs_per_sec"] * 65, abs=0.05 * 65 + 0.05)
    ev = summary["eval"]
    assert ev["n"] == 16 and 0.0 <= ev["acc"] <= 1.0 and np.isfinite(ev["loss"])
    # resumes at its cursor and step
    tc.steps = 9
    TL.train(tc)
    assert len(open(tmp_path / "metrics.jsonl").readlines()) == 9


def test_evaluate_matches_jax():
    jcfg, tcfg = vit_cfgs(img_size=8, patch_size=2)
    arrs, jp = _params(tcfg, 14)
    ds = TD.synthetic_dataset(n=24, img_size=8, num_classes=10, seed=5)
    want = JL.evaluate(jcfg, jp, ds, batch=8)
    got = TL.evaluate(tcfg, TP.from_numpy(arrs, tcfg, "cpu"), ds, batch=8)
    assert got["n"] == want["n"] == 24
    assert got["acc"] == want["acc"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-5)


def test_train_cli_takes_the_vit_flags(tmp_path, capsys):
    train_cli.main(["--preset", "vit-tiny-4-cifar10", "--cpu", "--steps", "2",
                    "--batch-size", "8", "--dtype", "float32",
                    "--dataset", "synthetic-shapes", "--dataset-size", "16",
                    "--label-smoothing", "0.1", "--mixup-alpha", "0.2",
                    "--drop-path", "0.1", "--log-every", "1",
                    "--workdir", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.count("[train]") == 2 and "[eval]" in out
    train_cli.main(["--eval-only", "--cpu", "--workdir", str(tmp_path),
                    "--dataset", "synthetic-shapes", "--dataset-size", "16"])
    assert '"acc"' in capsys.readouterr().out


def test_trainer_refuses_gpt_mixup(tmp_path):
    tc = TL.TrainConfig(preset="gpt-nano", mixup_alpha=0.2, device="cpu",
                        workdir=str(tmp_path))
    with pytest.raises(ValueError, match="vit-mode"):
        TL.train(tc)


def test_infer_cli_on_the_cpu(capsys):
    infer_cli.main(["--preset", "vit-tiny-4-cifar10", "--cpu",
                    "--batch-size", "4", "--steps", "1", "--dtype",
                    "float32"])
    rec = __import__("json").loads(capsys.readouterr().out)
    assert rec["batch"] == 4 and rec["device"] == "cpu" and rec["value"] > 0
    assert rec["mfu"] is None and rec["unit"] == "images/sec/chip"
    res = infer_cli.run("vit-tiny-4-cifar10", batch_size=2, steps=1,
                        dtype="bfloat16", device="cpu")
    assert res["logits"].shape == (2, 10)
    assert bool(torch.isfinite(res["logits"]).all())


@pytest.mark.parametrize("quant", ["w8", "w8a8"])
def test_infer_cli_quant_raises_item_15(quant, capsys):
    """--quant, refused until ROADMAP.md item 15 was ported, runs on the
    CPU: the JSON line names the mode, and the logits are the int8
    forward's (models/quantized.vit_forward_q, held against JAX in
    tests/test_torch_quant.py) of the same weights, within the JAX
    package's bounds of the float forward (tests/test_quant.py: mean
    relative 0.04 for w8, 0.08 for w8a8)."""
    from vitrs_tpu_torch.models import quantized as TQ
    from vitrs_tpu_torch.ops import quant as TQT
    infer_cli.main(["--preset", "vit-tiny-4-cifar10", "--cpu", "--batch-size",
                    "2", "--steps", "1", "--dtype", "float32", "--quant",
                    quant])
    rec = __import__("json").loads(capsys.readouterr().out)
    assert rec["quant"] == quant and rec["metric"].endswith(f"({quant})")
    kw = dict(batch_size=3, steps=1, dtype="float32", device="cpu")
    got = infer_cli.run("vit-tiny-4-cifar10", quant=quant, **kw)["logits"]
    ref = infer_cli.run("vit-tiny-4-cifar10", **kw)["logits"]
    model = ViT.from_config("vit-tiny-4-cifar10", device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 32, 32, 3), dtype=np.float32))
    want = TQ.vit_forward_q(TQT.quantize_params(model.params, "vit"), x,
                            model.config, w8a8=quant == "w8a8")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    rel = ((got - ref).abs().mean() / ref.abs().mean()).item()
    assert rel < (0.08 if quant == "w8a8" else 0.04), rel


def test_infer_from_a_checkpoint_matches_jax_logits(jax_vit_ckpt):
    jm = JaxViT.build_from_checkpoint(jax_vit_ckpt)
    res = infer_cli.run(None, ckpt=jax_vit_ckpt, batch_size=3, steps=1,
                        dtype="float32", device="cpu")
    x = np.random.default_rng(0).standard_normal(
        (3, 16, 16, 3), dtype=np.float32)
    want = jax.jit(lambda p, v: JM.vit_forward(p, v, jm.config))(jm.params,
                                                                 x)
    np.testing.assert_allclose(res["logits"].numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# K1-fwd and K2 at vit's non-causal ragged lengths
# ---------------------------------------------------------------------------

NH, D = 2, 64
SCALE = 1.0 / math.sqrt(D)


def _qkv(T, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, T, 3 * NH * D), dtype=np.float32),
            rng.standard_normal((1, T, NH * D), dtype=np.float32))


@pytest.mark.parametrize("T", [17, 65, 197])
def test_plain_fwd_matches_single_tile_pallas_noncausal(T):
    qkv, _ = _qkv(T, T)
    x = jnp.asarray(qkv)
    assert T <= JFA.DEFAULT_BLOCK_Q          # the single-tile Pallas path
    out, lse = JFA._fwd_single(x, NH, SCALE, False, T, True)
    got, got_lse = TFA.flash_attention_fwd(torch.from_numpy(qkv), NH,
                                           causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse)[..., 0],
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("T", [17, 65, 197])
def test_plain_bwd_matches_single_tile_pallas_noncausal(T):
    qkv, do = _qkv(T, T + 1)
    x = jnp.asarray(qkv)
    out, lse = JFA._fwd_single(x, NH, SCALE, False, T, True)
    want = JFA._bwd_single(x, NH, out, lse, jnp.asarray(do), SCALE, False, T,
                           True)
    q, k, v = torch.from_numpy(qkv).split(NH * D, dim=-1)
    got = TFA.flash_bwd_plain(q, k, v, torch.from_numpy(np.asarray(out)),
                              torch.from_numpy(np.asarray(lse)[..., 0]),
                              torch.from_numpy(do), NH, False, SCALE)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5, err_msg=name)


def test_profiling_keeps_a_vit_preset_geometry():
    """utils/profiling.py's vit modes: the preset's own geometry (the gpt
    flags do not apply) in bf16, and a uint8 batch as the loader ships
    it."""
    import argparse
    from vitrs_tpu_torch.utils import profiling
    args = argparse.Namespace(preset="vit-b-16", kv_heads=4, max_seq_len=1024,
                              pos_emb="learned", window=0)
    cfg = profiling._config(args)
    assert (cfg.seq_len, cfg.kv_heads, cfg.dtype) == (197, 12, "bfloat16")
    x, y = profiling._images(cfg, 2)
    assert x.dtype == np.uint8 and x.shape == (2, 224, 224, 3)
    assert y.shape == (2,) and y.max() < 1000
    args.preset, args.kv_heads, args.max_seq_len = "gpt-nano", 1, 32
    gcfg = profiling._config(args)
    assert (gcfg.num_kv_heads, gcfg.max_seq_len) == (1, 32)
