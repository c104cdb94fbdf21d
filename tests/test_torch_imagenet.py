"""PyTorch port: the streaming ImageNet shards (data/imagenet.py) against
the JAX package's module, on the CPU.

  * the `.vshard` format: shards written by either package read by the
    other, the synthetic shards of both byte-identical, garbage refused;
  * decode_augment_batch through the native jpegpipe (each package its
    own build of the same source): bit for bit equal to JAX's, train with
    and without RandAugment, and the eval transform; the PIL path equal to
    JAX's PIL path; a corrupt blob zero-filled;
  * StreamingLoader: the same batches, the same epoch order (a permutation
    of every sample), the same cursor resume; the decoder it ran recorded;
  * a vit-tiny loop over tiny shards: the first loss, from one checkpoint
    both loops warm-start from, within rtol 2e-5 of the JAX loop's (fp32;
    the port's plain flash route against JAX's dense CPU attention), and
    evaluate_streaming over the val split."""

import io
import os

import numpy as np
import pytest

from vitrs_tpu.data import imagenet as JIN
from vitrs_tpu_torch.data import imagenet as TIN
from vitrs_tpu_torch.data.datasets import synthetic_dataset


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tshards"))
    TIN.build_synthetic_shards(d, n_shards=3, per_shard=24, img_size=48,
                               num_classes=10, seed=0)
    TIN.build_synthetic_shards(d, n_shards=1, per_shard=16, img_size=48,
                               num_classes=10, seed=9, split="val")
    return d


def _blobs(n=5, size=32, seed=3):
    from PIL import Image
    ds = synthetic_dataset(n=n, img_size=size, seed=seed)
    out = []
    for i in range(n):
        bio = io.BytesIO()
        Image.fromarray(ds.images[i]).save(bio, format="JPEG", quality=95)
        out.append(bio.getvalue())
    return out, [int(y) for y in ds.labels[:n]]


@pytest.mark.parametrize("writer,reader", [(TIN, JIN), (JIN, TIN)],
                         ids=["port-writes", "jax-writes"])
def test_shards_read_across_packages(writer, reader, tmp_path):
    blobs, labels = _blobs()
    path = str(tmp_path / "x.vshard")
    writer.write_shard(path, blobs, labels)
    sh = reader.Shard(path)
    assert sh.n == 5
    np.testing.assert_array_equal(sh.labels, np.asarray(labels, np.int32))
    assert [sh.blob(i) for i in range(5)] == blobs


def test_synthetic_shards_are_byte_identical(tmp_path):
    for mod, name in ((TIN, "t"), (JIN, "j")):
        mod.build_synthetic_shards(str(tmp_path / name), n_shards=2,
                                   per_shard=6, img_size=32, seed=1)
    for k in range(2):
        f = f"train-{k:05d}.vshard"
        with open(tmp_path / "t" / f, "rb") as a, \
                open(tmp_path / "j" / f, "rb") as b:
            assert a.read() == b.read()


def test_shard_rejects_garbage(tmp_path):
    p = str(tmp_path / "bad.vshard")
    with open(p, "wb") as f:
        f.write(b"NOTASHARDxxxx")
    with pytest.raises(ValueError, match="not a vshard"):
        TIN.Shard(p)


def _batch(shard_dir, n=6):
    sh = TIN.Shard(os.path.join(shard_dir, "train-00000.vshard"))
    buf = sh.blobs()[:int(sh.offsets[n])]
    return buf, np.asarray(sh.offsets[:n + 1], np.int64), np.arange(n) + 100


@pytest.mark.parametrize("train,ra_ops,ra_mag", [
    (True, 0, 0.0), (True, 2, 0.7), (False, 0, 0.0)])
def test_native_decode_augment_equals_jax(shard_dir, train, ra_ops, ra_mag):
    assert TIN.native_available()
    buf, off, ids = _batch(shard_dir)
    args = (buf, off, ids, 32, train, 7, 3)
    kw = dict(ra_ops=ra_ops, ra_mag=ra_mag, eval_resize=36)
    got = TIN.decode_augment_batch(*args, **kw)
    assert got.shape == (6, 32, 32, 3) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, JIN.decode_augment_batch(*args, **kw))


@pytest.mark.parametrize("train", [True, False])
def test_pil_decode_equals_jax_pil(shard_dir, train):
    buf, off, ids = _batch(shard_dir, 4)
    got, want = (mod._decode_augment_pil(
        buf, off, ids, 32, train, 1, 0, 36, mod.IMAGENET_MEAN,
        mod.IMAGENET_STD, np.empty((4, 32, 32, 3), np.float32))
        for mod in (TIN, JIN))
    np.testing.assert_array_equal(got, want)


def test_corrupt_blob_is_zero_filled():
    buf = np.frombuffer(b"\xff\xd8garbage-not-a-jpeg", np.uint8)
    off = np.array([0, len(buf)], np.int64)
    out = TIN.decode_augment_batch(buf, off, np.array([0], np.int64), 32,
                                   True, 0, 0)
    assert (out == 0).all()


def test_streaming_batches_and_resume_equal_jax(shard_dir):
    tds, jds = TIN.ShardedImageNet(shard_dir), JIN.ShardedImageNet(shard_dir)
    assert tds.total == jds.total == 72 and tds.num_classes == jds.num_classes
    a = TIN.StreamingLoader(tds, 16, 32, train=True, seed=5, ra_ops=1,
                            ra_mag=0.3)
    b = JIN.StreamingLoader(jds, 16, 32, train=True, seed=5, ra_ops=1,
                            ra_mag=0.3)
    batches = []
    for _ in range(5):                  # past the first epoch's 4 batches
        (x1, y1), (x2, y2) = a.next_batch(), b.next_batch()
        np.testing.assert_array_equal(x1, x2)
        np.testing.assert_array_equal(y1, y2)
        batches.append((x1, y1))
    c = TIN.StreamingLoader(tds, 16, 32, train=True, seed=5, cursor=2 * 16,
                            ra_ops=1, ra_mag=0.3)
    for x, y in batches[2:]:
        x3, y3 = c.next_batch()
        np.testing.assert_array_equal(x, x3)
        np.testing.assert_array_equal(y, y3)
    assert a.cursor == b.cursor == 80 and c.cursor == 80


def test_epoch_order_covers_every_sample_and_equals_jax(shard_dir):
    tds = TIN.ShardedImageNet(shard_dir)
    ld = TIN.StreamingLoader(tds, 24, 32, train=True, seed=2)
    jld = JIN.StreamingLoader(JIN.ShardedImageNet(shard_dir), 24, 32,
                              train=True, seed=2)
    orders = []
    for epoch in (0, 1):
        so, io_ = ld._epoch_order(epoch)
        jso, jio = jld._epoch_order(epoch)
        np.testing.assert_array_equal(so, jso)
        np.testing.assert_array_equal(io_, jio)
        ids = tds.bases[so] + io_
        assert sorted(ids.tolist()) == list(range(tds.total))
        orders.append(ids)
    assert not np.array_equal(*orders)


def test_eval_loader_equals_jax(shard_dir):
    tds = TIN.ShardedImageNet(shard_dir, split="val")
    a = TIN.StreamingLoader(tds, 8, 32, train=False)
    b = JIN.StreamingLoader(JIN.ShardedImageNet(shard_dir, split="val"), 8,
                            32, train=False)
    assert a.steps_per_epoch == 2
    x1, y1 = a.next_batch()
    x2, y2 = b.next_batch()
    np.testing.assert_array_equal(x1, x2)
    np.testing.assert_array_equal(y1, y2)
    np.testing.assert_array_equal(y1, tds.shards[0].labels[:8])
    assert a.decoder == "native"


def test_without_the_library_the_loader_records_pil(shard_dir, monkeypatch):
    """Without the native library the loader decodes with PIL (the JAX
    package's fallback) and says so; PIL's bilinear resampler is close to
    the native one, not equal (the JAX package's bound)."""
    ds = TIN.ShardedImageNet(shard_dir, split="val")
    x_native, _ = TIN.StreamingLoader(ds, 8, 32, train=False).next_batch()
    monkeypatch.setattr(TIN, "_lib", lambda: None)
    pil = TIN.StreamingLoader(ds, 8, 32, train=False)
    assert pil.decoder == "pil"
    assert np.mean(np.abs(pil.next_batch()[0] - x_native)) * 0.226 * 255 < 6.0


def test_pack_imagenet_tree_equals_jax(tmp_path):
    from PIL import Image
    ds = synthetic_dataset(n=12, img_size=32, num_classes=3, seed=4)
    src = tmp_path / "raw"
    for i in range(12):
        d = src / "train" / f"n{int(ds.labels[i]):08d}"
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(ds.images[i]).save(str(d / f"img_{i}.JPEG"),
                                           quality=92)
    assert TIN.pack_imagenet(str(src), str(tmp_path / "t"), per_shard=5,
                             verbose=False) == 3
    JIN.pack_imagenet(str(src), str(tmp_path / "j"), per_shard=5,
                      verbose=False)
    for k in range(3):
        f = f"train-{k:05d}.vshard"
        with open(tmp_path / "t" / f, "rb") as a, \
                open(tmp_path / "j" / f, "rb") as b:
            assert a.read() == b.read()
    packed = TIN.ShardedImageNet(str(tmp_path / "t"))
    assert packed.total == 12 and packed.num_classes == 3


def test_vit_tiny_loop_over_shards_first_loss_equals_jax(shard_dir, tmp_path):
    """One step of each package's loop on dataset="imagenet" from the same
    warm-start checkpoint: the same batch (native decode, RandAugment),
    the same weights, so the same first loss; then each loop's
    evaluate_streaming over the 16-image val split."""
    from vitrs_tpu.train import loop as JL
    from vitrs_tpu_torch import checkpoint as TC
    from vitrs_tpu_torch.config import get_config
    from vitrs_tpu_torch.train import loop as TL
    from test_torch_helpers import np_params
    over = dict(num_layers=2, channels=128, num_heads=2, img_size=32,
                patch_size=8, num_classes=10)
    cfg = get_config("vit-tiny-4-cifar10").replace(**over)
    init = str(tmp_path / "init.bin")
    TC.save_checkpoint(init, np_params(cfg, seed=1), cfg)
    common = dict(preset="vit-tiny-4-cifar10", dataset="imagenet",
                  data_dir=shard_dir, steps=1, batch_size=8, lr=1e-3,
                  warmup=1, dtype="float32", log_every=1, ckpt_every=0,
                  seed=0, ra_ops=2, ra_mag=0.5, init_ckpt=init)
    t = TL.train(TL.TrainConfig(workdir=str(tmp_path / "t"), device="cpu",
                                model_overrides=over, **common))
    j = JL.train(JL.TrainConfig(workdir=str(tmp_path / "j"),
                                model_overrides=dict(over, use_flash=False),
                                **common))
    np.testing.assert_allclose(t["final_loss"], j["final_loss"], rtol=2e-5)
    assert t["eval"]["n"] == j["eval"]["n"] == 16
    np.testing.assert_allclose(t["eval"]["loss"], j["eval"]["loss"],
                               rtol=2e-4)
