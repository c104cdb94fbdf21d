"""PyTorch port: the native host components (vitrs_tpu_torch/native: the
build script and its copies of imagepipe.cpp, jpegpipe.cpp and ckptio.cpp)
and the native path of data/augment.py, against the JAX package's.

  * the build: each component compiles into vitrs_tpu_torch/_build/native
    and answers its ABI probe; a component that does not build is None,
    with the reason kept;
  * augment_batch, which takes the native library where it builds: bit for
    bit equal to the JAX package's augment_batch (its own native build)
    and, on the uint8 path, to both packages' NumPy paths; the float path
    within 2e-6 of NumPy's, the JAX package's own bound (the compiled code
    may contract x * a - m into one fused multiply-add); without the
    library, the NumPy path;
  * the result does not depend on the thread count."""

import os

import numpy as np
import pytest

from vitrs_tpu.data import augment as JA
from vitrs_tpu.data import datasets as JD
from vitrs_tpu_torch.data import augment as TA
from vitrs_tpu_torch.data import datasets as TD
from vitrs_tpu_torch.native import build

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def _images(n=40, hw=24, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, hw, hw, 3), dtype=np.uint8)


@pytest.mark.parametrize("name,abi_fn,abi", [
    ("imagepipe", "vitrs_imagepipe_abi", 2),
    ("jpegpipe", "vitrs_jpegpipe_abi", 1),
    ("ckptio", "vitrs_ckptio_abi", 1)])
def test_component_builds_into_the_ports_build_dir(name, abi_fn, abi):
    lib = build.load(name)
    assert lib is not None, build.ERRORS.get(name)
    assert getattr(lib, abi_fn)() == abi
    assert os.path.dirname(lib._name) == os.path.join(
        os.path.dirname(os.path.dirname(build.__file__)), "_build", "native")
    assert build.load(name) is lib          # loaded once a process


def test_a_missing_component_is_none_with_its_reason():
    assert build.load("no_such_component") is None
    assert "no source" in build.ERRORS["no_such_component"]


@pytest.mark.parametrize("crop_pad,flip,seed,epoch", [
    (0, False, 0, 0), (4, True, 5, 2), (2, True, 2**40 + 3, 7)])
def test_native_float_path_equals_jax(crop_pad, flip, seed, epoch):
    imgs = _images()
    idx = np.array([3, 0, 39, 7, 7, 12, 21], np.int64)
    args = dict(crop_pad=crop_pad, flip=flip, seed=seed, epoch=epoch,
                mean=MEAN, std=STD)
    assert TA.native_available()
    got = TA.augment_batch(imgs, idx, **args)
    np.testing.assert_array_equal(got, JA.augment_batch(imgs, idx, **args))
    # the JAX package's own bound between these two paths
    # (tests/test_data.py): the compiled x * a - m may round once, as a
    # fused multiply-add, which moves a value near 0 by up to 2e-6
    np.testing.assert_allclose(
        got, TA._augment_numpy(imgs, idx, crop_pad, int(flip), seed, epoch,
                               MEAN, STD), rtol=0, atol=2e-6)


@pytest.mark.parametrize("crop_pad,flip,seed,epoch", [
    (0, False, 0, 0), (4, True, 5, 2), (2, True, 2**40 + 3, 7)])
def test_native_uint8_path_equals_numpy_and_jax(crop_pad, flip, seed, epoch):
    imgs = _images()
    idx = np.array([3, 0, 39, 7, 7, 12, 21], np.int64)
    args = dict(crop_pad=crop_pad, flip=flip, seed=seed, epoch=epoch,
                out_uint8=True)
    assert TA.native_available()
    got = TA.augment_batch(imgs, idx, **args)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, TA._augment_numpy_u8(
        imgs, idx, crop_pad, int(flip), seed, epoch))
    np.testing.assert_array_equal(got, JA.augment_batch(imgs, idx, **args))


@pytest.mark.parametrize("out_uint8", [False, True])
def test_native_path_does_not_depend_on_threads(out_uint8):
    imgs = _images(n=64)
    idx = np.arange(48, dtype=np.int64)
    a, b = (TA.augment_batch(imgs, idx, crop_pad=4, flip=True, seed=1,
                             epoch=2, mean=MEAN, std=STD, nthreads=t,
                             out_uint8=out_uint8)
            for t in (1, 8))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("out_uint8", [False, True])
def test_without_the_library_the_numpy_path_serves(out_uint8, monkeypatch):
    monkeypatch.setattr(TA, "_lib", lambda: None)
    assert not TA.native_available()
    idx = np.arange(4, dtype=np.int64)
    out = TA.augment_batch(_images(), idx, crop_pad=2, flip=True, mean=MEAN,
                           std=STD, out_uint8=out_uint8)
    want = (JA._augment_numpy_u8(_images(), idx, 2, 1, 0, 0) if out_uint8
            else JA._augment_numpy(_images(), idx, 2, 1, 0, 0, MEAN, STD))
    np.testing.assert_array_equal(out, want)


def test_uint8_loader_through_the_native_path_equals_jax():
    """The training loop's vit loader (uint8 batches, normalised on the
    device) now crops and flips in the native library: the same batches as
    the JAX DataLoader, whose uint8 path is NumPy."""
    tds = TD.synthetic_dataset(n=48, img_size=16, seed=4)
    jds = JD.synthetic_dataset(n=48, img_size=16, seed=4)
    a = TD.DataLoader(tds, 16, seed=3, cursor=8, device_normalize=True)
    b = JD.DataLoader(jds, 16, seed=3, cursor=8, device_normalize=True)
    assert TA.native_available()
    for _ in range(4):
        (x1, y1), (x2, y2) = a.next_batch(), b.next_batch()
        np.testing.assert_array_equal(x1, x2)
        np.testing.assert_array_equal(y1, y2)
