"""Batch fetch + augment: the NumPy paths of `vitrs_tpu/data/augment.py`.

A copy, because importing the original runs `vitrs_tpu/__init__.py`, which
imports jax; the port's tests pin the two equal.  The original's ctypes
branch over the native `imagepipe` library is left out: that library and
its build script wait for the ImageNet slice, so `augment_batch` always
takes the NumPy path here, which computes what the native one does.

Randomness contract (as imagepipe.cpp's): each sample's augmentation
derives from splitmix64(seed, epoch, dataset_index) only, so it does not
depend on thread schedules and a resumed run repeats it."""

from __future__ import annotations

from typing import Optional

import numpy as np

_MASK = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


def _reflect(i: np.ndarray, n: int) -> np.ndarray:
    i = np.abs(i)
    i = np.where(i >= n, 2 * n - 2 - i, i)
    return np.clip(i, 0, n - 1)


def _sample_geometry(idx, crop_pad, flip, seed, epoch, H, W):
    """(rows, cols) index vectors of one sample's crop and flip."""
    s = _splitmix64(seed ^ _splitmix64(epoch ^ _splitmix64(int(idx))))
    dy = dx = 0
    do_flip = 0
    if crop_pad > 0:
        s = _splitmix64(s)
        dy = int(s % (2 * crop_pad + 1)) - crop_pad
        s = _splitmix64(s)
        dx = int(s % (2 * crop_pad + 1)) - crop_pad
    if flip:
        s = _splitmix64(s)
        do_flip = int(s & 1)
    ys = _reflect(np.arange(H) + dy, H)
    xs = np.arange(W) + dx
    if do_flip:
        xs = (W - 1) - xs
    return ys, _reflect(xs, W)


def _augment_numpy(images, indices, crop_pad, flip, seed, epoch, mean, std):
    n = len(indices)
    H, W, C = images.shape[1:]
    out = np.empty((n, H, W, C), np.float32)
    inv = 1.0 / std
    for i, idx in enumerate(indices):
        ys, xs = _sample_geometry(idx, crop_pad, flip, seed, epoch, H, W)
        img = images[idx][np.ix_(ys, xs)].astype(np.float32)
        out[i] = (img * (1.0 / 255.0) - mean) * inv
    return out


def _augment_numpy_u8(images, indices, crop_pad, flip, seed, epoch):
    """Geometry-only augment (crop/flip), uint8 in -> uint8 out, with the
    per-sample RNG of `_augment_numpy`, so a run is the same whether it
    normalises on the host or on the device."""
    n = len(indices)
    H, W, C = images.shape[1:]
    out = np.empty((n, H, W, C), np.uint8)
    for i, idx in enumerate(indices):
        ys, xs = _sample_geometry(idx, crop_pad, flip, seed, epoch, H, W)
        out[i] = images[idx][np.ix_(ys, xs)]
    return out


def augment_batch(images: np.ndarray, indices: np.ndarray,
                  crop_pad: int = 0, flip: bool = False,
                  seed: int = 0, epoch: int = 0,
                  mean: Optional[np.ndarray] = None,
                  std: Optional[np.ndarray] = None,
                  out_uint8: bool = False) -> np.ndarray:
    """(num_total, H, W, C) uint8 + indices -> (n, H, W, C) float32,
    normalised with mean/std.  out_uint8=True skips the normalisation and
    returns uint8 (4x fewer bytes to the device, which normalises)."""
    assert images.dtype == np.uint8 and images.ndim == 4
    indices = np.ascontiguousarray(indices, np.int64)
    images = np.ascontiguousarray(images)
    if out_uint8:
        return _augment_numpy_u8(images, indices, crop_pad, int(flip), seed,
                                 epoch)
    C = images.shape[3]
    mean = np.asarray(mean if mean is not None else np.zeros(C), np.float32)
    std = np.asarray(std if std is not None else np.ones(C), np.float32)
    return _augment_numpy(images, indices, crop_pad, int(flip), seed, epoch,
                          mean, std)
