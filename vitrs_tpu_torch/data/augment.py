"""Batch fetch + augment: a copy of `vitrs_tpu/data/augment.py`, the
ctypes binding over the native pipeline (native/imagepipe.cpp, threaded)
with the NumPy paths beside it.

A copy, because importing the original runs `vitrs_tpu/__init__.py`, which
imports jax; the port's tests pin the two equal, and the native path equal
to the NumPy one bit for bit.  As in the JAX package, `augment_batch` takes
the native library when it builds and the NumPy path when it does not
(`native_available()` says which).  The port's copy of imagepipe.cpp also
serves `out_uint8=True` (crop and flip only, the train step normalising
on the device), which the JAX package computes in NumPy: so the vit
loader's crop and flip run native in the port's training loop.

Randomness contract (as imagepipe.cpp's): each sample's augmentation
derives from splitmix64(seed, epoch, dataset_index) only, so it does not
depend on thread schedules and a resumed run repeats it."""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from ..native import build

_MASK = (1 << 64) - 1
_U8 = ctypes.POINTER(ctypes.c_uint8)
_I64 = ctypes.POINTER(ctypes.c_int64)
_F32 = ctypes.POINTER(ctypes.c_float)


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


def _lib():
    lib = build.load("imagepipe")
    if lib is not None:
        try:
            if lib.vitrs_imagepipe_abi() != 2:
                return None
        except Exception:
            return None
    return lib


def native_available() -> bool:
    return _lib() is not None


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
                  nthreads: int = 0, out_uint8: bool = False) -> np.ndarray:
    """(num_total, H, W, C) uint8 + indices -> (n, H, W, C) float32,
    normalised with mean/std.  out_uint8=True skips the normalisation and
    returns uint8 (4x fewer bytes to the device, which normalises)."""
    assert images.dtype == np.uint8 and images.ndim == 4
    indices = np.ascontiguousarray(indices, np.int64)
    images = np.ascontiguousarray(images)
    H, W, C = images.shape[1:]
    lib = _lib()
    n = len(indices)
    if nthreads <= 0:
        nthreads = min(os.cpu_count() or 1, 16)
    if out_uint8:
        if lib is None:
            return _augment_numpy_u8(images, indices, crop_pad, int(flip),
                                     seed, epoch)
        out = np.empty((n, H, W, C), np.uint8)
        rc = lib.vitrs_augment_batch_u8(
            images.ctypes.data_as(_U8), indices.ctypes.data_as(_I64),
            ctypes.c_int(n), ctypes.c_int(H), ctypes.c_int(W),
            ctypes.c_int(C), out.ctypes.data_as(_U8),
            ctypes.c_int(crop_pad), ctypes.c_int(int(flip)),
            ctypes.c_uint64(seed & _MASK), ctypes.c_uint64(epoch & _MASK),
            ctypes.c_int(nthreads))
        if rc != 0:
            raise RuntimeError(f"vitrs_augment_batch_u8 failed rc={rc}")
        return out
    mean = np.asarray(mean if mean is not None else np.zeros(C), np.float32)
    std = np.asarray(std if std is not None else np.ones(C), np.float32)
    if lib is None:
        return _augment_numpy(images, indices, crop_pad, int(flip), seed,
                              epoch, mean, std)
    out = np.empty((n, H, W, C), np.float32)
    rc = lib.vitrs_augment_batch(
        images.ctypes.data_as(_U8), indices.ctypes.data_as(_I64),
        ctypes.c_int(n), ctypes.c_int(H), ctypes.c_int(W), ctypes.c_int(C),
        out.ctypes.data_as(_F32),
        ctypes.c_int(crop_pad), ctypes.c_int(int(flip)),
        ctypes.c_uint64(seed & _MASK), ctypes.c_uint64(epoch & _MASK),
        mean.ctypes.data_as(_F32), std.ctypes.data_as(_F32),
        ctypes.c_int(nthreads))
    if rc != 0:
        raise RuntimeError(f"vitrs_augment_batch failed rc={rc}")
    return out
