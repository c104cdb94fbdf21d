"""Datasets + deterministic, resumable dataloader: a copy of
`vitrs_tpu/data/datasets.py`.

The original needs no JAX but cannot be imported without
`vitrs_tpu/__init__.py` importing it; the port's tests pin the two equal.
ImageNet's streaming shards are `data/imagenet.py`.

Design:
  * datasets are in-memory uint8 (N, H, W, C) + int64 labels;
  * iteration order is a pure function of (seed, epoch): a fresh permutation
    per epoch, so a run resumed from `cursor` (global example count) replays
    the exact same batches;
  * multi-host sharding by (host_id, num_hosts) stride over the permutation;
  * augmentation goes through data/augment.py.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np

from . import augment as A

CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@dataclass
class Dataset:
    images: np.ndarray            # (N, H, W, C) uint8
    labels: np.ndarray            # (N,) int64
    num_classes: int
    mean: np.ndarray
    std: np.ndarray

    def __len__(self):
        return len(self.images)


def load_cifar10(data_dir: str, train: bool = True) -> Dataset:
    """Reads the python-pickle CIFAR-10 layout (cifar-10-batches-py)."""
    names = ([f"data_batch_{i}" for i in range(1, 6)] if train
             else ["test_batch"])
    xs, ys = [], []
    for name in names:
        with open(os.path.join(data_dir, name), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xs.append(np.asarray(d[b"data"], np.uint8))
        ys.append(np.asarray(d[b"labels"], np.int64))
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return Dataset(np.ascontiguousarray(x), np.concatenate(ys), 10,
                   CIFAR10_MEAN, CIFAR10_STD)


def synthetic_dataset(n: int = 4096, img_size: int = 32, num_classes: int = 10,
                      seed: int = 0) -> Dataset:
    """Procedural stand-in when no real data is on disk:
    class-conditional frequency patterns + noise, so training genuinely has
    signal to learn and loss curves are meaningful."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, n)
    yy, xx = np.mgrid[0:img_size, 0:img_size].astype(np.float32) / img_size
    imgs = np.empty((n, img_size, img_size, 3), np.uint8)
    for c in range(num_classes):
        idx = np.where(labels == c)[0]
        fx, fy = 1 + c % 4, 1 + (c // 4) % 4
        base = 0.5 + 0.35 * np.sin(2 * np.pi * (fx * xx + fy * yy) + c)
        pat = np.stack([np.roll(base, s * 3, axis=1) for s in range(3)], -1)
        noise = rng.normal(0, 0.12, (len(idx), img_size, img_size, 3))
        imgs[idx] = np.clip((pat[None] + noise) * 255, 0, 255).astype(np.uint8)
    return Dataset(imgs, labels, num_classes, CIFAR10_MEAN, CIFAR10_STD)


def synthetic_shapes(n: int = 20000, img_size: int = 32, seed: int = 0
                     ) -> Dataset:
    """Procedural 10-class shape-recognition task.

    Unlike `synthetic_dataset` (global frequency patterns, linearly
    separable), class identity here is the *geometry* of a shape drawn at a
    random position/scale/color on a random background with pixel noise — a
    classifier must learn translation/scale-invariant spatial features, so
    held-out top-1 on fresh samples is a meaningful generalization number,
    and MAE reconstruction pretraining on it learns reusable structure.
    Classes: circle, ring, square, square-outline, triangle, diamond, plus,
    X-cross, h-bars, v-bars.
    """
    rng = np.random.default_rng(seed)
    S = img_size
    yy, xx = np.mgrid[0:S, 0:S].astype(np.float32)
    labels = rng.integers(0, 10, n).astype(np.int64)
    imgs = np.empty((n, S, S, 3), np.uint8)
    cx = rng.uniform(0.30 * S, 0.70 * S, n)
    cy = rng.uniform(0.30 * S, 0.70 * S, n)
    r = rng.uniform(0.15 * S, 0.33 * S, n)
    fg = rng.uniform(0.55, 1.0, (n, 3))
    bg = rng.uniform(0.0, 0.35, (n, 3))
    noise_sig = 0.08
    for i in range(n):
        dx, dy = xx - cx[i], yy - cy[i]
        ri = r[i]
        ax, ay = np.abs(dx), np.abs(dy)
        c = labels[i]
        if c == 0:                                    # circle
            mask = dx * dx + dy * dy < ri * ri
        elif c == 1:                                  # ring
            d2 = dx * dx + dy * dy
            mask = (d2 < ri * ri) & (d2 > (0.55 * ri) ** 2)
        elif c == 2:                                  # square
            mask = np.maximum(ax, ay) < 0.8 * ri
        elif c == 3:                                  # square outline
            m = np.maximum(ax, ay)
            mask = (m < 0.85 * ri) & (m > 0.5 * ri)
        elif c == 4:                                  # triangle (apex up)
            mask = (dy > -0.75 * ri) & (dy < 0.75 * ri) & \
                   (ax < (dy + 0.75 * ri) * 0.6)
        elif c == 5:                                  # diamond
            mask = ax + ay < ri
        elif c == 6:                                  # plus
            mask = ((ax < 0.28 * ri) & (ay < ri)) | \
                   ((ay < 0.28 * ri) & (ax < ri))
        elif c == 7:                                  # X cross
            mask = (np.abs(ax - ay) < 0.35 * ri) & (np.maximum(ax, ay) < ri)
        elif c == 8:                                  # horizontal bars
            mask = (ax < ri) & (ay < ri) & \
                   (np.mod(dy + ri, 0.66 * ri) < 0.3 * ri)
        else:                                         # vertical bars
            mask = (ax < ri) & (ay < ri) & \
                   (np.mod(dx + ri, 0.66 * ri) < 0.3 * ri)
        img = np.where(mask[..., None], fg[i], bg[i])
        img = img + rng.normal(0, noise_sig, (S, S, 3))
        imgs[i] = np.clip(img * 255, 0, 255).astype(np.uint8)
    return Dataset(imgs, labels, 10, CIFAR10_MEAN, CIFAR10_STD)


def get_dataset(name: str, data_dir: Optional[str] = None, train: bool = True,
                **kw) -> Dataset:
    if name == "cifar10":
        if data_dir and os.path.exists(os.path.join(data_dir, "data_batch_1")):
            return load_cifar10(data_dir, train)
        return synthetic_dataset(n=4096 if train else 512, img_size=32,
                                 num_classes=10, seed=0 if train else 1)
    if name == "synthetic-shapes":
        return synthetic_shapes(n=kw.get("n", 20000 if train else 2000),
                                img_size=kw.get("img_size", 32),
                                seed=0 if train else 1)
    if name == "synthetic-imagenet":
        return synthetic_dataset(n=kw.get("n", 2048),
                                 img_size=kw.get("img_size", 224),
                                 num_classes=kw.get("num_classes", 1000),
                                 seed=0 if train else 1)
    raise ValueError(f"unknown dataset {name}")


class DataLoader:
    """Deterministic epoch-permutation loader with a resumable cursor.

    cursor counts *global* examples consumed (across all hosts); state is
    fully recoverable from (seed, cursor) — no RNG object needs serializing.
    """

    def __init__(self, ds: Dataset, batch_size: int, seed: int = 0,
                 train: bool = True, crop_pad: int = 4,
                 host_id: int = 0, num_hosts: int = 1,
                 cursor: int = 0, nthreads: int = 0,
                 device_normalize: bool = False):
        assert batch_size % num_hosts == 0
        self.ds = ds
        self.global_batch = batch_size
        self.local_batch = batch_size // num_hosts
        self.seed = seed
        self.train = train
        self.crop_pad = crop_pad if train else 0
        self.flip = train
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.cursor = cursor
        self.nthreads = nthreads
        # device_normalize: ship uint8 batches (4x less H2D traffic) and let
        # the train step fold (x/255 - mean)/std on device; same per-sample
        # augment RNG, so runs are bitwise-reproducible either way
        self.device_normalize = device_normalize
        self.steps_per_epoch = len(ds) // self.global_batch

    def _perm(self, epoch: int) -> np.ndarray:
        if not self.train:
            return np.arange(len(self.ds))
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch])).permutation(len(self.ds))

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        n = len(self.ds)
        usable = self.steps_per_epoch * self.global_batch
        epoch = self.cursor // usable
        offset = self.cursor % usable
        perm = self._perm(epoch)
        sel = perm[offset:offset + self.global_batch]
        # host shard: stride slice of the global batch
        sel = sel[self.host_id::self.num_hosts]
        images = A.augment_batch(self.ds.images, sel, crop_pad=self.crop_pad,
                                 flip=self.flip, seed=self.seed, epoch=epoch,
                                 mean=self.ds.mean, std=self.ds.std,
                                 nthreads=self.nthreads,
                                 out_uint8=self.device_normalize)
        labels = self.ds.labels[sel]
        self.cursor += self.global_batch
        return images, labels

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            yield self.next_batch()
