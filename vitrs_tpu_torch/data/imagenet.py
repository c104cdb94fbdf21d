"""ImageNet-scale data path: sharded JPEG storage + streaming loader — a
copy of `vitrs_tpu/data/imagenet.py` (which needs no JAX but cannot be
imported without `vitrs_tpu/__init__.py` importing it; the port's tests
pin the two equal: shards either package writes, the native decode bit
for bit, batches and cursor resume).

The port's addition: the loader records which decoder runs (`decoder`:
"native" or "pil"; the training loop's log prints it), so a run that fell
to PIL says so.  Design:

  * **Shard format** (`.vshard`): magic + version + n, int32 labels[n],
    int64 blob offsets[n+1], concatenated raw JPEG bytes.  Full ImageNet-1k
    packs into ~1300 shards of 1k images; shards are the unit of streaming
    (never the whole dataset) so memory stays O(shard), not O(dataset).
  * **Streaming order**: per epoch, a seeded permutation of shards and a
    seeded permutation within each shard — the standard shuffle-window
    compromise.  The whole iteration order is a pure function of
    (seed, epoch), so a run resumed from `cursor` (global samples consumed)
    replays the exact same batches — SURVEY.md §5.3 deterministic resume.
  * **Decode + augment**: native/jpegpipe.cpp (libjpeg + fused-affine
    RandomResizedCrop/flip/RandAugment, one bilinear pass), threaded; PIL
    fallback when the native component is unavailable (same structure, not
    bit-matched — the native path is the contract).
  * **Host sharding**: each host takes a stride slice of the global batch,
    like datasets.DataLoader.
"""

from __future__ import annotations

import ctypes
import glob
import io
import os
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..native import build
from .datasets import IMAGENET_MEAN, IMAGENET_STD

_MAGIC = b"VITRSHRD"
_VERSION = 1
_MASK = (1 << 64) - 1


# ---------------------------------------------------------------------------
# shard format
# ---------------------------------------------------------------------------

def write_shard(path: str, blobs: Sequence[bytes], labels: Sequence[int]):
    """Write one shard: JPEG byte strings + int labels."""
    assert len(blobs) == len(labels) and len(blobs) > 0
    offsets = np.zeros(len(blobs) + 1, np.int64)
    for i, b in enumerate(blobs):
        offsets[i + 1] = offsets[i] + len(b)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<ii", _VERSION, len(blobs)))
        f.write(np.asarray(labels, np.int32).tobytes())
        f.write(offsets.tobytes())
        for b in blobs:
            f.write(b)
    os.replace(tmp, path)


class Shard:
    """Header-eager, blob-lazy shard reader."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            if f.read(8) != _MAGIC:
                raise ValueError(f"not a vshard file: {path}")
            version, n = struct.unpack("<ii", f.read(8))
            if version != _VERSION:
                raise ValueError(f"unsupported shard version {version}")
            self.n = n
            self.labels = np.frombuffer(f.read(4 * n), np.int32)
            self.offsets = np.frombuffer(f.read(8 * (n + 1)), np.int64)
            self._blob_start = f.tell()
        self._blobs: Optional[np.ndarray] = None

    def blobs(self) -> np.ndarray:
        """The whole blob region as a uint8 array (loaded once, cached)."""
        if self._blobs is None:
            total = int(self.offsets[-1])
            with open(self.path, "rb") as f:
                f.seek(self._blob_start)
                self._blobs = np.frombuffer(f.read(total), np.uint8)
        return self._blobs

    def release(self):
        self._blobs = None

    def blob(self, i: int) -> bytes:
        b = self.blobs()
        return b[int(self.offsets[i]):int(self.offsets[i + 1])].tobytes()


# ---------------------------------------------------------------------------
# native pipeline binding (+ PIL fallback)
# ---------------------------------------------------------------------------

def _lib():
    lib = build.load("jpegpipe")
    if lib is not None:
        try:
            if lib.vitrs_jpegpipe_abi() != 1:
                return None
        except Exception:
            return None
    return lib


def native_available() -> bool:
    return _lib() is not None


def decode_augment_batch(blob_buf: np.ndarray, offsets: np.ndarray,
                         sample_ids: np.ndarray, img_size: int,
                         train: bool, seed: int, epoch: int,
                         ra_ops: int = 0, ra_mag: float = 0.0,
                         eval_resize: int = 256,
                         mean: np.ndarray = IMAGENET_MEAN,
                         std: np.ndarray = IMAGENET_STD,
                         nthreads: int = 0) -> np.ndarray:
    """(concatenated JPEG bytes, offsets (n+1), ids (n)) -> (n,S,S,3) f32."""
    n = len(sample_ids)
    out = np.empty((n, img_size, img_size, 3), np.float32)
    lib = _lib()
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    if lib is not None:
        if nthreads <= 0:
            nthreads = min(os.cpu_count() or 1, 16)
        rc = lib.vitrs_jpeg_pipeline(
            np.ascontiguousarray(blob_buf).ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint8)),
            np.ascontiguousarray(offsets, np.int64).ctypes.data_as(
                ctypes.POINTER(ctypes.c_int64)),
            np.ascontiguousarray(sample_ids, np.int64).ctypes.data_as(
                ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int(n), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_int(img_size), ctypes.c_int(int(train)),
            ctypes.c_int(ra_ops), ctypes.c_float(ra_mag),
            ctypes.c_uint64(seed & _MASK), ctypes.c_uint64(epoch & _MASK),
            mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_int(eval_resize), ctypes.c_int(nthreads))
        if rc < 0:
            raise RuntimeError(f"vitrs_jpeg_pipeline failed rc={rc}")
        return out
    return _decode_augment_pil(blob_buf, offsets, sample_ids, img_size, train,
                               seed, epoch, eval_resize, mean, std, out)


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


def _decode_augment_pil(blob_buf, offsets, sample_ids, S, train, seed, epoch,
                        eval_resize, mean, std, out):
    """PIL fallback: same pipeline shape (RRC/flip train, resize+crop eval),
    deterministic from the same per-sample seeds.  Pixel values are NOT
    bit-matched to the native path (different resamplers)."""
    from PIL import Image
    buf = np.ascontiguousarray(blob_buf).tobytes()
    inv = 1.0 / std
    for i, sid in enumerate(sample_ids):
        raw = buf[int(offsets[i]):int(offsets[i + 1])]
        try:
            img = Image.open(io.BytesIO(raw)).convert("RGB")
        except Exception:
            out[i] = 0.0
            continue
        W, H = img.size
        s = _splitmix64(seed ^ _splitmix64(epoch ^ _splitmix64(int(sid))))

        def unif():
            nonlocal s
            s = _splitmix64(s)
            return (s >> 40) * (1.0 / 16777216.0)

        if train:
            area = W * H
            box = None
            for _ in range(10):
                target = area * (0.08 + unif() * 0.92)
                ratio = np.exp(np.log(3 / 4) + unif() * (np.log(4 / 3)
                                                         - np.log(3 / 4)))
                w = int(round(np.sqrt(target * ratio)))
                h = int(round(np.sqrt(target / ratio)))
                if 0 < w <= W and 0 < h <= H:
                    s = _splitmix64(s)
                    x0 = int(s % (W - w + 1))
                    s = _splitmix64(s)
                    y0 = int(s % (H - h + 1))
                    box = (x0, y0, x0 + w, y0 + h)
                    break
            if box is None:
                side = min(W, H)
                box = ((W - side) // 2, (H - side) // 2,
                       (W - side) // 2 + side, (H - side) // 2 + side)
            img = img.resize((S, S), Image.BILINEAR, box=box)
            s = _splitmix64(s)
            if s & 1:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
        else:
            side = min(W, H) * S / eval_resize
            x0 = (W - side) / 2
            y0 = (H - side) / 2
            img = img.resize((S, S), Image.BILINEAR,
                             box=(x0, y0, x0 + side, y0 + side))
        arr = np.asarray(img, np.float32)
        out[i] = (arr * (1.0 / 255.0) - mean) * inv
    return out


# ---------------------------------------------------------------------------
# streaming loader
# ---------------------------------------------------------------------------

class ShardedImageNet:
    """Directory of .vshard files; header-only scan at init."""

    def __init__(self, shard_dir: str, split: str = "train"):
        pattern = os.path.join(shard_dir, f"{split}*.vshard")
        self.paths = sorted(glob.glob(pattern))
        if not self.paths:
            raise FileNotFoundError(f"no shards matching {pattern}")
        self.shards = [Shard(p) for p in self.paths]
        self.counts = np.array([s.n for s in self.shards], np.int64)
        self.bases = np.concatenate([[0], np.cumsum(self.counts)])
        self.total = int(self.bases[-1])
        self.num_classes = int(max(int(s.labels.max()) for s in self.shards)) + 1
        self.mean, self.std = IMAGENET_MEAN, IMAGENET_STD

    def __len__(self):
        return self.total


class StreamingLoader:
    """Deterministic, cursor-resumable loader over sharded JPEG data.

    Iteration order per epoch: seeded shard permutation x seeded within-shard
    permutation (shuffle window = shard).  Eval (`train=False`) iterates
    sequentially.  Only the shards touched by the current batch are resident
    (small LRU), so memory is O(shard size), never O(dataset).
    """

    def __init__(self, ds: ShardedImageNet, batch_size: int, img_size: int,
                 train: bool = True, seed: int = 0, cursor: int = 0,
                 host_id: int = 0, num_hosts: int = 1,
                 ra_ops: int = 0, ra_mag: float = 0.0, eval_resize: int = 0,
                 nthreads: int = 0, resident_shards: int = 3):
        assert batch_size % num_hosts == 0
        self.decoder = "native" if native_available() else "pil"
        self.ds = ds
        self.global_batch = batch_size
        self.local_batch = batch_size // num_hosts
        self.img_size = img_size
        self.train = train
        self.seed = seed
        self.cursor = cursor
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.ra_ops = ra_ops
        self.ra_mag = ra_mag
        self.eval_resize = eval_resize or int(img_size * 256 / 224)
        self.nthreads = nthreads
        self.resident = resident_shards
        self.steps_per_epoch = ds.total // batch_size
        self._epoch_cache: Tuple[int, np.ndarray, np.ndarray] = (-1, None, None)
        self._lru: Dict[int, Shard] = {}

    # -- deterministic epoch order ---------------------------------------
    def _epoch_order(self, epoch: int) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (shard_of_pos, idx_of_pos) arrays for the whole epoch —
        the virtual order is fully materialized as two int arrays (a few MB
        for ImageNet-1k), NOT the data."""
        if self._epoch_cache[0] == epoch:
            return self._epoch_cache[1], self._epoch_cache[2]
        n_shards = len(self.ds.shards)
        if self.train:
            rs = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch, 0xD5]))
            shard_order = rs.permutation(n_shards)
        else:
            shard_order = np.arange(n_shards)
        shard_of, idx_of = [], []
        for k in shard_order:
            n = int(self.ds.counts[k])
            if self.train:
                ri = np.random.default_rng(
                    np.random.SeedSequence([self.seed, epoch, int(k)]))
                order = ri.permutation(n)
            else:
                order = np.arange(n)
            shard_of.append(np.full(n, k, np.int32))
            idx_of.append(order.astype(np.int32))
        so = np.concatenate(shard_of)
        io_ = np.concatenate(idx_of)
        self._epoch_cache = (epoch, so, io_)
        return so, io_

    def _get_shard(self, k: int) -> Shard:
        s = self.ds.shards[k]
        if k not in self._lru:
            self._lru[k] = s
            s.blobs()
            while len(self._lru) > self.resident:
                old = next(iter(self._lru))
                if old == k:
                    break
                self._lru.pop(old).release()
        return s

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        usable = self.steps_per_epoch * self.global_batch
        epoch = self.cursor // usable
        offset = self.cursor % usable
        shard_of, idx_of = self._epoch_order(epoch)
        pos = np.arange(offset, offset + self.global_batch)
        pos = pos[self.host_id::self.num_hosts]        # host stride slice
        ks = shard_of[pos]
        idxs = idx_of[pos]
        # gather blobs into one contiguous buffer
        parts: List[np.ndarray] = []
        labels = np.empty(len(pos), np.int64)
        sample_ids = np.empty(len(pos), np.int64)
        offsets = np.zeros(len(pos) + 1, np.int64)
        for i, (k, idx) in enumerate(zip(ks, idxs)):
            sh = self._get_shard(int(k))
            b = sh.blobs()
            lo, hi = int(sh.offsets[idx]), int(sh.offsets[idx + 1])
            parts.append(b[lo:hi])
            offsets[i + 1] = offsets[i] + (hi - lo)
            labels[i] = int(sh.labels[idx])
            sample_ids[i] = int(self.ds.bases[k]) + int(idx)
        buf = np.concatenate(parts) if parts else np.empty(0, np.uint8)
        images = decode_augment_batch(
            buf, offsets, sample_ids, self.img_size, self.train, self.seed,
            epoch, ra_ops=self.ra_ops, ra_mag=self.ra_mag,
            eval_resize=self.eval_resize, mean=self.ds.mean, std=self.ds.std,
            nthreads=self.nthreads)
        self.cursor += self.global_batch
        return images, labels

    def __iter__(self):
        while True:
            yield self.next_batch()


# ---------------------------------------------------------------------------
# synthetic shards (zero-egress demo / tests)
# ---------------------------------------------------------------------------

def pack_imagenet(src_dir: str, out_dir: str, split: str = "train",
                  per_shard: int = 1024, verbose: bool = True):
    """Pack a raw ImageNet directory tree (<src>/<split>/<wnid>/*.JPEG) into
    .vshard files.  Class ids are assigned by sorted wnid (the torchvision
    convention).  JPEG bytes are stored verbatim — no re-encode."""
    split_dir = os.path.join(src_dir, split)
    classes = sorted(d for d in os.listdir(split_dir)
                     if os.path.isdir(os.path.join(split_dir, d)))
    cls_id = {c: i for i, c in enumerate(classes)}
    files: List[Tuple[str, int]] = []
    for c in classes:
        for f in sorted(os.listdir(os.path.join(split_dir, c))):
            if f.lower().endswith((".jpeg", ".jpg")):
                files.append((os.path.join(split_dir, c, f), cls_id[c]))
    # deterministic interleave so every shard mixes classes
    rng = np.random.default_rng(0)
    order = rng.permutation(len(files))
    os.makedirs(out_dir, exist_ok=True)
    k = 0
    for start in range(0, len(files) - per_shard + 1, per_shard):
        blobs, labels = [], []
        for j in order[start:start + per_shard]:
            path, lbl = files[j]
            with open(path, "rb") as f:
                blobs.append(f.read())
            labels.append(lbl)
        write_shard(os.path.join(out_dir, f"{split}-{k:05d}.vshard"),
                    blobs, labels)
        if verbose:
            print(f"[pack] {split}-{k:05d}.vshard ({per_shard} images)")
        k += 1
    tail = len(files) % per_shard
    if tail:
        blobs, labels = [], []
        for j in order[len(files) - tail:]:
            path, lbl = files[j]
            with open(path, "rb") as f:
                blobs.append(f.read())
            labels.append(lbl)
        write_shard(os.path.join(out_dir, f"{split}-{k:05d}.vshard"),
                    blobs, labels)
        k += 1
    if verbose:
        print(f"[pack] {len(files)} images -> {k} shards in {out_dir}")
    return k


def build_synthetic_shards(out_dir: str, n_shards: int = 2,
                           per_shard: int = 64, img_size: int = 64,
                           num_classes: int = 10, seed: int = 0,
                           split: str = "train", quality: int = 90):
    """JPEG-encode the synthetic class-pattern dataset into real shards so
    the full decode path is exercised without ImageNet on disk."""
    from PIL import Image
    from .datasets import synthetic_dataset
    os.makedirs(out_dir, exist_ok=True)
    ds = synthetic_dataset(n=n_shards * per_shard, img_size=img_size,
                           num_classes=num_classes, seed=seed)
    for k in range(n_shards):
        blobs = []
        sel = range(k * per_shard, (k + 1) * per_shard)
        for i in sel:
            bio = io.BytesIO()
            Image.fromarray(ds.images[i]).save(bio, format="JPEG",
                                               quality=quality)
            blobs.append(bio.getvalue())
        write_shard(os.path.join(out_dir, f"{split}-{k:05d}.vshard"),
                    blobs, [int(ds.labels[i]) for i in sel])
    return out_dir
