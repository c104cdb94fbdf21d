"""PyTorch port: the prefetcher (data/prefetch.py) on the CPU, where its
thread hands each batch over with no copy, and the training loop behind it.

  * batches come in the loader's order, as tensors over the loader's
    arrays, with the host seconds each took;
  * a loader's exception surfaces on the next `next()`, after the batches
    made before it; a loader that ends stops the iteration;
  * `close()` joins the thread, also while the loader is slow;
  * the loop's losses and checkpoints are the same bits with the
    prefetcher (depth 2, the default) and without it (prefetch=0), and the
    log keeps `loader_ms` and adds `wait_ms`.
The card's stream, event and pinned-buffer order is checked on the card
(tests/test_torch_train_cuda.py)."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from vitrs_tpu_torch.data import datasets as TD
from vitrs_tpu_torch.data.prefetch import DevicePrefetcher
from vitrs_tpu_torch.train import loop as TL


class Counting:
    """A loader of numbered batches: raises ValueError at batch `fail_at`,
    sleeps `delay` s a batch, and ends (StopIteration) after `stop`."""

    def __init__(self, fail_at=None, delay=0.0, stop=None):
        self.i, self.fail_at, self.delay, self.stop = 0, fail_at, delay, stop

    def next_batch(self):
        if self.i == self.fail_at:
            raise ValueError(f"bad batch {self.i}")
        if self.stop is not None and self.i >= self.stop:
            raise StopIteration
        time.sleep(self.delay)
        x = np.full((2, 3), self.i, np.float32)
        y = np.array([self.i, -self.i], np.int64)
        self.i += 1
        return x, y


def test_batches_keep_the_loaders_order():
    pf = DevicePrefetcher(Counting(delay=0.001), "cpu")
    try:
        for i in range(6):
            x, y = next(pf)
            assert isinstance(x, torch.Tensor) and x.dtype == torch.float32
            assert bool((x == i).all()) and y.tolist() == [i, -i]
            assert pf.last_load_s >= 0.0
    finally:
        pf.close()


def test_a_loader_error_surfaces_after_the_batches_before_it():
    pf = DevicePrefetcher(Counting(fail_at=3), "cpu")
    try:
        assert [int(next(pf)[0][0, 0]) for _ in range(3)] == [0, 1, 2]
        with pytest.raises(ValueError, match="bad batch 3"):
            next(pf)
    finally:
        pf.close()


def test_a_loader_that_ends_stops_the_iteration():
    pf = DevicePrefetcher(Counting(stop=2), "cpu")
    try:
        assert [int(x[0, 0]) for x, _ in pf] == [0, 1]
    finally:
        pf.close()


@pytest.mark.parametrize("delay", [0.0, 0.3])
def test_close_joins_the_thread(delay):
    pf = DevicePrefetcher(Counting(delay=delay), "cpu", depth=2)
    next(pf)
    t0 = time.perf_counter()
    pf.close()
    assert not pf._thread.is_alive()
    assert time.perf_counter() - t0 < 5.0
    assert threading.active_count() < 50


def test_depth_bounds_the_batches_made_ahead():
    loader = Counting()
    pf = DevicePrefetcher(loader, "cpu", depth=2)
    try:
        next(pf)
        time.sleep(0.3)
        # one taken, two queued, one made and waiting for room
        assert loader.i <= 1 + 2 + 1
    finally:
        pf.close()


def test_real_loader_batches_equal_the_loaders_own():
    ds = TD.synthetic_dataset(n=64, img_size=16, num_classes=4)
    pf = DevicePrefetcher(TD.DataLoader(ds, 16, seed=1, cursor=8,
                                        device_normalize=True), "cpu")
    ref = TD.DataLoader(ds, 16, seed=1, cursor=8, device_normalize=True)
    try:
        for _ in range(5):
            (x, y), (rx, ry) = next(pf), ref.next_batch()
            assert x.dtype == torch.uint8
            np.testing.assert_array_equal(x.numpy(), rx)
            np.testing.assert_array_equal(y.numpy(), ry)
    finally:
        pf.close()


@pytest.mark.parametrize("preset", ["gpt-nano", "vit-tiny-4-cifar10"])
def test_loop_is_the_same_with_and_without_the_prefetcher(preset, tmp_path):
    over = (dict(num_layers=2, channels=64, num_heads=2, img_size=16,
                 patch_size=4) if preset.startswith("vit") else None)
    out = {}
    for prefetch in (2, 0):
        work = str(tmp_path / str(prefetch))
        s = TL.train(TL.TrainConfig(
            preset=preset, dataset="synthetic-shapes" if over else "",
            dataset_size=64, steps=4, batch_size=8, lr=1e-3, warmup=1,
            dtype="float32", log_every=1, ckpt_every=2, workdir=work,
            device="cpu", prefetch=prefetch, model_overrides=over))
        with open(os.path.join(work, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        assert all(r["loader_ms"] >= 0 and r["wait_ms"] >= 0 for r in recs)
        with open(os.path.join(work, "ckpt_00000004.bin"), "rb") as f:
            out[prefetch] = ([r["loss"] for r in recs], s["final_loss"],
                             f.read())
    assert out[2] == out[0]
