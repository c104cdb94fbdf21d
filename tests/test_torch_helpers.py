"""Shared inputs for the PyTorch port's parity tests (tests/test_torch_*.py):
numpy-seeded parameters handed to both packages, and a small GPT config
whose head_dim is 64, so that its attention takes the flash path."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vitrs_tpu.config import get_config as jax_config
from vitrs_tpu_torch import params as TP
from vitrs_tpu_torch.config import get_config as torch_config

SMALL = dict(num_layers=2, num_heads=2, channels=128, vocab_size=97,
             max_seq_len=64)


def small_cfgs(**overrides):
    """The same small config from both packages: (jax cfg, torch cfg)."""
    kw = dict(SMALL, **overrides)
    return (jax_config("gpt-nano").replace(**kw),
            torch_config("gpt-nano").replace(**kw))


def np_params(cfg, seed=0):
    """Every canonical tensor drawn from numpy: weights N(0, 0.05), LN
    scales 1 + N(0, 0.1), biases N(0, 0.02) (non-zero, so they count)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shp in TP.param_shapes(cfg).items():
        if name in ("ln1w", "ln2w", "lnfw"):
            a = 1.0 + 0.1 * rng.standard_normal(shp)
        elif name.endswith("b"):
            a = 0.02 * rng.standard_normal(shp)
        else:
            a = 0.05 * rng.standard_normal(shp)
        out[name] = a.astype(np.float32)
    return out


def both_params(jcfg, tcfg, seed=0):
    """(jax param dict, torch param dict) holding the same numbers."""
    import jax.numpy as jnp
    arrs = np_params(tcfg, seed)
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            TP.from_numpy(arrs, tcfg, "cpu", torch.float32))


@pytest.fixture
def one_torch_thread():
    """Run a test with one intra-op thread, then restore the count.  A test
    whose code runs torch ops in two threads at once (the prefetcher's and
    the step's) starts two OpenMP teams; with the suite's six workers on
    eight cores their spin-waits made one such test 231 s instead of 2.3 s
    (six copies at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_np_params_cover_the_canonical_layout():
    _, tcfg = small_cfgs()
    arrs = np_params(tcfg)
    assert tuple(arrs) == TP.tensor_order(tcfg)
    assert all(arrs[k].shape == s for k, s in TP.param_shapes(tcfg).items())


def spawn_ranks(name, world, d, job, inputs=None, timeout=300):
    """Run `tests/torch_dist_worker.py name` as `world` gloo CPU ranks in
    directory d (job: the worker's job.json; inputs: arrays for its
    inputs.npz); returns each rank's outputs.  Each rank runs torch on one
    thread: the suite's workers share the machine's cores."""
    return start_ranks(name, world, d, job, inputs, timeout)()


def start_ranks(name, world, d, job, inputs=None, timeout=300):
    """`spawn_ranks` without waiting: starts the ranks and returns a
    function that waits for them and returns their outputs, so that a test
    computes its JAX references while the ranks run."""
    d = str(d)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "job.json"), "w") as f:
        json.dump(job, f)
    if inputs is not None:
        np.savez(os.path.join(d, "inputs.npz"), **inputs)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(here), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(here, "torch_dist_worker.py"), name,
         str(r), str(world), d], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env) for r in range(world)]

    def finish():
        try:
            logs = [p.communicate(timeout=timeout)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"rank {r} of {name}:\n{log[-4000:]}"
        return [dict(np.load(os.path.join(d, f"out_{name}_{r}.npz")))
                for r in range(world)]
    return finish


def assert_params_close(got, want, cfg, rtol, atol, grads=None, lr=0.0):
    """got, want: canonical name -> array.  The k third of qkvb has an
    exactly-zero gradient in exact arithmetic (softmax ignores a shift of
    every key's score), so both packages step on fp32 noise there, which
    AdamW's g / |g| and Adafactor's g rsqrt(v) scale to a full step: it is
    left out, as tests/test_torch_adafactor.py does.  grads, lr: the step's
    gradients and AdamW lr; where |g| < 1e-6 (fp32 noise) a first AdamW
    step moves a value by up to lr, so those values are held within lr
    (tests/test_torch_muon.py's rule)."""
    C = cfg.channels
    for k, w in want.items():
        g, w = np.asarray(got[k], np.float32), np.asarray(w, np.float32)
        tol = np.full(w.shape, atol, np.float32)
        if grads is not None:
            tol[np.abs(np.asarray(grads[k])) < 1e-6] = lr
        if k == "qkvb":
            g, w, tol = (np.concatenate([a[..., :C], a[..., 2 * C:]], -1)
                         for a in (g, w, tol))
        bad = np.abs(g - w) > tol + rtol * np.abs(w)
        assert not bad.any(), (f"{k}: {bad.sum()} of {w.size} values differ,"
                               f" max {np.abs(g - w)[bad].max():.3e}")
