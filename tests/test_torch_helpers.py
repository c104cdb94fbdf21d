"""Shared inputs for the PyTorch port's parity tests (tests/test_torch_*.py):
numpy-seeded parameters handed to both packages, and a small GPT config
whose head_dim is 64, so that its attention takes the flash path."""

import numpy as np
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


def test_np_params_cover_the_canonical_layout():
    _, tcfg = small_cfgs()
    arrs = np_params(tcfg)
    assert tuple(arrs) == TP.tensor_order(tcfg)
    assert all(arrs[k].shape == s for k, s in TP.param_shapes(tcfg).items())
