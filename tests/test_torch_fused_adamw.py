"""PyTorch port: K7's plain version (ops/fused_adamw.py) against the Pallas
AdamW kernel in interpret mode, and the optimizer functions of
ops/optimizer.py against the JAX package's.

Tolerance for the flat update: rtol 2e-5, atol 1e-7, the JAX suite's own
for its kernel against the jnp form (tests/test_fused_adamw.py:31)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitrs_tpu.ops import optimizer as JO
from vitrs_tpu.ops.fused_adamw import adamw_pallas
from vitrs_tpu_torch.ops import fused_adamw as TF
from vitrs_tpu_torch.ops import optimizer as TO


def _rand(n, seed):
    rng = np.random.default_rng(seed)
    p, g, m = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    v = rng.random(n).astype(np.float32)
    return p, g, m, v


@pytest.mark.parametrize("step,wd", [(1, 0.0), (3, 0.1), (1000, 0.05)])
def test_plain_matches_pallas(step, wd):
    n = 3001            # ragged: not a multiple of 4 or of the 128 lanes
    p, g, m, v = _rand(n, step)
    want = adamw_pallas(*(jnp.asarray(a) for a in (p, g, m, v)),
                        jnp.asarray(step, jnp.int32),
                        jnp.asarray(1e-3, jnp.float32), weight_decay=wd,
                        interpret=True)
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    got = TF.adamw_plain(tp, torch.from_numpy(g), tm, tv, step, 1e-3,
                         weight_decay=wd)
    assert got[0] is tp and got[1] is tm and got[2] is tv   # in place
    for name, a, b in zip("pmv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=1e-7, err_msg=name)


def test_plain_takes_bf16_grads():
    p, g, m, v = _rand(64, 9)
    gb = torch.from_numpy(g).to(torch.bfloat16)
    a = TF.adamw_plain(*(torch.from_numpy(x.copy()) for x in (p,)), gb,
                       torch.from_numpy(m.copy()), torch.from_numpy(v.copy()),
                       2, 1e-3)
    b = TF.adamw_plain(torch.from_numpy(p.copy()), gb.float(),
                       torch.from_numpy(m.copy()), torch.from_numpy(v.copy()),
                       2, 1e-3)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_adamw_step_routes_cpu_to_the_plain_version_and_refuses_cuda_off_card():
    p, g, m, v = (torch.from_numpy(a) for a in _rand(10, 1))
    want = TF.adamw_plain(p.clone(), g, m.clone(), v.clone(), 1, 1e-2)
    got = TO.adamw_step(p, g, m, v, 1, 1e-2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        TF.adamw_cuda(p, g, m, v, 1, 1e-2)


def test_sgd_matches_jax():
    p, g, _, _ = _rand(100, 2)
    want = np.asarray(JO.sgd_step(jnp.asarray(p), jnp.asarray(g), 0.5))
    got = TO.sgd_step(torch.from_numpy(p.copy()), torch.from_numpy(g), 0.5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_tree_matches_jax(state_dtype):
    rng = np.random.default_rng(3)
    shapes = {"w": (4, 6), "b": (6,), "s": (2, 3, 6)}
    arr = {k: {n: rng.standard_normal(s).astype(np.float32) for n, s in
               shapes.items()} for k in ("p", "g", "m")}
    arr["v"] = {n: rng.random(s).astype(np.float32) for n, s in shapes.items()}
    jdt, tdt = jnp.dtype(state_dtype), getattr(torch, state_dtype)
    mask = JO.decay_mask_2d(arr["p"])
    assert mask == TO.decay_mask_2d({n: torch.from_numpy(a)
                                     for n, a in arr["p"].items()})
    want = JO.adamw_tree(
        {n: jnp.asarray(a) for n, a in arr["p"].items()},
        {n: jnp.asarray(a) for n, a in arr["g"].items()},
        {n: jnp.asarray(a, jdt) for n, a in arr["m"].items()},
        {n: jnp.asarray(a, jdt) for n, a in arr["v"].items()},
        jnp.asarray(4, jnp.int32), jnp.asarray(1e-2, jnp.float32),
        weight_decay=0.1, decay_mask=mask)
    got = TO.adamw_tree(
        {n: torch.from_numpy(a) for n, a in arr["p"].items()},
        {n: torch.from_numpy(a) for n, a in arr["g"].items()},
        {n: torch.from_numpy(a).to(tdt) for n, a in arr["m"].items()},
        {n: torch.from_numpy(a).to(tdt) for n, a in arr["v"].items()},
        4, 1e-2, weight_decay=0.1, decay_mask=mask)
    tol = 2e-5 if state_dtype == "float32" else 1e-2
    for w_tree, g_tree in zip(want, got):
        for n in shapes:
            assert g_tree[n].dtype == (torch.float32 if w_tree is want[0]
                                       else tdt)
            np.testing.assert_allclose(g_tree[n].float().numpy(),
                                       np.asarray(w_tree[n], np.float32),
                                       rtol=tol, atol=1e-7, err_msg=n)


@pytest.mark.parametrize("step", [0, 5, 100, 950, 1000, 1200])
def test_schedules_match_jax(step):
    args = (step, 6e-4, 100, 1000)
    assert TO.cosine_lr_host(*args, min_lr=6e-5) == \
        JO.cosine_lr_host(*args, min_lr=6e-5)
    assert TO.wsd_lr_host(*args, decay_frac=0.2) == \
        JO.wsd_lr_host(*args, decay_frac=0.2)
