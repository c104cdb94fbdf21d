"""3-D parallelism (tp=2,pp=2 on 4 gloo CPU ranks, tests/torch_dist_worker.py)
against the JAX package's dp=1,tp=2,pp=2 mesh and one-device gradients on
the same numpy parameters and batch (tests/test_threed.py's tolerances:
loss rtol 2e-5, gradients rtol 5e-4, atol 3e-5 of the leaf's largest),
plain and with SP and VP, and the Adafactor 3-D step; `make_plan`'s
routing; and a `--mesh tp=2` run saved on two ranks resumed under pp=2."""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from vitrs_tpu.config import get_config as jax_config
from vitrs_tpu.models import model as JM
from vitrs_tpu.ops import adafactor as JAF
from vitrs_tpu.ops import optimizer as JOPT
from vitrs_tpu.parallel import tensor_parallel as JTP
from vitrs_tpu.parallel import threed as JTD
from vitrs_tpu_torch import checkpoint as TCK
from vitrs_tpu_torch.config import get_config
from vitrs_tpu_torch.parallel import threed as TTD
from test_torch_helpers import (assert_params_close, np_params, spawn_ranks,
                                start_ranks)

B = 8
DATA = {
    "gpt": ("gpt-nano", dict(num_layers=4, num_heads=2, channels=128,
                             vocab_size=97, max_seq_len=16)),
    "vit": ("vit-tiny-4-cifar10", dict(num_layers=4, channels=32,
                                       num_heads=2)),
}
LR, WD, AF_LR = 1e-3, 0.1, 0.01


def _var(name, data, mesh, opt="adamw", **kw):
    preset, ovr = DATA[data]
    return dict(name=name, data=data, preset=preset, overrides=ovr,
                mesh=mesh, opt=opt, step=1,
                lr=AF_LR if opt == "adafactor" else LR, seventh=WD, **kw)


VARIANTS = [
    _var("plain", "gpt", "tp=2,pp=2"),
    _var("sp", "gpt", "tp=2,pp=2,sp,mb=4"),
    _var("vp", "gpt", "tp=2,pp=2,vp"),
    _var("spvp", "gpt", "tp=2,pp=2,sp,vp"),
    _var("vit", "vit", "tp=2,pp=2,mb=4"),
    _var("af", "gpt", "tp=2,pp=2,sp", "adafactor"),
    _var("af_vp", "gpt", "tp=2,pp=2,vp", "adafactor"),
    _var("knobs", "gpt", "tp=2,pp=2,vp", knobs=dict(
        accum_steps=2, clip_norm=0.05, log_grad_norm=True)),
]
NAMES = [v["name"] for v in VARIANTS]


def _cfgs(data):
    preset, ovr = DATA[data]
    return (jax_config(preset, use_flash=False).replace(**ovr),
            get_config(preset).replace(**ovr))


def _var_of(name):
    return next(v for v in VARIANTS if v["name"] == name)


def _inputs():
    out = {}
    for data in DATA:
        _, tcfg = _cfgs(data)
        rng = np.random.default_rng(7)
        for k, v in np_params(tcfg, seed=7).items():
            out[f"p/{data}/{k}"] = v
        if tcfg.mode == "vit":
            out[f"x/{data}"] = rng.standard_normal(
                (B, 32, 32, 3)).astype(np.float32)
            out[f"y/{data}"] = rng.integers(0, 10, (B,)).astype(np.int32)
        else:
            out[f"x/{data}"] = rng.integers(0, 97, (B, 16)).astype(np.int32)
            out[f"y/{data}"] = rng.integers(0, 97, (B, 16)).astype(np.int32)
    return out


def _params(inputs, data):
    return {k[len(data) + 3:]: jnp.asarray(v) for k, v in inputs.items()
            if k.startswith(f"p/{data}/")}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    inputs = _inputs()
    wait = start_ranks("mesh_step", 4, tmp_path_factory.mktemp("3d"),
                       {"preset": "gpt-nano", "variants": VARIANTS}, inputs)
    ref = {}
    for data in DATA:
        jcfg, _ = _cfgs(data)
        p = _params(inputs, data)
        loss, g = jax.value_and_grad(JM.loss_fn)(
            p, jnp.asarray(inputs[f"x/{data}"]),
            jnp.asarray(inputs[f"y/{data}"]), jcfg)
        ref[data] = (float(loss), jax.device_get(g), p)
    return inputs, ref, wait()


def _get(out, name, what):
    pre = f"{name}/{what}/"
    return {k[len(pre):]: v for k, v in out.items() if k.startswith(pre)}


@pytest.mark.parametrize("name", NAMES)
def test_3d_loss_and_grads_match_jax(run, name):
    inputs, ref, outs = run
    var = _var_of(name)
    loss, g, _ = ref[var["data"]]
    for out in outs:
        assert str(out[f"{name}/kind"]) == "3d"
        np.testing.assert_allclose(out[f"{name}/loss"], loss, rtol=2e-5)
        if var.get("knobs"):
            continue
        got = _get(out, name, "g")
        assert set(got) == set(g)
        for k, want in g.items():
            want = np.asarray(want)
            scale = max(np.abs(want).max(), 1e-6)
            np.testing.assert_allclose(got[k], want, rtol=5e-4,
                                       atol=3e-5 * scale, err_msg=k)


def _one_device_step(var, ref):
    jcfg, _ = _cfgs(var["data"])
    _, g, p = ref[var["data"]]
    knobs = var.get("knobs", {})
    vp = "vp" in var["mesh"]

    def update(p, g):
        if knobs.get("clip_norm"):
            norm = jnp.sqrt(sum(jnp.sum(jnp.square(t)) for t in g.values()))
            s = jnp.minimum(1.0, knobs["clip_norm"] / (norm + 1e-6))
            g = {k: t * s for k, t in g.items()}
        if var["opt"] == "adamw":
            m = {k: jnp.zeros_like(t) for k, t in p.items()}
            return JOPT.adamw_tree(p, g, m, dict(m), jnp.asarray(1), LR,
                                   weight_decay=WD)[0]
        tpp, tg = (JTP.to_tp_params(t, jcfg, vp) for t in (p, g))
        fac, _ = JTD.threed_af_factored(jcfg, vp)
        st = JAF.AdafactorState(
            *({k: jnp.zeros(shape(t.shape, fac[k]), jnp.float32)
               for k, t in tpp.items()} for shape in (
                lambda s, f: s[:-1] if f else (),
                lambda s, f: s[:-2] + s[-1:] if f else (),
                lambda s, f: () if f else s)), {})
        new = JAF.step(tpp, tg, st, jnp.asarray(1), AF_LR, weight_decay=WD,
                       decay_mask=JOPT.decay_mask_2d(tpp), factored=fac)[0]
        return JTP.from_tp_params(new, jcfg, vp)

    return jax.device_get(jax.jit(update)(p, g))


@pytest.mark.parametrize("name", NAMES)
def test_3d_step_matches_jax_one_device(run, name):
    inputs, ref, outs = run
    var = _var_of(name)
    _, tcfg = _cfgs(var["data"])
    want = _one_device_step(var, ref)
    tol = (dict(rtol=1e-4, atol=2e-4, lr=AF_LR) if var["opt"] == "adafactor"
           else dict(rtol=2e-4, atol=5e-5, lr=LR))
    for out in outs:
        assert_params_close(_get(out, name, "p"), want, tcfg,
                            grads=ref[var["data"]][1], **tol)
        if var.get("knobs"):
            g = ref[var["data"]][1]
            norm = np.sqrt(sum(np.sum(np.square(np.asarray(t, np.float64)))
                               for t in g.values()))
            np.testing.assert_allclose(out[f"{name}/gnorm"], norm, rtol=1e-3)


@pytest.mark.parametrize("name", ["spvp", "af"])
def test_3d_step_matches_the_jax_3d_step(run, name):
    """The same step through the JAX package's 3-D factory on a
    dp=1,tp=2,pp=2 mesh (AdamW with SP and VP; Adafactor with SP)."""
    inputs, ref, outs = run
    var = _var_of(name)
    jcfg, tcfg = _cfgs(var["data"])
    sp, vp = "sp" in var["mesh"], "vp" in var["mesh"]
    jm = JTD.make_mesh_3d(1, 2, 2)
    pnp = {k: np.asarray(v) for k, v in _params(inputs, "gpt").items()}
    placed = JTD.place_params_3d(pnp, jcfg, jm, vp)
    sh = NamedSharding(jm, P("data"))
    x = jax.device_put(jnp.asarray(inputs["x/gpt"]), sh)
    y = jax.device_put(jnp.asarray(inputs["y/gpt"]), sh)
    t = jnp.asarray(1, jnp.int32)
    if var["opt"] == "adafactor":
        st = JTD.init_af_state_3d(placed, jm, jcfg, vp)
        out = JTD.make_3d_train_step_adafactor(jcfg, jm, 2, sp, vp)(
            placed, st, x, y, t, jnp.asarray(AF_LR), jnp.asarray(WD))
    else:
        m, v = JTD.init_opt_state_3d(placed, jm, jcfg, vp)
        out = JTD.make_3d_train_step(jcfg, jm, 2, sp, vp)(
            placed, m, v, x, y, t, jnp.asarray(LR), jnp.asarray(WD))
    want = JTP.from_tp_params(jax.device_get(out[0]), jcfg, vp)
    lr = AF_LR if var["opt"] == "adafactor" else LR
    for o in outs:
        np.testing.assert_allclose(o[f"{name}/loss"], float(out[-1]),
                                   rtol=2e-5)
        assert_params_close(_get(o, name, "p"), want, tcfg, rtol=2e-4,
                            atol=2e-4, grads=ref["gpt"][1], lr=lr)


def test_3d_specs_match_jax():
    jcfg, tcfg = _cfgs("gpt")
    for vp in (False, True):
        got = TTD.param_specs_3d(tcfg, vp)
        want = JTD.param_specs_3d(jcfg, vp)
        assert {k: tuple(s) for k, s in got.items()} == \
            {k: tuple(s) for k, s in want.items()}
        fac, _ = TTD.threed_af_factored(tcfg, vp, min_factor=2)
        jfac, _ = JTD.threed_af_factored(jcfg, vp, min_factor=2)
        assert fac == jfac


# --- the loop: a tp=2 checkpoint resumes under pp=2 ---------------------------

OVR = {"num_layers": 2, "num_heads": 2, "channels": 32, "vocab_size": 97,
       "max_seq_len": 16}


def _tc(workdir, mesh, **kw):
    base = dict(preset="gpt-nano", dataset="synthetic", steps=4,
                batch_size=8, lr=1e-2, warmup=1, weight_decay=0.0,
                dtype="float32", workdir=workdir, log_every=1, ckpt_every=0,
                mesh=mesh, device="cpu", prefetch=0, model_overrides=OVR,
                clip_norm=1.0, log_grad_norm=True)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """tp=2 straight for 4 steps; tp=2 for 2 steps, then pp=2 from its
    checkpoint to step 4."""
    out = {}
    for name, parts in (("tp", [("tp=2", {})]),
                        ("resume", [("tp=2", dict(run_steps=2,
                                                  ckpt_every=2)),
                                    ("pp=2", dict(ckpt_every=2))])):
        d = tmp_path_factory.mktemp(name)
        wd = str(d / "work")
        for i, (mesh, kw) in enumerate(parts):
            spawn_ranks("train", 2, d / f"part{i}",
                        {"preset": "gpt-nano", "tc": _tc(wd, mesh, **kw)})
        out[name] = wd
    return out


def _records(wd):
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _last(wd):
    return TCK.load_checkpoint(sorted(glob.glob(wd + "/ckpt_*.bin"))[-1])


def test_tp_run_resumes_under_pp(resumed):
    """The loop's tp=2 run (clip and the grad-norm log on) trains, and its
    step-2 checkpoint (canonical params + AdamW m, v) resumed under pp=2
    ends on the same canonical tensors as the straight tp=2 run."""
    recs = _records(resumed["tp"])
    losses = [r["loss"] for r in recs]
    assert len(losses) == 4 and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert all("grad_norm" in r for r in recs)
    p, _, e = _last(resumed["resume"])
    assert e["step"] == 4
    assert [r["mesh"] for r in _records(resumed["resume"])] == \
        ["tp=2", "tp=2", "pp=2,gpipe", "pp=2,gpipe"]
    assert glob.glob(resumed["resume"] + "/meshopt_*.tree")
    cfg = get_config("gpt-nano").replace(**OVR)
    assert_params_close(p, _last(resumed["tp"])[0], cfg, rtol=2e-3,
                        atol=1e-4)
