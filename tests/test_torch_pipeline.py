"""Pipeline parallelism (GPipe, 1F1B, interleaved 1F1B) on gloo CPU ranks
(tests/torch_dist_worker.py, one spawn a mesh: pp=2 on 2 ranks,
dp=2,pp=2 on 4), against the JAX package on the same numpy parameters and
global batch: the loss and every gradient against jax.grad on one device
(tests/test_pipeline.py's tolerances: loss rtol 2e-5, gradients rtol
5e-4, atol 3e-5 of the leaf's largest), one step against the JAX pipeline
step at the same mesh shape or against the JAX one-device step; MoE under
GPipe and 1F1B against the JAX GPipe step and each other; the encoder on
stage 0 only, once a microbatch; the interleaved layer order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from vitrs_tpu.config import get_config as jax_config
from vitrs_tpu.models import model as JM
from vitrs_tpu.ops import adafactor as JAF
from vitrs_tpu.ops import optimizer as JOPT
from vitrs_tpu.parallel import pipeline as JPP
from vitrs_tpu_torch.config import get_config
from vitrs_tpu_torch.parallel import pipeline as TPP
from test_torch_helpers import (assert_params_close, np_params, spawn_ranks,
                                start_ranks)

B = 8
DATA = {
    "gpt": ("gpt-nano", dict(num_layers=4, num_heads=2, channels=128,
                             vocab_size=97, max_seq_len=16)),
    "vit": ("vit-tiny-4-cifar10", dict(num_layers=4, channels=32,
                                       num_heads=2)),
    "moe": ("gpt-nano", dict(num_layers=4, num_heads=2, channels=64,
                             vocab_size=97, max_seq_len=16, num_experts=4)),
}
LR, WD, AF_LR = 1e-3, 0.1, 0.01


def _var(name, data, mesh, opt="adamw", **kw):
    preset, ovr = DATA[data]
    return dict(name=name, data=data, preset=preset, overrides=ovr,
                mesh=mesh, opt=opt, step=1,
                lr=AF_LR if opt == "adafactor" else LR, seventh=WD, **kw)


def _variants(pre):
    return [
        _var("gpipe", "gpt", pre),
        _var("1f1b", "gpt", pre + ",schedule=1f1b,mb=4"),
        _var("inter", "gpt", pre + ",schedule=1f1b-interleaved,v=2,mb=4"),
        _var("vit_gpipe", "vit", pre + ",mb=4"),
        _var("vit_1f1b", "vit", pre + ",schedule=1f1b"),
        _var("vit_inter", "vit", pre + ",schedule=1f1b-interleaved,v=2"),
        _var("moe_gpipe", "moe", pre + ",mb=2"),
        _var("moe_1f1b", "moe", pre + ",schedule=1f1b,mb=2"),
        _var("af", "gpt", pre + ",schedule=1f1b,mb=4", "adafactor"),
        _var("knobs", "gpt", pre + ",schedule=1f1b", knobs=dict(
            accum_steps=2, clip_norm=0.05, log_grad_norm=True)),
    ]


MESHES = {"pp=2": 2, "dp=2,pp=2": 4}
ON_MESH = {"pp=2": [v["name"] for v in _variants("pp=2")],
           "dp=2,pp=2": ["gpipe", "1f1b", "inter", "vit_gpipe", "vit_inter",
                         "moe_gpipe", "moe_1f1b", "af", "knobs"]}
CASES = [(n, m) for m in MESHES for n in ON_MESH[m]]
DENSE = [c for c in CASES if not c[0].startswith("moe")]


def _cfgs(data):
    preset, ovr = DATA[data]
    return (jax_config(preset, use_flash=False).replace(**ovr),
            get_config(preset).replace(**ovr))


def _inputs():
    out = {}
    for data in DATA:
        _, tcfg = _cfgs(data)
        rng = np.random.default_rng(5)
        for k, v in np_params(tcfg, seed=5).items():
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
    waits = {m: start_ranks("mesh_step", n, tmp_path_factory.mktemp("pp"),
                            {"preset": "gpt-nano",
                             "variants": [v for v in _variants(m)
                                          if v["name"] in ON_MESH[m]]},
                            inputs)
             for m, n in MESHES.items()}
    ref = {}
    for data in ("gpt", "vit"):
        jcfg, _ = _cfgs(data)
        p = _params(inputs, data)
        loss, g = jax.value_and_grad(JM.loss_fn)(
            p, jnp.asarray(inputs[f"x/{data}"]),
            jnp.asarray(inputs[f"y/{data}"]), jcfg)
        ref[data] = (float(loss), jax.device_get(g), p)
    outs = {m: w() for m, w in waits.items()}
    return inputs, ref, outs


def _get(out, name, what):
    pre = f"{name}/{what}/"
    return {k[len(pre):]: v for k, v in out.items() if k.startswith(pre)}


def _var_of(name):
    return next(v for v in _variants("pp=2") if v["name"] == name)


_STEPS = {}


def _one_device_step(var, ref):
    """The JAX one-device step from the one-device gradients (AdamW; or
    Adafactor in the pipeline's layout, (L, C) block stacks full-v)."""
    if var["name"] in _STEPS:
        return _STEPS[var["name"]]
    jcfg, _ = _cfgs(var["data"])
    _, g, p = ref[var["data"]]
    knobs = var.get("knobs", {})

    def update(p, g):
        if knobs.get("clip_norm"):
            norm = jnp.sqrt(sum(jnp.sum(jnp.square(t)) for t in g.values()))
            s = jnp.minimum(1.0, knobs["clip_norm"] / (norm + 1e-6))
            g = {k: t * s for k, t in g.items()}
        if var["opt"] == "adamw":
            m = {k: jnp.zeros_like(t) for k, t in p.items()}
            return JOPT.adamw_tree(p, g, m, dict(m), jnp.asarray(1), LR,
                                   weight_decay=WD)[0]
        fac, _ = JPP.pp_af_factored(jcfg)
        st = JAF.AdafactorState(
            *({k: jnp.zeros(shape(t.shape, fac[k]), jnp.float32)
               for k, t in p.items()} for shape in (
                lambda s, f: s[:-1] if f else (),
                lambda s, f: s[:-2] + s[-1:] if f else (),
                lambda s, f: () if f else s)), {})
        return JAF.step(p, g, st, jnp.asarray(1), AF_LR, weight_decay=WD,
                        decay_mask=JOPT.decay_mask_2d(p), factored=fac)[0]

    _STEPS[var["name"]] = jax.device_get(jax.jit(update)(p, g))
    return _STEPS[var["name"]]


@pytest.mark.parametrize("name,mesh", DENSE)
def test_pp_loss_and_grads_match_jax(run, name, mesh):
    inputs, ref, outs = run
    var = _var_of(name)
    loss, g, _ = ref[var["data"]]
    for out in outs[mesh]:
        assert str(out[f"{name}/kind"]) == "pp"
        np.testing.assert_allclose(out[f"{name}/loss"], loss, rtol=2e-5)
        if var.get("knobs"):
            continue                      # the knobs' step is held below
        got = _get(out, name, "g")
        assert set(got) == set(g)
        for k, want in g.items():
            want = np.asarray(want)
            scale = max(np.abs(want).max(), 1e-6)
            np.testing.assert_allclose(got[k], want, rtol=5e-4,
                                       atol=3e-5 * scale, err_msg=k)


@pytest.mark.parametrize("name,mesh", DENSE)
def test_pp_step_matches_jax_one_device(run, name, mesh):
    inputs, ref, outs = run
    var = _var_of(name)
    _, tcfg = _cfgs(var["data"])
    want = _one_device_step(var, ref)
    tol = (dict(rtol=1e-4, atol=2e-4, lr=AF_LR) if var["opt"] == "adafactor"
           else dict(rtol=2e-4, atol=5e-5, lr=LR))
    for out in outs[mesh]:
        assert_params_close(_get(out, name, "p"), want, tcfg,
                            grads=ref[var["data"]][1], **tol)
        if var.get("knobs"):
            g = ref[var["data"]][1]
            norm = np.sqrt(sum(np.sum(np.square(np.asarray(t, np.float64)))
                               for t in g.values()))
            np.testing.assert_allclose(out[f"{name}/gnorm"], norm, rtol=1e-3)


def _jax_pp_step(var, mesh, inputs):
    """The JAX package's AdamW pipeline step of a variant at the mesh
    shape, on the conftest's CPU devices: (canonical params, loss)."""
    jcfg, _ = _cfgs(var["data"])
    spec = dict(kv.split("=") for kv in var["mesh"].split(",") if "=" in kv)
    dp, S = int(spec.get("dp", 1)), int(spec["pp"])
    sched = spec.get("schedule", "gpipe")
    V = int(spec.get("v", 1))
    mb = int(spec.get("mb", S))
    jm = JPP.make_mesh_dp_pp(dp, S)
    pnp = {k: np.asarray(v) for k, v in _params(inputs, var["data"]).items()}
    placed = (JPP.place_pp_params_interleaved(pnp, jcfg, jm, V) if V > 1
              else JPP.place_pp_params(pnp, jcfg, jm))
    m, v = JPP.init_pp_opt_state(placed, jm, jcfg)
    step = JPP.make_pp_train_step(jcfg, jm, mb, sched, V)
    sh = NamedSharding(jm, P("data"))
    out = step(placed, m, v,
               jax.device_put(jnp.asarray(inputs[f"x/{var['data']}"]), sh),
               jax.device_put(jnp.asarray(inputs[f"y/{var['data']}"]), sh),
               jnp.asarray(1, jnp.int32), jnp.asarray(LR), jnp.asarray(WD))
    got = jax.device_get(out[0])
    if V > 1:
        got = JPP.uninterleave_tree(got, jcfg, S, V)
    return got, float(out[-1])


@pytest.mark.parametrize("name,mesh", [("inter", "pp=2"),
                                       ("moe_gpipe", "pp=2"),
                                       ("vit_inter", "dp=2,pp=2")])
def test_pp_step_matches_the_jax_pipeline_step(run, name, mesh):
    """The same step through the JAX package's pipeline factory at the
    same mesh shape: interleaved gpt, MoE under GPipe (its router loss on
    every stage), interleaved vit on dp=2,pp=2."""
    inputs, ref, outs = run
    var = _var_of(name)
    var = dict(var, mesh=var["mesh"].replace("pp=2", mesh))
    _, tcfg = _cfgs(var["data"])
    want, jloss = _jax_pp_step(var, mesh, inputs)
    for out in outs[mesh]:
        # which values have an fp32-noise gradient: the one-device one, or
        # (MoE) the port's own
        grads = (ref[var["data"]][1] if var["data"] in ref
                 else _get(out, name, "g"))
        np.testing.assert_allclose(out[f"{name}/loss"], jloss, rtol=2e-5)
        assert_params_close(_get(out, name, "p"), want, tcfg, rtol=2e-4,
                            atol=5e-5, grads=grads, lr=LR)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_moe_1f1b_equals_moe_gpipe(run, mesh):
    """The two schedules compute the same microbatches' mean: the loss
    and every gradient, the router's included."""
    _, _, outs = run
    _, tcfg = _cfgs("moe")
    for out in outs[mesh]:
        np.testing.assert_allclose(out["moe_1f1b/loss"],
                                   out["moe_gpipe/loss"], rtol=2e-5)
        a, b = _get(out, "moe_1f1b", "g"), _get(out, "moe_gpipe", "g")
        assert "routerw" in a
        for k in b:
            scale = max(np.abs(b[k]).max(), 1e-6)
            np.testing.assert_allclose(a[k], b[k], rtol=5e-4,
                                       atol=3e-5 * scale, err_msg=k)


@pytest.mark.parametrize("name", ["gpipe", "1f1b", "inter", "vit_gpipe",
                                  "vit_1f1b", "vit_inter"])
def test_pp_encode_runs_once_per_microbatch(run, name):
    """Only stage 0 runs the encoder, once a microbatch of the step."""
    _, _, outs = run
    spec = dict(kv.split("=") for kv in _var_of(name)["mesh"].split(",")
                if "=" in kv)
    mb = int(spec.get("mb", spec["pp"]))
    assert [int(o[f"{name}/encodes"]) for o in outs["pp=2"]] == [mb, 0]


@pytest.mark.parametrize("L,S,V", [(4, 2, 2), (8, 2, 2), (8, 4, 2),
                                   (12, 2, 3)])
def test_interleave_layer_order_matches_jax(L, S, V):
    got = TPP.interleave_layer_order(L, S, V)
    assert got == list(JPP.interleave_layer_order(L, S, V))
    tree = {"fcw": np.arange(L * 3).reshape(L, 3), "wte": np.arange(4)}
    cfg = get_config("gpt-nano").replace(num_layers=L)
    back = TPP.uninterleave_tree(TPP._permute(tree, cfg, S, V), cfg, S, V)
    np.testing.assert_array_equal(back["fcw"], tree["fcw"])
    np.testing.assert_array_equal(back["wte"], tree["wte"])


def test_pp_specs_and_refusals():
    for data in DATA:
        jcfg, tcfg = _cfgs(data)
        specs, jspecs = TPP.pp_param_specs(tcfg), JPP.pp_param_specs(jcfg)
        assert {k: tuple(s) for k, s in specs.items()} == \
            {k: tuple(s) for k, s in jspecs.items()}
    _, moe = _cfgs("moe")
    with pytest.raises(ValueError, match="dense-only"):
        TPP.check_pp(moe, 2, "1f1b-interleaved", 2)
    with pytest.raises(ValueError, match="num_layers"):
        TPP.check_pp(moe.replace(num_experts=0), 3, "1f1b", 1)
    with pytest.raises(ValueError, match="schedule"):
        TPP.check_pp(moe, 2, "zero-bubble", 1)


def test_point_to_point_and_mesh_groups(tmp_path):
    """collectives.send / recv around a ring of 4 gloo CPU ranks, one
    exchange with both neighbours, and the rank layout of a (data, model,
    pipe) mesh: rank = (d·tp + m)·pp + p, as `make_mesh_3d` reshapes the
    JAX devices."""
    outs = spawn_ranks("p2p", 4, tmp_path, {"preset": "gpt-nano"})
    jm = np.arange(4).reshape(1, 2, 2)
    for r, out in enumerate(outs):
        prv, nxt = (r - 1) % 4, (r + 1) % 4
        np.testing.assert_array_equal(out["ring"], np.arange(4.0) + prv)
        np.testing.assert_array_equal(out["from_prev"], [10.0 * prv] * 2)
        np.testing.assert_array_equal(out["from_next"], [-10.0 * nxt] * 2)
        d, m, p = out["coords"]
        assert jm[d, m, p] == r
        np.testing.assert_array_equal(out["peer"], jm[d, m])
