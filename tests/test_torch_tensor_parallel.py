"""Tensor, sequence and vocab parallelism on gloo CPU ranks
(tests/torch_dist_worker.py, one spawn a mesh: tp=2 on 2 ranks, dp=2,tp=2
on 4), against the JAX package on the same numpy parameters and global
batch: the loss and every gradient against jax.grad on one device
(tests/test_tensor_parallel.py's tolerances: loss rtol 2e-5, gradients
rtol 5e-4, atol 2e-5 of the leaf's largest), one step against the JAX TP
step at the same mesh shape (AdamW, Adafactor, Muon) or, for the other
variants, against the JAX one-device step from those gradients; the TP
layout against JAX's bit for bit; the refusals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from vitrs_tpu.config import get_config as jax_config
from vitrs_tpu.models import model as JM
from vitrs_tpu.ops import adafactor as JAF
from vitrs_tpu.ops import muon as JMU
from vitrs_tpu.ops import optimizer as JOPT
from vitrs_tpu.parallel import muon_parallel as JMP
from vitrs_tpu.parallel import tensor_parallel as JTP
from vitrs_tpu_torch import params as TPRM
from vitrs_tpu_torch.config import get_config
from vitrs_tpu_torch.parallel import tensor_parallel as TTP
from vitrs_tpu_torch.train import mesh as TMS
from test_torch_helpers import assert_params_close, np_params, start_ranks

B = 8
# the data sets: gpt at head_dim 64 (the port's flash route, its plain
# versions here), GQA, vit with the CLS token and with mean pooling (SP
# needs T % tp == 0), and 3 layers for Muon's replicated Newton-Schulz
DATA = {
    "gpt": ("gpt-nano", dict(num_layers=2, num_heads=2, channels=128,
                             vocab_size=97, max_seq_len=16)),
    "gqa": ("gpt-nano", dict(num_layers=2, num_heads=4, num_kv_heads=2,
                             channels=64, vocab_size=97, max_seq_len=16)),
    "vit": ("vit-tiny-4-cifar10", dict(num_layers=2, channels=32,
                                       num_heads=2)),
    "vitmean": ("vit-tiny-4-cifar10", dict(num_layers=2, channels=32,
                                           num_heads=2, pool="mean")),
    "gpt3": ("gpt-nano", dict(num_layers=3, num_heads=2, channels=128,
                              vocab_size=97, max_seq_len=16)),
}
LR, WD, AF_LR, MU_LR, MU_ALR = 1e-3, 0.1, 0.01, 0.02, 3e-3


def _var(name, data, mesh, opt="adamw", **kw):
    seventh = {"adamw": WD, "adafactor": WD, "muon": MU_ALR}[opt]
    lr = {"adamw": LR, "adafactor": AF_LR, "muon": MU_LR}[opt]
    preset, ovr = DATA[data]
    return dict(name=name, data=data, preset=preset, overrides=ovr,
                mesh=mesh, opt=opt, step=1, lr=lr, seventh=seventh, **kw)


def _variants(prefix):
    return [
        _var("plain", "gpt", prefix),
        _var("sp", "gpt", prefix + ",sp"),
        _var("vp", "gpt", prefix + ",vp"),
        _var("spvp", "gpt", prefix + ",sp,vp"),
        _var("gqa", "gqa", prefix),
        _var("gqa_sp", "gqa", prefix + ",sp"),
        _var("vit", "vit", prefix),
        _var("vit_sp", "vitmean", prefix + ",sp"),
        _var("knobs", "gpt", prefix + ",vp", knobs=dict(
            accum_steps=2, clip_norm=0.05, log_grad_norm=True)),
        _var("af", "gpt", prefix + ",sp", "adafactor"),
        _var("af_vp", "gpt", prefix + ",vp", "adafactor"),
        _var("muon", "gpt", prefix + ",sp", "muon", muon_wd=WD),
        _var("muon_gqa", "gqa", prefix, "muon"),
        _var("muon_l3", "gpt3", prefix, "muon"),
        _var("muon_vit", "vit", prefix, "muon"),
    ]


MESHES = {"tp=2": 2, "dp=2,tp=2": 4}
# every variant on tp=2; a cross-section on the 4-rank mesh
ON_MESH = {"tp=2": [v["name"] for v in _variants("tp=2")],
           "dp=2,tp=2": ["plain", "sp", "vp", "spvp", "gqa_sp", "vit",
                         "knobs", "af", "muon"]}
CASES = [(n, m) for m in MESHES for n in ON_MESH[m]]


def _cfgs(data):
    preset, ovr = DATA[data]
    return (jax_config(preset, use_flash=False).replace(**ovr),
            get_config(preset).replace(**ovr))


def _inputs():
    out = {}
    for data in DATA:
        _, tcfg = _cfgs(data)
        rng = np.random.default_rng(11)
        for k, v in np_params(tcfg, seed=11).items():
            out[f"p/{data}/{k}"] = v
        if tcfg.mode == "vit":
            out[f"x/{data}"] = rng.standard_normal(
                (B, 32, 32, 3)).astype(np.float32)
            out[f"y/{data}"] = rng.integers(0, 10, (B,)).astype(np.int32)
        else:
            out[f"x/{data}"] = rng.integers(0, 97, (B, 16)).astype(np.int32)
            out[f"y/{data}"] = rng.integers(0, 97, (B, 16)).astype(np.int32)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    inputs = _inputs()
    waits = {m: start_ranks("mesh_step", n, tmp_path_factory.mktemp("tp"),
                            {"preset": "gpt-nano",
                             "variants": [v for v in _variants(m)
                                          if v["name"] in ON_MESH[m]]},
                            inputs)
             for m, n in MESHES.items()}
    # one-device references while the ranks run
    ref = {}
    for data in DATA:
        jcfg, _ = _cfgs(data)
        p = {k[len(data) + 3:]: jnp.asarray(v) for k, v in inputs.items()
             if k.startswith(f"p/{data}/")}
        x, y = jnp.asarray(inputs[f"x/{data}"]), jnp.asarray(
            inputs[f"y/{data}"])
        loss, g = jax.value_and_grad(JM.loss_fn)(p, x, y, jcfg)
        ref[data] = (float(loss), jax.device_get(g), p, x, y)
    outs = {m: w() for m, w in waits.items()}
    return inputs, ref, outs


def _get(out, name, what):
    pre = f"{name}/{what}/"
    return {k[len(pre):]: v for k, v in out.items() if k.startswith(pre)}


def _var_of(name):
    return next(v for v in _variants("tp=2") if v["name"] == name)


_STEPS = {}


def _one_device_step(var, ref):
    """The JAX one-device step from the one-device gradients (once a
    variant: both meshes hold to it)."""
    if var["name"] not in _STEPS:
        _STEPS[var["name"]] = jax.device_get(jax.jit(
            lambda p, g: _one_device_update(var, p, g))(
                *ref[var["data"]][2:0:-1]))
    return _STEPS[var["name"]]


def _one_device_update(var, p, g):
    jcfg, _ = _cfgs(var["data"])
    jcfg, _ = _cfgs(var["data"])
    knobs = var.get("knobs", {})
    if knobs.get("clip_norm"):
        norm = jnp.sqrt(sum(jnp.sum(jnp.square(t)) for t in g.values()))
        s = jnp.minimum(1.0, knobs["clip_norm"] / (norm + 1e-6))
        g = {k: t * s for k, t in g.items()}
    if var["opt"] == "adamw":
        m = {k: jnp.zeros_like(t) for k, t in p.items()}
        return JOPT.adamw_tree(p, g, m, dict(m), jnp.asarray(1), LR,
                               weight_decay=WD)[0]
    if var["opt"] == "muon":
        new, _ = JMU.step(p, g, JMU.init_state(p), jnp.asarray(1), MU_LR,
                          adamw_lr=MU_ALR,
                          weight_decay=var.get("muon_wd", 0.0))
        return new
    vp = "vp" in var["mesh"]
    tpp = JTP.to_tp_params(p, jcfg, vp)
    tg = JTP.to_tp_params(g, jcfg, vp)
    new, _ = JAF.step(tpp, tg, JAF.init_state(tpp), jnp.asarray(1), AF_LR,
                      weight_decay=WD, decay_mask=JOPT.decay_mask_2d(tpp))
    return JTP.from_tp_params(new, jcfg, vp)


@pytest.mark.parametrize("name,mesh", CASES)
def test_tp_loss_and_grads_match_jax(run, name, mesh):
    inputs, ref, outs = run
    var = _var_of(name)
    loss, g = ref[var["data"]][:2]
    for out in outs[mesh]:
        assert str(out[f"{name}/kind"]) == "tp"
        np.testing.assert_allclose(out[f"{name}/loss"], loss, rtol=2e-5)
        got = _get(out, name, "g")
        if var.get("knobs"):
            continue                  # the knobs' step is held below
        assert set(got) == set(g)
        for k, want in g.items():
            want = np.asarray(want)
            scale = max(np.abs(want).max(), 1e-6)
            np.testing.assert_allclose(got[k], want, rtol=5e-4,
                                       atol=2e-5 * scale, err_msg=k)


@pytest.mark.parametrize("name,mesh", CASES)
def test_tp_step_matches_jax_one_device(run, name, mesh):
    """One step from the same gradients, as the one-device JAX step takes
    it: AdamW (a value whose gradient is fp32 noise within lr), Adafactor
    on the TP layout (tests/test_adafactor.py's rtol 1e-4 atol 2e-4),
    Muon (tests/test_muon_parallel.py's rtol 5e-3 atol 2e-3)."""
    inputs, ref, outs = run
    var = _var_of(name)
    jcfg, tcfg = _cfgs(var["data"])
    want = _one_device_step(var, ref)
    tol = {"adamw": dict(rtol=2e-4, atol=5e-5),
           "adafactor": dict(rtol=1e-4, atol=2e-4),
           "muon": dict(rtol=5e-3, atol=2e-3)}[var["opt"]]
    lr = {"adamw": LR, "adafactor": AF_LR, "muon": MU_ALR}[var["opt"]]
    grads = ref[var["data"]][1]
    for out in outs[mesh]:
        assert_params_close(_get(out, name, "p"), want, tcfg, grads=grads,
                            lr=lr, **tol)
        if var.get("knobs"):
            g = ref[var["data"]][1]
            norm = np.sqrt(sum(np.sum(np.square(np.asarray(t, np.float64)))
                               for t in g.values()))
            np.testing.assert_allclose(out[f"{name}/gnorm"], norm, rtol=1e-3)


def _jax_tp_step(name, mesh, inputs):
    """The JAX package's TP step of a variant on the conftest's CPU
    devices at the mesh shape."""
    var = _var_of(name)
    jcfg, _ = _cfgs(var["data"])
    dp = 2 if mesh.startswith("dp=2") else 1
    jm = JTP.make_mesh_2d(dp, 2)
    data = var["data"]
    pnp = {k[len(data) + 3:]: v for k, v in inputs.items()
           if k.startswith(f"p/{data}/")}
    sh = NamedSharding(jm, P("data"))
    x = jax.device_put(jnp.asarray(inputs[f"x/{data}"]), sh)
    y = jax.device_put(jnp.asarray(inputs[f"y/{data}"]), sh)
    sp, vp = "sp" in var["mesh"], "vp" in var["mesh"]
    t = jnp.asarray(1, jnp.int32)
    if var["opt"] == "muon":
        tpp = JTP.place_tp_params(pnp, jcfg, jm)
        mom, m, v = JMP.init_tp_muon_state(tpp, jcfg, jm)
        step = JMP.make_tp_muon_train_step(
            jcfg, jm, sequence_parallel=sp,
            weight_decay=var.get("muon_wd", 0.0))
        out = step(tpp, mom, m, v, x, y, t, jnp.asarray(MU_LR),
                   jnp.asarray(MU_ALR))
        return JTP.from_tp_params(jax.device_get(out[0]), jcfg), out[-1]
    if var["opt"] == "adafactor":
        tpp = JTP.place_tp_params(pnp, jcfg, jm, vp)
        st = JTP.init_tp_af_state(tpp, jm, jcfg, vp)
        step = JTP.make_tp_train_step_adafactor(jcfg, jm, sp, vp)
        out = step(tpp, st, x, y, t, jnp.asarray(AF_LR), jnp.asarray(WD))
        return JTP.from_tp_params(jax.device_get(out[0]), jcfg, vp), out[-1]
    tpp = JTP.place_tp_params(pnp, jcfg, jm, vp)
    m, v = JTP.init_tp_opt_state(tpp, jm, jcfg, vp)
    step = JTP.make_tp_train_step(jcfg, jm, sp, vp)
    out = step(tpp, m, v, x, y, t, jnp.asarray(LR), jnp.asarray(WD))
    return JTP.from_tp_params(jax.device_get(out[0]), jcfg, vp), out[-1]


@pytest.mark.parametrize("name,mesh", [("spvp", "tp=2"),
                                       ("vit", "dp=2,tp=2"),
                                       ("af", "tp=2"),
                                       ("muon", "tp=2")])
def test_tp_step_matches_the_jax_tp_step(run, name, mesh):
    """The same step through the JAX package's TP factory at the same mesh
    shape (AdamW with SP + VP, vit on dp=2,tp=2, Adafactor, Muon)."""
    inputs, ref, outs = run
    var = _var_of(name)
    _, tcfg = _cfgs(var["data"])
    want, jloss = _jax_tp_step(name, mesh, inputs)
    tol = {"adamw": dict(rtol=2e-4, atol=5e-5),
           "adafactor": dict(rtol=1e-4, atol=2e-4),
           "muon": dict(rtol=5e-3, atol=2e-3)}[var["opt"]]
    lr = {"adamw": LR, "adafactor": AF_LR, "muon": MU_ALR}[var["opt"]]
    grads = ref[var["data"]][1]
    for out in outs[mesh]:
        np.testing.assert_allclose(out[f"{name}/loss"], float(jloss),
                                   rtol=2e-5)
        assert_params_close(_get(out, name, "p"), want, tcfg, grads=grads,
                            lr=lr, **tol)


@pytest.mark.parametrize("data,vp", [("gpt", False), ("gpt", True),
                                     ("gqa", False), ("gqa", True)])
def test_tp_layout_matches_jax_bit_for_bit(data, vp):
    jcfg, tcfg = _cfgs(data)
    arrs = np_params(tcfg, seed=3)
    got = TTP.to_tp_params(arrs, tcfg, vp)
    want = jax.device_get(JTP.to_tp_params(
        {k: jnp.asarray(v) for k, v in arrs.items()}, jcfg, vp))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    back = TTP.from_tp_params({k: t.numpy() for k, t in got.items()}, tcfg,
                              vp)
    assert list(back) == list(TPRM.tensor_order(tcfg))
    for k in arrs:
        np.testing.assert_array_equal(back[k], arrs[k])
    specs = TTP.tp_param_specs(tcfg, vp)
    jspecs = JTP.tp_param_specs(jcfg, vp)
    assert set(specs) == set(jspecs)
    for k in specs:
        assert tuple(specs[k]) == tuple(jspecs[k]), k
    shapes = TTP.tp_global_shapes(tcfg, vp)
    jshapes = JTP.tp_global_shapes(jcfg, vp)
    assert {k: tuple(s) for k, s in shapes.items()} == \
        {k: tuple(s.shape) for k, s in jshapes.items()}


def test_adafactor_shard_axes_match_jax():
    jcfg, tcfg = _cfgs("gpt")
    from vitrs_tpu_torch.ops import adafactor as TAF
    for vp in (False, True):
        g = TTP.tp_global_shapes(tcfg, vp)
        got = TAF.shard_axes_from_specs(g, TTP.tp_param_specs(tcfg, vp),
                                        "model")
        jg = JTP.tp_global_shapes(jcfg, vp)
        want = JAF.shard_axes_from_specs(jg, JTP.tp_param_specs(jcfg, vp),
                                         "model")
        assert got == want
        st = TAF.state_specs(g, TTP.tp_param_specs(tcfg, vp))
        jst = JAF.state_specs(jg, JTP.tp_param_specs(jcfg, vp))
        for f in ("vr", "vc", "vf"):
            for k in g:
                w = tuple(getattr(jst, f)[k])
                assert tuple(getattr(st, f)[k])[:len(w)] == w, (f, k)


@pytest.mark.parametrize("overrides,spec,opt,match", [
    (dict(num_experts=4), "tp=2", "adamw", "MoE under TP"),
    (dict(num_heads=3, channels=48), "tp=2", "adamw", "num_heads"),
    (dict(num_heads=4, num_kv_heads=1, channels=64), "tp=2", "adamw",
     "kv_heads"),
    (dict(), "tp=2,vp", "muon", "vocab-parallel"),
    ("vit", "tp=2,sp", "adamw", "seq_len"),
    ("vit", "tp=2,vp", "adamw", "gpt head"),
])
def test_tp_refusals_name_the_cause(overrides, spec, opt, match):
    """The JAX assertions as ValueErrors, raised before any group is made
    (the plan is built in a world of one rank)."""
    if overrides == "vit":
        cfg = get_config("vit-b-16")      # T = 197: no SP at tp=2
    else:
        cfg = get_config("gpt-nano").replace(**overrides)
    with pytest.raises(ValueError, match=match):
        TTP.check_tp(cfg, 2, "vp" in spec, "sp" in spec) if opt != "muon" \
            else TMS.make_plan(cfg, TMS.parse_mesh(spec), opt, "cpu")


@pytest.mark.parametrize("name,mesh", [c for c in CASES
                                       if c[0].startswith("muon")])
def test_tp_muon_momentum_matches_jax(run, name, mesh):
    """The Muon momentum after one step, gathered to the canonical layout
    (`plan.opt_save`), against the JAX one-device step's, which from a zero
    state is the gradient of each Muon matrix (buf = 0.95 * 0 + g;
    tests/test_muon_parallel.py's state tolerance: rtol 1e-5, atol
    1e-7)."""
    inputs, ref, outs = run
    var = _var_of(name)
    g = ref[var["data"]][1]
    want = {k: np.asarray(g[k]) for k in JMU.MUON_KEYS if k in g}
    for out in outs[mesh]:
        got = _get(out, name, "mom")
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)
