"""Expert parallelism (parallel/expert_parallel.py) on gloo CPU ranks
(tests/torch_dist_worker.py job `ep`, one spawn a world: ep=2 on 2 ranks;
dp=2,ep=2 and ep=2,tp=2[,vp] on 4), against the JAX package on the same
numpy parameters and global batch:

* the tiled all-to-all, forward and backward, against the blocks gathered
  on one process;
* no-drop parity (moe_cap_factor 8, moe_aux_weight 0, tests/test_moe.py's
  setting): the loss and every gradient against one-device jax.grad (rtol
  2e-4, atol 2e-6 of the leaf's largest);
* one step against the JAX one-device step from those gradients (AdamW with
  the 2-D decay mask, Adafactor), and against the JAX mesh plan at the
  same mesh shape: Adafactor, and AdamW with the knobs (accumulation,
  clip, grad-norm log), on dp x ep; AdamW without vp and Adafactor with vp
  on ep x tp;
* the refusals, as the JAX plan's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vitrs_tpu.config import get_config as jax_config
from vitrs_tpu.models import model as JM
from vitrs_tpu.ops import adafactor as JAF
from vitrs_tpu.ops import optimizer as JOPT
from vitrs_tpu.parallel import tensor_parallel as JTP
from vitrs_tpu.train import mesh as JMS
from vitrs_tpu_torch.config import get_config
from vitrs_tpu_torch.train import mesh as TMS
from test_torch_helpers import assert_params_close, np_params, start_ranks

B, T = 8, 16
MOE = dict(num_layers=2, num_heads=2, channels=128, vocab_size=97,
           max_seq_len=T, num_experts=4, moe_top_k=2, moe_cap_factor=8.0,
           moe_aux_weight=0.0)
LR, WD, AF_LR = 1e-3, 0.1, 0.01
KNOBS = dict(accum_steps=2, clip_norm=0.05, log_grad_norm=True)
# (name, mesh, optimizer, knobs) per world
VARIANTS = {
    2: [("ep", "ep=2", "adamw", {}), ("ep_af", "ep=2", "adafactor", {}),
        ("ep_knobs", "ep=2", "adamw", KNOBS)],
    4: [("dpep", "dp=2,ep=2", "adamw", {}),
        ("dpep_af", "dp=2,ep=2", "adafactor", {}),
        ("eptp", "ep=2,tp=2", "adamw", {}),
        ("eptp_af", "ep=2,tp=2", "adafactor", {}),
        ("eptp_vp", "ep=2,tp=2,vp", "adamw", {}),
        ("eptp_vp_af", "ep=2,tp=2,vp", "adafactor", {})],
}
CASES = [(w, v[0]) for w in VARIANTS for v in VARIANTS[w]]
# held against the JAX mesh plan at the same mesh shape as well
AT_MESH = {"ep_af": 2, "ep_knobs": 2, "eptp": 4, "eptp_vp_af": 4}


def _var(name):
    return next(v for w in VARIANTS for v in VARIANTS[w] if v[0] == name)


def _cfgs():
    return (jax_config("gpt-nano", use_flash=False).replace(**MOE),
            get_config("gpt-nano").replace(**MOE))


def _inputs():
    _, tcfg = _cfgs()
    rng = np.random.default_rng(21)
    out = {f"p/moe/{k}": v for k, v in np_params(tcfg, seed=21).items()}
    out["x/moe"] = rng.integers(0, 97, (B, T)).astype(np.int32)
    out["y/moe"] = rng.integers(0, 97, (B, T)).astype(np.int32)
    return out


def _a2a_inputs(world):
    rng = np.random.default_rng(world)
    return {"a2a/t": rng.standard_normal((world, 2 * world, 3, 5)
                                         ).astype(np.float32),
            "a2a/w": rng.standard_normal((world, 2, 3 * world, 5)
                                         ).astype(np.float32)}


def _job(world):
    return {"preset": "gpt-nano", "variants": [
        dict(name=n, data="moe", preset="gpt-nano", overrides=MOE, mesh=mesh,
             opt=opt, knobs=knobs, step=1,
             lr=AF_LR if opt == "adafactor" else LR, seventh=WD)
        for n, mesh, opt, knobs in VARIANTS[world]]}


def _one_device_update(p, g, opt, knobs, tp_layout, vp=False):
    """The one-device JAX step from the one-device gradients: AdamW with
    the EP steps' 2-D decay mask (after the clip, when set), Adafactor on
    the canonical layout (dp x ep) or the TP layout (ep x tp; under vp its
    padded wte, whose statistics factor)."""
    jcfg, _ = _cfgs()
    if knobs.get("clip_norm"):
        norm = jnp.sqrt(sum(jnp.sum(jnp.square(t)) for t in g.values()))
        s = jnp.minimum(1.0, knobs["clip_norm"] / (norm + 1e-6))
        g = {k: t * s for k, t in g.items()}
    if opt == "adamw":
        m = {k: jnp.zeros_like(t) for k, t in p.items()}
        return JOPT.adamw_tree(p, g, m, dict(m), jnp.asarray(1), LR,
                               weight_decay=WD,
                               decay_mask=JOPT.decay_mask_2d(p))[0]
    if tp_layout:
        p, g = (JTP.to_tp_params(t, jcfg, vp) for t in (p, g))
    new = JAF.step(p, g, JAF.init_state(p), jnp.asarray(1), AF_LR,
                   weight_decay=WD, decay_mask=JOPT.decay_mask_2d(p))[0]
    return JTP.from_tp_params(new, jcfg, vp) if tp_layout else new


def _jax_mesh_step(name, inputs):
    """The JAX mesh plan's step of a variant on its CPU devices: (canonical
    params, grad norm or None)."""
    _, mesh, opt, knobs = _var(name)
    jcfg, _ = _cfgs()
    plan = JMS.make_plan(jcfg, JMS.parse_mesh(mesh), opt,
                         devices=jax.devices()[:AT_MESH[name]],
                         knobs=JMS.TrainKnobs(**knobs))
    params = plan.place({k[6:]: jnp.asarray(v) for k, v in inputs.items()
                         if k.startswith("p/moe/")})
    x, y = (jax.device_put(jnp.asarray(inputs[f"{t}/moe"]),
                           plan.batch_sharding) for t in "xy")
    out = plan.step(params, plan.init_opt(params), x, y, np.int32(1),
                    np.float32(AF_LR if opt == "adafactor" else LR),
                    np.float32(WD))
    return (plan.to_canonical(out[0]),
            float(out[3]) if plan.returns_gnorm else None)


def _step_key(name):
    """The one-device step a variant is held to: (optimizer, knobs, the TP
    layout, vp); AdamW's does not depend on the layout."""
    _, mesh, opt, knobs = _var(name)
    layout = opt == "adafactor" and "tp" in mesh
    return (opt, bool(knobs), layout, layout and "vp" in mesh)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    inputs = _inputs()
    waits = {w: start_ranks("ep", w, tmp_path_factory.mktemp(f"ep{w}"),
                            _job(w), dict(inputs, **_a2a_inputs(w)))
             for w in VARIANTS}
    # the JAX references while the ranks run
    jcfg, _ = _cfgs()
    p = {k[6:]: jnp.asarray(v) for k, v in inputs.items()
         if k.startswith("p/moe/")}
    loss, g = jax.value_and_grad(JM.loss_fn)(
        p, jnp.asarray(inputs["x/moe"]), jnp.asarray(inputs["y/moe"]), jcfg)
    steps = {}
    for name, _, opt, knobs in (v for w in VARIANTS for v in VARIANTS[w]):
        key = _step_key(name)
        if key not in steps:
            steps[key] = jax.device_get(jax.jit(
                lambda p, g, opt=opt, knobs=knobs, key=key:
                _one_device_update(p, g, opt, knobs, *key[2:]))(p, g))
    meshed = {n: _jax_mesh_step(n, inputs) for n in AT_MESH}
    outs = {w: wait() for w, wait in waits.items()}
    return float(loss), jax.device_get(g), steps, meshed, outs


@pytest.mark.parametrize("world", sorted(VARIANTS))
def test_all_to_all_matches_a_gather(run, world):
    """Rank r's out is block r of every rank's input along dim 0, laid
    side by side along dim 1 in rank order; its input's gradient is, for
    each block s it sent, the slice of rank s's weight that block landed
    in; the inverse hop gives the input back."""
    outs = run[4][world]
    inp = _a2a_inputs(world)
    t, w = inp["a2a/t"], inp["a2a/w"]
    c = t.shape[1] // world
    for r, out in enumerate(outs):
        want = np.concatenate([t[s, r * c:(r + 1) * c] for s in range(world)],
                              axis=1)
        np.testing.assert_array_equal(out["a2a/y"], want)
        want_dt = np.concatenate([w[s][:, r * 3:(r + 1) * 3]
                                  for s in range(world)], axis=0)
        np.testing.assert_array_equal(out["a2a/dt"], want_dt)
        np.testing.assert_array_equal(out["a2a/back"], t[r])


def _tree(out, name, what):
    pre = f"{name}/{what}/"
    return {k[len(pre):]: v for k, v in out.items() if k.startswith(pre)}


@pytest.mark.parametrize("world,name", CASES)
def test_ep_loss_and_grads_match_jax_one_device(run, world, name):
    loss, g = run[0], run[1]
    for out in run[4][world]:
        assert str(out[f"{name}/kind"]) == "ep"
        np.testing.assert_allclose(out[f"{name}/loss"], loss, rtol=2e-4)
        if _var(name)[3]:
            continue                  # the knobs' step is held below
        got = _tree(out, name, "g")
        assert set(got) == set(g)
        for k, want in g.items():
            want = np.asarray(want)
            np.testing.assert_allclose(
                got[k], want, rtol=2e-4,
                atol=2e-6 * max(np.abs(want).max(), 1e-6), err_msg=k)


@pytest.mark.parametrize("world,name", CASES)
def test_ep_step_matches_jax(run, world, name):
    """One step against the JAX one-device step from the one-device
    gradients and, for AT_MESH, against the JAX mesh plan: AdamW rtol 2e-4
    atol 5e-5 (a value whose gradient is fp32 noise within lr), Adafactor
    rtol 1e-4 atol 2e-4; the knobs' grad norm against the one-device norm
    and the JAX mesh step's (rtol 1e-3)."""
    _, g, steps, meshed, outs = run
    _, _, opt, knobs = _var(name)
    _, tcfg = _cfgs()
    want = steps[_step_key(name)]
    tol = (dict(rtol=2e-4, atol=5e-5) if opt == "adamw"
           else dict(rtol=1e-4, atol=2e-4))
    lr = LR if opt == "adamw" else AF_LR
    norm = np.sqrt(sum(np.sum(np.square(np.asarray(t, np.float64)))
                       for t in g.values()))
    for out in outs[world]:
        got = _tree(out, name, "p")
        assert_params_close(got, want, tcfg, grads=g, lr=lr, **tol)
        if name in meshed:
            assert_params_close(got, meshed[name][0], tcfg, grads=g, lr=lr,
                                **tol)
        if knobs.get("log_grad_norm"):
            np.testing.assert_allclose(out[f"{name}/gnorm"], norm, rtol=1e-3)
            np.testing.assert_allclose(out[f"{name}/gnorm"], meshed[name][1],
                                       rtol=1e-3)


@pytest.mark.parametrize("spec,opt,knobs,ovr,match", [
    ("ep=2", "adamw", {}, dict(num_experts=0), "MoE config"),
    ("ep=2,pp=2", "adamw", {}, {}, "composes with dp and tp"),
    ("ep=2,tp=2", "adamw", dict(clip_norm=1.0), {}, "dp x ep"),
    ("ep=2,tp=2", "muon", {}, {}, "AdamW and Adafactor"),
    ("dp=2,ep=2", "muon", {}, {}, "AdamW and Adafactor"),
    ("ep=3", "adamw", {}, {}, "divide over ep"),
])
def test_ep_refusals(spec, opt, knobs, ovr, match):
    """The JAX plan's refusals as ValueErrors, before any process group
    is needed."""
    cfg = get_config("gpt-nano").replace(**dict(MOE, **ovr))
    with pytest.raises(ValueError, match=match):
        TMS.make_plan(cfg, TMS.parse_mesh(spec), opt, "cpu",
                      TMS.TrainKnobs(**knobs))
    jcfg = jax_config("gpt-nano").replace(**dict(MOE, **ovr))
    jspec = JMS.parse_mesh(spec)
    with pytest.raises(AssertionError):
        JMS.make_plan(jcfg, jspec, opt,
                      devices=jax.devices()[:jspec.n_devices],
                      knobs=JMS.TrainKnobs(**knobs))
