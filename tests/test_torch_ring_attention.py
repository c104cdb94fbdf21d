"""Context parallelism (parallel/ring_attention.py) on gloo CPU ranks
(tests/torch_dist_worker.py job `ring`, one spawn a world: 2 and 4 ranks),
against the JAX package on the same numpy inputs:

* the ring alone, causal and not, MHA and kv_heads 1 / 2, banded with the
  window below, at and above T/n: out and dq, dk, dv against JAX's
  `ring_attention_local` under shard_map and a float64 dense reference
  (tests/test_ring_attention.py's tolerances: out rtol 2e-5 atol 2e-5,
  gradients rtol 3e-4 atol 3e-5), and the cut hops, each a flash op call on
  the rectangle at a query offset, with no plain banded block left;
* the dp x cp step: loss and every gradient against one-device jax.grad
  (loss rtol 2e-5, gradients rtol 5e-4 atol 2e-5 of the leaf's largest),
  one step against the JAX one-device step from those gradients, and on
  the 2 x 2 mesh one AdamW step (params, and m / v carved to canonical
  names) and one Adafactor step against the JAX mesh plan;
* the refusals, as the JAX plan's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from vitrs_tpu.config import get_config as jax_config
from vitrs_tpu.models import model as JM
from vitrs_tpu.ops import adafactor as JAF
from vitrs_tpu.ops import optimizer as JOPT
from vitrs_tpu.parallel import ring_attention as JRA
from vitrs_tpu.train import mesh as JMS
from vitrs_tpu_torch.config import get_config
from vitrs_tpu_torch.parallel import ring_attention as TRA
from vitrs_tpu_torch.train import mesh as TMS
from test_torch_helpers import assert_params_close, np_params, start_ranks

WORLDS = (2, 4)
T, B, D = 32, 2, 64


def _cases(world):
    """(name, num_heads, kv_heads, causal, window): the window below, at
    and above the block length T/n."""
    blk = T // world
    return [("mha", 2, 2, True, 0), ("full", 2, 2, False, 0),
            ("mqa", 4, 1, True, 0), ("gqa", 4, 2, True, 0),
            ("band_below", 2, 2, True, blk - 3),
            ("band_at", 2, 2, True, blk),
            ("band_above", 4, 2, True, blk + 3),
            ("band_two", 2, 1, True, 2 * blk + 1)]


CASES = [(w, c[0]) for w in WORLDS for c in _cases(w)]

# the dp x cp step's data sets: gpt at head_dim 64, and rope + the window +
# MQA (the banded ring: W=12 cuts every past block it reaches at T/n = 16
# and 8)
DATA = {
    "gpt": dict(num_layers=2, num_heads=2, channels=128, vocab_size=97,
                max_seq_len=T),
    "rope": dict(num_layers=2, num_heads=2, num_kv_heads=1, channels=128,
                 vocab_size=97, max_seq_len=T, pos_emb="rope", window=12),
}
LR, WD, AF_LR = 1e-3, 0.1, 0.01
VARIANTS = {
    2: [("cp", "gpt", "cp=2", "adamw"), ("cp_rope", "rope", "cp=2", "adamw"),
        ("cp_af", "gpt", "cp=2", "adafactor")],
    4: [("dpcp", "gpt", "dp=2,cp=2", "adamw"),
        ("dpcp_af", "gpt", "dp=2,cp=2", "adafactor"),
        ("cp4_rope", "rope", "cp=4", "adamw")],
}
VAR_CASES = [(w, v[0]) for w in WORLDS for v in VARIANTS[w]]
# held against the JAX mesh plan at the same mesh shape
AT_MESH = ("dpcp", "dpcp_af")


def _var(world, name):
    _, data, mesh, opt = next(v for v in VARIANTS[world] if v[0] == name)
    return data, mesh, opt


def _inputs():
    rng = np.random.default_rng(5)
    out = {}
    for world in WORLDS:
        for name, H, KH, _, _ in _cases(world):
            for t, width in (("q", H), ("k", KH), ("v", KH), ("do", H)):
                out[f"{world}/{name}/{t}"] = rng.standard_normal(
                    (B, T, width * D)).astype(np.float32)
    for data, ovr in DATA.items():
        tcfg = get_config("gpt-nano").replace(**ovr)
        for k, v in np_params(tcfg, seed=7).items():
            out[f"p/{data}/{k}"] = v
        out[f"x/{data}"] = rng.integers(0, 97, (4, T)).astype(np.int32)
        out[f"y/{data}"] = rng.integers(0, 97, (4, T)).astype(np.int32)
    return out


def _job(world, inputs):
    variants = [dict(name=n, data=data, preset="gpt-nano",
                     overrides=DATA[data], mesh=mesh, opt=opt, step=1,
                     lr=AF_LR if opt == "adafactor" else LR, seventh=WD,
                     save_opt=True)
                for n, data, mesh, opt in VARIANTS[world]]
    cases = [dict(name=n, num_heads=H, causal=c, window=W)
             for n, H, _, c, W in _cases(world)]
    rank_inputs = {k[len(str(world)) + 1:]: v for k, v in inputs.items()
                   if k.startswith(f"{world}/")}
    rank_inputs.update({k: v for k, v in inputs.items()
                        if k[:2] in ("p/", "x/", "y/")})
    return {"preset": "gpt-nano", "cases": cases,
            "variants": variants}, rank_inputs


def _heads(a, h):
    """(B, T, h*D) -> (B, h, T, D), the JAX module's layout."""
    return a.reshape(a.shape[0], a.shape[1], h, -1).transpose(0, 2, 1, 3)


def _jax_rings(world, inputs):
    """JAX's ring_attention_local under shard_map over `world` CPU
    devices: per case (out, dq, dk, dv) in the port's layout.  One jit a
    case: with every case in one program, XLA:CPU now and then delivered
    the banded cases' home ppermute (h < n) wrong dk / dv."""
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("ctx",))
    spec = P(None, None, "ctx", None)
    out = {}
    for name, H, KH, causal, W in _cases(world):
        def local(q, k, v, do, causal=causal, W=W):
            o, vjp = jax.vjp(lambda a, b, c: JRA.ring_attention_local(
                a, b, c, "ctx", world, causal, W), q, k, v)
            return (o, *vjp(do))

        fn = jax.jit(shard_map(local, mesh=mesh, in_specs=(spec,) * 4,
                               out_specs=(spec,) * 4, check_rep=False))
        got = jax.device_get(fn(*(
            jnp.asarray(_heads(inputs[f"{world}/{name}/{t}"], h))
            for t, h in (("q", H), ("k", KH), ("v", KH), ("do", H)))))
        for a, (t, h) in zip(got, (("out", H), ("dq", H), ("dk", KH),
                                   ("dv", KH))):
            out[f"{name}/{t}"] = np.asarray(a).transpose(0, 2, 1, 3).reshape(
                B, T, h * D)
    return out


def _dense(inputs, world, name, H, KH, causal, W):
    """float64 dense attention and its gradients (GQA: K/V expanded, the
    gradients summed over each group)."""
    q, k, v, do = (_heads(inputs[f"{world}/{name}/{t}"].astype(np.float64),
                          h) for t, h in (("q", H), ("k", KH), ("v", KH),
                                          ("do", H)))
    G = H // KH
    kf, vf = np.repeat(k, G, axis=1), np.repeat(v, G, axis=1)
    s = q @ kf.transpose(0, 1, 3, 2) / np.sqrt(D)
    if causal:
        i, j = np.arange(T)[:, None], np.arange(T)[None]
        hide = (j > i) | ((j <= i - W) if W else False)
        s = np.where(hide, -np.inf, s)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    o = p @ vf
    dp = do @ vf.transpose(0, 1, 3, 2)
    ds = p * (dp - (dp * p).sum(-1, keepdims=True))
    dq = ds @ kf / np.sqrt(D)
    dk = (ds.transpose(0, 1, 3, 2) @ q / np.sqrt(D)).reshape(
        B, KH, G, T, D).sum(2)
    dv = (p.transpose(0, 1, 3, 2) @ do).reshape(B, KH, G, T, D).sum(2)
    back = lambda a: a.transpose(0, 2, 1, 3).reshape(B, T, -1)  # noqa: E731
    return {"out": back(o), "dq": back(dq), "dk": back(dk), "dv": back(dv)}


def _cfgs(data):
    return (jax_config("gpt-nano", use_flash=False).replace(**DATA[data]),
            get_config("gpt-nano").replace(**DATA[data]))


def _p(inputs, data):
    return {k[len(data) + 3:]: v for k, v in inputs.items()
            if k.startswith(f"p/{data}/")}


def _one_device_update(data, opt, p, g):
    jcfg, _ = _cfgs(data)
    if opt == "adamw":
        m = {k: jnp.zeros_like(t) for k, t in p.items()}
        return JOPT.adamw_tree(p, g, m, dict(m), jnp.asarray(1), LR,
                               weight_decay=WD)[0]
    return JAF.step(p, g, JAF.init_state(p), jnp.asarray(1), AF_LR,
                    weight_decay=WD, decay_mask=JOPT.decay_mask_2d(p))[0]


def _jax_mesh_step(name, inputs):
    """The JAX mesh plan's step of a 4-rank variant on 4 CPU devices:
    (canonical params, its opt_save tree)."""
    data, mesh, opt = _var(4, name)
    jcfg, _ = _cfgs(data)
    plan = JMS.make_plan(jcfg, JMS.parse_mesh(mesh), opt,
                         devices=jax.devices()[:4])
    params = plan.place({k: jnp.asarray(v) for k, v in
                         _p(inputs, data).items()})
    x, y = (jax.device_put(jnp.asarray(inputs[f"{t}/{data}"]),
                           plan.batch_sharding) for t in "xy")
    out = plan.step(params, plan.init_opt(params), x, y, np.int32(1),
                    np.float32(AF_LR if opt == "adafactor" else LR),
                    np.float32(WD))
    return plan.to_canonical(out[0]), plan.opt_save(out[1])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    inputs = _inputs()
    waits = {}
    for w in WORLDS:
        job, rank_inputs = _job(w, inputs)
        waits[w] = start_ranks("ring", w, tmp_path_factory.mktemp(f"cp{w}"),
                               job, rank_inputs)
    # the JAX references while the ranks run
    rings = {w: _jax_rings(w, inputs) for w in WORLDS}
    ref = {}
    for data in DATA:
        jcfg, _ = _cfgs(data)
        p = {k: jnp.asarray(v) for k, v in _p(inputs, data).items()}
        loss, g = jax.value_and_grad(JM.loss_fn)(
            p, jnp.asarray(inputs[f"x/{data}"]),
            jnp.asarray(inputs[f"y/{data}"]), jcfg)
        steps = {opt: jax.device_get(jax.jit(
            lambda p, g, opt=opt: _one_device_update(data, opt, p, g))(p, g))
            for opt in ("adamw", "adafactor")}
        ref[data] = (float(loss), jax.device_get(g), steps)
    meshed = {n: _jax_mesh_step(n, inputs) for n in AT_MESH}
    outs = {w: wait() for w, wait in waits.items()}
    return inputs, rings, ref, meshed, outs


def _case(world, name):
    return next(c for c in _cases(world) if c[0] == name)


@pytest.mark.parametrize("world,name", CASES)
def test_ring_matches_jax_and_dense(run, world, name):
    inputs, rings, _, _, outs = run
    _, H, KH, causal, W = _case(world, name)
    dense = _dense(inputs, world, name, H, KH, causal, W)
    t = T // world
    for r, out in enumerate(outs[world]):
        rows = slice(r * t, (r + 1) * t)
        for what in ("out", "dq", "dk", "dv"):
            tol = (dict(rtol=2e-5, atol=2e-5) if what == "out"
                   else dict(rtol=3e-4, atol=3e-5))
            got = out[f"{name}/{what}"]
            np.testing.assert_allclose(got, rings[world][f"{name}/{what}"]
                                       [:, rows], err_msg=f"{what} vs JAX",
                                       **tol)
            np.testing.assert_allclose(got, dense[what][:, rows],
                                       err_msg=f"{what} vs dense", **tol)


@pytest.mark.parametrize("world", WORLDS)
def test_band_route_takes_the_cut_blocks(run, world):
    """Each hop whose past block the band cuts takes the flash ops on the
    rectangle the band reaches (a query offset past the keys' end),
    forward and backward, and no other does: rank idx's past hops d = 1
    .. h-1 with (d + 1) * T/n - 1 >= W (rank 0 has none).  No plain banded
    block is left in the ring."""
    for gone in ("band_fwd_plain", "band_bwd_plain", "band_plain_hops"):
        assert not hasattr(TRA, gone), gone
    outs = run[4][world]
    blk = T // world
    for name, _, _, causal, W in _cases(world):
        h = TRA._ring_hops(world, W, blk)
        for r, out in enumerate(outs):
            cut = sum(1 for d in range(1, h) if d <= r and W
                      and (d + 1) * blk - 1 >= W)
            assert list(out[f"{name}/band"]) == [cut, cut], (name, r)
            assert list(out[f"{name}/rect"]) == [cut, cut], (name, r)


@pytest.mark.parametrize("world,name", VAR_CASES)
def test_cp_loss_and_grads_match_jax_one_device(run, world, name):
    _, _, ref, _, outs = run
    data, _, _ = _var(world, name)
    loss, g = ref[data][:2]
    for out in outs[world]:
        assert str(out[f"{name}/kind"]) == "cp"
        np.testing.assert_allclose(out[f"{name}/loss"], loss, rtol=2e-5)
        got = {k[len(name) + 3:]: v for k, v in out.items()
               if k.startswith(f"{name}/g/")}
        assert set(got) == set(g)
        for k, want in g.items():
            want = np.asarray(want)
            scale = max(np.abs(want).max(), 1e-6)
            np.testing.assert_allclose(got[k], want, rtol=5e-4,
                                       atol=2e-5 * scale, err_msg=k)


def _params_of(out, name):
    pre = f"{name}/p/"
    return {k[len(pre):]: v for k, v in out.items() if k.startswith(pre)}


@pytest.mark.parametrize("world,name", VAR_CASES)
def test_cp_step_matches_jax(run, world, name):
    """One step against the JAX one-device step from the one-device
    gradients, and on the 2 x 2 mesh against the JAX mesh plan: params
    (AdamW rtol 2e-4 atol 5e-5, a value whose gradient is fp32 noise
    within lr; Adafactor rtol 1e-4 atol 2e-4), AdamW's m and v carved to
    canonical names (rtol 5e-4, atol 1e-6 of the leaf's largest)."""
    _, _, ref, meshed, outs = run
    data, _, opt = _var(world, name)
    _, tcfg = _cfgs(data)
    loss, g, steps = ref[data]
    tol = (dict(rtol=2e-4, atol=5e-5) if opt == "adamw"
           else dict(rtol=1e-4, atol=2e-4))
    lr = LR if opt == "adamw" else AF_LR
    for out in outs[world]:
        got = _params_of(out, name)
        assert_params_close(got, steps[opt], tcfg, grads=g, lr=lr, **tol)
        if name not in meshed:
            continue
        want_p, want_opt = meshed[name]
        assert_params_close(got, want_p, tcfg, grads=g, lr=lr, **tol)
        for field, tree in want_opt.items():
            for k, want in tree.items():
                want = np.asarray(want)
                scale = max(np.abs(want).max(), 1e-30)
                np.testing.assert_allclose(
                    out[f"{name}/state/{field}/{k}"], want, rtol=5e-4,
                    atol=1e-6 * scale, err_msg=f"{field}/{k}")


@pytest.mark.parametrize("spec,opt,knobs,ovr,match", [
    ("cp=2,tp=2", "adamw", {}, {}, "composes with dp only"),
    ("cp=2", "muon", {}, {}, "AdamW"),
    ("dp=2,cp=2", "adamw", dict(clip_norm=1.0), {}, "lean ring step"),
    ("cp=2", "adamw", {}, dict(max_seq_len=33), "divide over cp"),
    ("cp=2", "adamw", {}, dict(num_experts=4), "MoE"),
])
def test_cp_refusals(spec, opt, knobs, ovr, match):
    """The JAX plan's refusals (and the port's of a MoE config) as
    ValueErrors, before any process group is needed."""
    cfg = get_config("gpt-nano").replace(**ovr)
    with pytest.raises(ValueError, match=match):
        TMS.make_plan(cfg, TMS.parse_mesh(spec), opt, "cpu",
                      TMS.TrainKnobs(**knobs))
    if not ovr.get("num_experts"):
        jcfg = jax_config("gpt-nano").replace(**ovr)
        jspec = JMS.parse_mesh(spec)
        with pytest.raises(AssertionError):
            JMS.make_plan(jcfg, jspec, opt,
                          devices=jax.devices()[:jspec.n_devices],
                          knobs=JMS.TrainKnobs(**knobs))


def test_cp_refuses_vit():
    cfg = get_config("vit-tiny-4-cifar10")
    with pytest.raises(ValueError, match="gpt configs"):
        TMS.make_plan(cfg, TMS.parse_mesh("cp=2"), "adamw", "cpu")
