"""PyTorch port: the mixture-of-experts layer (ops/moe.py) and the MoE model
against the JAX package, on the CPU, from the same numpy weights and inputs.

  * `capacity` over a grid; the router's dst / weight / keep / aux, dst and
    keep compared exactly after checking that, at the test's seed, every
    token's k-th and (k+1)-th router probabilities are far apart (fp32
    logits of the two packages differ by about 1e-7, so a gap near that
    could flip a routing decision without a fault);
  * `moe_mlp`'s output, dx and all five weight gradients with assignments
    dropped; the no-drop match with `dense_equivalent` (both packages');
  * gpt-mode MoE loss and every gradient on the plain-CE and the fused-CE
    route, vit-mode MoE loss and gradients, and the router loss added on
    the K8 route; stochastic depth on the MoE branch;
  * MoE prefill + decode logits against the full forward, and against the
    JAX package's prefill; the engine on a MoE model; checkpoints in both
    directions.

Tolerances: loss rtol 2e-5 and grads rtol 5e-4 (ROADMAP.md's CPU parity
tolerances; atol 1e-6 for values near 0, the packed qkv bias 2e-4, as in
tests/test_torch_train.py), and the same for the layer alone, whose
output is held at rtol 1e-5 (fp32, sums in another order); decode logits within 2e-5 of the full forward, as
tests/test_moe.py holds the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitrs_tpu import checkpoint as JC
from vitrs_tpu.models import generate as JG
from vitrs_tpu.models import model as JM
from vitrs_tpu.ops import moe as JMOE
from vitrs_tpu_torch import checkpoint as TC
from vitrs_tpu_torch import params as TP
from vitrs_tpu_torch.config import get_config as torch_config
from vitrs_tpu_torch.models import generate as TG
from vitrs_tpu_torch.models import model as TM
from vitrs_tpu_torch.ops import fused_head_ce as TFH
from vitrs_tpu_torch.ops import moe as TMOE
from vitrs_tpu_torch.serving_gen import GenerationEngine

from test_torch_helpers import np_params, small_cfgs

S, C, E = 96, 32, 4
MOE = dict(num_experts=4, moe_top_k=2, moe_cap_factor=1.0)
NAMES = ("routerw", "fcw", "fcb", "fcprojw", "fcprojb")
# the smallest gap between the k-th and (k+1)-th router probability that
# counts as unambiguous: 100x the fp32 noise (about 1e-7) between the two
# packages' routers
MIN_GAP = 1e-5


def _layer_inputs(seed=0, scale=0.3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((S, C)).astype(np.float32)
    w = dict(routerw=scale * rng.standard_normal((E, C)),
             fcw=0.05 * rng.standard_normal((E, 4 * C, C)),
             fcb=0.02 * rng.standard_normal((E, 4 * C)),
             fcprojw=0.05 * rng.standard_normal((E, C, 4 * C)),
             fcprojb=0.02 * rng.standard_normal((E, C)))
    return x, {k: v.astype(np.float32) for k, v in w.items()}


def _min_gap(x, routerw, k):
    """The smallest gap between each token's k-th and (k+1)-th router
    probability (fp32, computed in numpy from the inputs)."""
    logits = x.astype(np.float64) @ routerw.astype(np.float64).T
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = np.sort(p / p.sum(-1, keepdims=True), axis=-1)[:, ::-1]
    return float((p[:, k - 1] - p[:, k]).min()) if k < p.shape[1] else 1.0


@pytest.mark.parametrize("cap_factor", [0.5, 1.0, 1.25, 4.0])
@pytest.mark.parametrize("tokens", [1, 7, 96, 1000, 24576])
def test_capacity_matches_jax(tokens, cap_factor):
    for experts in (1, 4, 8, 64):
        for k in range(1, min(experts, 3) + 1):
            got = TMOE.capacity(tokens, experts, k, cap_factor)
            assert got == JMOE.capacity(tokens, experts, k, cap_factor)
            assert got % 8 == 0 and got >= 8


def test_capacity_of_the_moe_bench_row():
    """gpt2-moe-8e at B=24, T=1024, cap factor 1.0: 6,144 slots an expert."""
    assert TMOE.capacity(24 * 1024, 8, 2, 1.0) == 6144


@pytest.mark.parametrize("k", [1, 2, 3])
def test_router_matches_jax(k):
    x, w = _layer_inputs(1)
    assert _min_gap(x, w["routerw"], k) > MIN_GAP
    cap = TMOE.capacity(S, E, k, 1.0)
    jd, jw, jk, ja = JMOE.router(jnp.asarray(x), jnp.asarray(w["routerw"]),
                                 k, cap)
    td, tw, tk, ta = TMOE.router(torch.from_numpy(x),
                                 torch.from_numpy(w["routerw"]), k, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)
    for got, want in zip(ta, ja):
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    if k > 1:
        assert tk.float().mean().item() < 1.0, "no assignment dropped"


def test_top_k_breaks_ties_to_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4]])
    v, i = TMOE.ordered_top_k(probs, 2)
    _, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(i.numpy(), [[0, 1], [1, 3]])


def test_inverse_slot_map_matches_jax():
    x, w = _layer_inputs(2)
    cap = TMOE.capacity(S, E, 2, 1.0)
    td = TMOE.router(torch.from_numpy(x), torch.from_numpy(w["routerw"]), 2,
                     cap)[0]
    got = TMOE.build_inverse(td, E, cap)
    want = JMOE.build_inverse(jnp.asarray(td.numpy(), jnp.int32), E, cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_layer(x, w, k, cap_factor):
    def f(x, *ws):
        out, aux = JMOE.moe_mlp(x, *ws, top_k=k, cap_factor=cap_factor)
        probe = jnp.arange(out.size, dtype=jnp.float32).reshape(out.shape)
        return (jnp.sum(out * probe / out.size) + aux.load_balance
                + aux.z_loss), (out, aux)
    (_, (out, aux)), grads = jax.value_and_grad(
        f, argnums=tuple(range(6)), has_aux=True)(
        jnp.asarray(x), *[jnp.asarray(w[n]) for n in NAMES])
    return np.asarray(out), aux, [np.asarray(g) for g in grads]


@pytest.mark.parametrize("k", [1, 2])
def test_moe_mlp_and_its_gradients_match_jax_with_drops(k):
    x, w = _layer_inputs(3)
    assert _min_gap(x, w["routerw"], k) > MIN_GAP
    jout, jaux, jgrads = _jax_layer(x, w, k, 1.0)
    leaves = [torch.from_numpy(x).requires_grad_(True)] + [
        torch.from_numpy(w[n]).requires_grad_(True) for n in NAMES]
    out, aux = TMOE.moe_mlp(*leaves, top_k=k, cap_factor=1.0)
    probe = torch.arange(out.numel(), dtype=torch.float32).reshape(out.shape)
    ((out * probe / out.numel()).sum() + aux.load_balance
     + aux.z_loss).backward()
    if k == 2:
        assert aux.kept_fraction.item() < 1.0, "no assignment dropped"
    np.testing.assert_allclose(aux.kept_fraction.item(),
                               float(jaux.kept_fraction))
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=1e-5,
                               atol=1e-7)
    for name, t, g in zip(("x",) + NAMES, leaves, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=5e-4, atol=1e-6,
                                   err_msg=name)


def test_moe_mlp_without_drops_is_the_dense_equivalent():
    x, w = _layer_inputs(4)
    tx = torch.from_numpy(x).reshape(2, S // 2, C)
    tw = [torch.from_numpy(w[n]) for n in NAMES]
    for k in (1, 2, 3):
        out, aux = TMOE.moe_mlp(tx, *tw, top_k=k, cap_factor=float(E))
        assert aux.kept_fraction.item() == 1.0
        ref = TMOE.dense_equivalent(tx, *tw, top_k=k)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-5,
                                   atol=1e-7)
        jref = JMOE.dense_equivalent(jnp.asarray(tx.numpy()),
                                     *[jnp.asarray(w[n]) for n in NAMES],
                                     top_k=k)
        np.testing.assert_allclose(ref.numpy(), np.asarray(jref), rtol=2e-5,
                                   atol=1e-7)


def test_moe_layer_in_bf16_keeps_the_dtype_and_rounds_as_jax():
    """bf16 activations and weights: out in bf16, the router in fp32; the
    expert products round to bf16 before their biases, as the JAX op."""
    x, w = _layer_inputs(5)
    xb = jnp.asarray(x, jnp.bfloat16)
    jout, _ = JMOE.moe_mlp(xb, *[jnp.asarray(w[n]) for n in NAMES], top_k=2,
                           cap_factor=1.0)
    out, _ = TMOE.moe_mlp(torch.from_numpy(x).bfloat16(),
                          *[torch.from_numpy(w[n]) for n in NAMES], top_k=2,
                          cap_factor=1.0)
    assert out.dtype == torch.bfloat16
    want = np.asarray(jout.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), want, rtol=2 ** -7,
                               atol=2 ** -7 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the MoE model
# ---------------------------------------------------------------------------


def _gap_recorder(monkeypatch):
    """Patch the model's moe_mlp to record each call's smallest k-th /
    (k+1)-th router probability gap."""
    gaps = []
    real = TM.moe_mlp

    def recording(x, routerw, *a, **kw):
        xs = x.detach().reshape(-1, x.shape[-1]).float().numpy()
        gaps.append(_min_gap(xs, routerw.detach().float().numpy(),
                             kw["top_k"]))
        return real(x, routerw, *a, **kw)

    monkeypatch.setattr(TM, "moe_mlp", recording)
    return gaps


def _assert_grads(got, want, rtol=5e-4):
    for k, w in want.items():
        w = np.asarray(w)
        g = (np.zeros_like(w) if got[k] is None
             else got[k].detach().float().numpy())
        atol = 2e-4 if k == "qkvb" else 1e-6
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=k)


def _tokens(V, seed, shape=(2, 64)):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, shape).astype(np.int32),
            rng.integers(0, V, shape).astype(np.int32))


@pytest.fixture(scope="module", params=[97, 16500], ids=["plain", "fused"])
def gpt_case(request):
    """(torch cfg, arrays, tokens, targets, JAX loss, JAX grads) of the
    small MoE GPT (L=2, C=128, E=4, top-2, cap 1.0) for one vocab."""
    jcfg, tcfg = small_cfgs(vocab_size=request.param, **MOE)
    arrs = np_params(tcfg, 6)
    x, y = _tokens(request.param, 6)
    loss, grads = jax.value_and_grad(JM.loss_fn)(
        {k: jnp.asarray(v) for k, v in arrs.items()}, jnp.asarray(x),
        jnp.asarray(y), jcfg)
    return tcfg, arrs, x, y, float(loss), jax.device_get(grads)


def test_moe_gpt_loss_and_all_grads_match_jax(gpt_case, monkeypatch):
    tcfg, arrs, x, y, jloss, jgrads = gpt_case
    gaps = _gap_recorder(monkeypatch)
    leaves = {k: v.requires_grad_(True)
              for k, v in TP.from_numpy(arrs, tcfg, "cpu").items()}
    assert leaves["routerw"].shape == (2, 4, 128)
    loss = TM.loss_fn(leaves, torch.from_numpy(x), torch.from_numpy(y), tcfg)
    loss.backward()
    assert len(gaps) == tcfg.num_layers and min(gaps) > MIN_GAP, gaps
    assert set(leaves) == set(jgrads) and len(leaves) == 17
    np.testing.assert_allclose(loss.item(), jloss, rtol=2e-5)
    _assert_grads({k: p.grad for k, p in leaves.items()}, jgrads)


def test_moe_loss_adds_the_router_loss_on_every_route(gpt_case, monkeypatch):
    """The aux term is in the loss (it moves with moe_aux_weight) on the
    plain-CE, K5/K6 and K8 routes."""
    tcfg, arrs, x, y, jloss, _ = gpt_case
    params = TP.from_numpy(arrs, tcfg, "cpu")
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    base = TM.loss_fn(params, tx, ty, tcfg).item()
    heavy = TM.loss_fn(params, tx, ty,
                       tcfg.replace(moe_aux_weight=1.0)).item()
    assert heavy - base > 0.5, (base, heavy)
    if tcfg.vocab_size == 16500:
        monkeypatch.setattr(TFH, "ENABLE", True)
        np.testing.assert_allclose(TM.loss_fn(params, tx, ty, tcfg).item(),
                                   jloss, rtol=2e-5)


def test_moe_vit_loss_and_all_grads_match_jax(monkeypatch):
    from test_torch_vit import SMALL_VIT, _images, vit_cfgs
    jcfg, tcfg = vit_cfgs(**MOE)
    arrs = np_params(tcfg, 7)
    x, y = _images(tcfg, 7)
    jloss, jgrads = jax.value_and_grad(JM.loss_fn)(
        {k: jnp.asarray(v) for k, v in arrs.items()}, jnp.asarray(x),
        jnp.asarray(y), jcfg)
    gaps = _gap_recorder(monkeypatch)
    leaves = {k: v.requires_grad_(True)
              for k, v in TP.from_numpy(arrs, tcfg, "cpu").items()}
    loss = TM.loss_fn(leaves, torch.from_numpy(x), torch.from_numpy(y), tcfg)
    loss.backward()
    assert min(gaps) > MIN_GAP and SMALL_VIT["num_layers"] == len(gaps)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-5)
    _assert_grads({k: p.grad for k, p in leaves.items()}, jgrads)


def test_moe_block_drop_path_drops_the_moe_branch():
    """Stochastic depth on the MoE branch: keep flags all False leave x as
    it was; the MoE branch alone dropped equals the attention half."""
    from test_torch_vit import vit_cfgs
    _, tcfg = vit_cfgs(**MOE)
    p = TM.layer(TP.from_numpy(np_params(tcfg, 8), tcfg, "cpu"), 0)
    assert "routerw" in p
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 17, 128)).astype(np.float32))
    none = torch.zeros(2, 2, dtype=torch.bool)
    out, aux = TM._block_moe(x, p, tcfg, False, none, 0.5)
    torch.testing.assert_close(out, x, rtol=0, atol=0)
    assert aux.item() > 0
    keep = torch.tensor([[True, True], [False, False]])
    out, _ = TM._block_moe(x, p, tcfg, False, keep, 0.5)
    attn = TM._attn_residual(x, p, tcfg, False, keep, 0.5)
    torch.testing.assert_close(out, attn, rtol=0, atol=0)


@pytest.fixture(scope="module")
def decode_case():
    """The small MoE GPT at cap factor 8 (no drops, as tests/test_moe.py's
    decode test): prompt, the JAX prefill logits, torch cfg, prepared
    params."""
    jcfg, tcfg = small_cfgs(vocab_size=97, num_experts=4, moe_top_k=2,
                            moe_cap_factor=8.0)
    arrs = np_params(tcfg, 9)
    prompt = np.random.default_rng(9).integers(0, 97, (2, 8)).astype(np.int32)
    caches = JG.init_kv_cache(jcfg, 2, 16)
    jlg, _ = JG.forward_with_cache({k: jnp.asarray(v) for k, v in arrs.items()},
                                   jnp.asarray(prompt), caches, 0, jcfg)
    pp = TM.prepare_params(TP.from_numpy(arrs, tcfg, "cpu"), tcfg)
    return prompt, np.asarray(jlg), tcfg, pp


def test_moe_prefill_and_decode_logits_match_the_full_forward(decode_case):
    prompt, jlg, tcfg, pp = decode_case
    tp = torch.from_numpy(prompt).long()
    full = TM.gpt_forward(pp, tp, tcfg).float()
    caches = TG.init_kv_cache(tcfg, 2, 16, device="cpu")
    lg, caches = TG.forward_with_cache(pp, tp, caches, 0, tcfg)
    np.testing.assert_allclose(lg.numpy(), full.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lg.numpy(), jlg, rtol=2e-5, atol=2e-5)
    nxt = lg[:, -1].argmax(-1)[:, None]
    lg1, _ = TG.forward_with_cache(pp, nxt, caches, 8, tcfg)
    full2 = TM.gpt_forward(pp, torch.cat([tp, nxt], 1), tcfg).float()
    np.testing.assert_allclose(lg1[:, 0].numpy(), full2[:, -1].numpy(),
                               rtol=2e-5, atol=2e-5)


def test_moe_chunked_generate_and_engine_match_generate(decode_case):
    """Greedy tokens: whole-prompt generate, chunked generate and the
    engine (whose decode routes every slot, idle ones included) agree
    where no assignment is dropped."""
    prompt, _, tcfg, pp = decode_case
    tp = torch.from_numpy(prompt).long()
    whole = TG.generate(pp, tp, tcfg, 6, temperature=0.0)
    chunked = TG.generate(pp, tp, tcfg, 6, temperature=0.0, prefill_chunk=4)
    np.testing.assert_array_equal(chunked.numpy(), whole.numpy())
    eng = GenerationEngine(pp, tcfg, max_slots=4, max_len=16,
                           prompt_buckets=(8, 16), decode_chunk=2)
    for row in prompt:
        eng.submit(row, max_new=6)
    outs = dict(eng.run())
    for i in range(2):
        np.testing.assert_array_equal(outs[i], whole[i].numpy())


def test_moe_checkpoints_load_in_both_directions(tmp_path):
    jcfg, tcfg = small_cfgs(vocab_size=97, **MOE)
    arrs = np_params(tcfg, 10)
    JC.save_checkpoint(str(tmp_path / "jax.bin"),
                       {k: jnp.asarray(v) for k, v in arrs.items()}, jcfg)
    got, cfg, _ = TC.load_checkpoint(str(tmp_path / "jax.bin"))
    assert (cfg.num_experts, cfg.moe_top_k) == (4, 2)
    params = TP.from_numpy(got, cfg, "cpu")
    for k, v in arrs.items():
        np.testing.assert_array_equal(params[k].numpy(), v)
    TC.save_checkpoint(str(tmp_path / "torch.bin"), params, tcfg)
    back, jc, _ = JC.load_checkpoint(str(tmp_path / "torch.bin"))
    assert jc.num_experts == 4 and set(back) == set(arrs)
    for k, v in arrs.items():
        np.testing.assert_array_equal(np.asarray(back[k]), v)


def test_moe_preset_has_the_jax_parameter_count():
    cfg = torch_config("gpt2-moe-8e")
    assert TP.num_parameters(cfg) == 521_197_824
    assert TP.param_shapes(cfg)["fcw"] == (12, 8, 3072, 768)


@pytest.mark.parametrize("name,group", [
    ("void at::native::index_elementwise_kernel<128, 4, ...>", "index/"),
    ("void at::native::(anonymous namespace)::indexSelectLargeIndex<...>",
     "index/"),
    ("void at_cuda_detail::cub::DeviceScanKernel<...>", "index/"),
    ("void at::native::bitonicSortKVInPlace<...>", "index/"),
    ("void at::native::_scatter_gather_elementwise_kernel<...>", "index/"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "elementwise"),
    ("void at::native::reduce_kernel<512, 1, ...>", "reductions"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT", "cuBLAS"),
    ("flash_fwd_wgmma<false, false>", "flash_fwd")])
def test_profiling_groups_the_moe_kernels(name, group):
    """utils/profiling.py sends the index, gather, scatter, scan and sort
    kernels (the MoE layer's routing, dispatch and combine among them) to
    their own group, before the catch-all eager elementwise group."""
    from vitrs_tpu_torch.utils import profiling
    assert group in profiling._group(name)

