"""The metric arithmetic against hand counts: a rate is all work over all
time, the p95 is the nearest rank with its samples beyond it counted,
each roofline bound is the larger of ops over the peak and bytes over the
bandwidth, the trace's union, gaps and idle share, and the readers'
silence where there is nothing to read."""

import math
import types

import pytest

from portbench.readers import kernels, model
from portbench.shape import Shape
from portbench.spec import Spec
from portbench.tracing import TraceSummary, _union_and_gaps
from portbench.traffic import prefill
from portbench.yardstick import flops, groups, peaks, work

GPT = Shape.from_config(Spec().config("gpt2-124m"))
VIT = Shape.from_config(Spec().config("vit-b-16"))
H100 = "NVIDIA H100 80GB HBM3"


def summary(kernel_s, busy=1.0, window=2.0):
    return TraceSummary(kernel_s=kernel_s, busy_s=busy, window_s=window,
                        device_ops=[], idle_gaps=[], events=len(kernel_s))


def ctx(s):
    return types.SimpleNamespace(shape=s, device_name=H100)


def metric(reader_args):
    return {"args": reader_args}


def test_p95_is_the_nearest_rank():
    values = list(range(1, 101))            # 1..100
    assert prefill.p95(values) == 95
    assert prefill.p95(list(range(1, 21))) == 19
    assert prefill.p95([7.0]) == 7.0
    # 2000 requests: 100 samples lie beyond it
    assert 2000 - math.ceil(0.95 * 2000) == 100


def test_peaks_are_the_data_sheet_and_unknown_cards_raise():
    assert peaks.peak_flops(H100, "bfloat16") == 989e12
    assert peaks.peak_bytes_per_s(H100) == 3.35e12
    with pytest.raises(ValueError):
        peaks.peak_flops("NVIDIA A100-SXM4-80GB", "bfloat16")


def test_flops_per_token_of_gpt2_and_per_image_of_vit():
    # GPT-2 124M: 24 C^2 a token and layer, 4 T C attention, 2 C V head
    C, L, T, V = 768, 12, 1024, 50257
    fwd = T * 24 * C * C * L + 4 * T * T * C * L + 2 * T * C * V
    assert flops.forward_flops_per_example(GPT) == fwd
    assert flops.train_flops_per_example(GPT) / T == pytest.approx(
        854.9e6, rel=1e-3)
    T = 197
    fwd = (T * 24 * C * C * L + 4 * T * T * C * L + 2 * T * 768 * C
           + 2 * C * 1000)
    assert flops.forward_flops_per_example(VIT) == fwd


def test_adamw_bound_by_hand():
    """K7 moves 28 bytes a parameter (p, g, m, v in; p, m, v out)."""
    n = 124_439_808
    items = work.adamw_train(GPT, {"steps": 2, "batch": 64, "params": n})
    bound_s = sum(max(o / 989e12, b / 3.35e12) * c for o, b, c in items)
    assert bound_s == pytest.approx(2 * 28 * n / 3.35e12)
    # a kernel time equal to the bound reads 100%
    s = summary({"void adamw<float>(float*, ...)": bound_s})
    m = metric({"pattern": r"\badamw", "work": "adamw_train"})
    out = types.SimpleNamespace(work={"steps": 2, "batch": 64, "params": n})
    assert kernels.roofline(ctx(GPT), out, s, m) == pytest.approx(100.0)


def test_flash_forward_counts_visible_pairs_and_bytes():
    B, T, H, D = 8, 1024, 12, 64
    (ops, byts, count), = work.flash_fwd_train(
        GPT, {"steps": 1, "batch": B, "params": 0})
    assert ops == 4 * D * (T * (T + 1) / 2) * H * B
    assert byts == 2 * 4 * B * T * 768 + 4 * B * H * T
    assert count == 12
    # the bytes bound it at B=8: 0.0150 ms a launch
    assert max(ops / 989e12, byts / 3.35e12) == pytest.approx(
        byts / 3.35e12)
    (ops_nc, _, _), = work.flash_fwd_infer(VIT, {"batches": 1, "batch": 2})
    assert ops_nc == 4 * D * 197 * 197 * H * 2
    (ops_b, byts_b, _), = work.flash_bwd_train(
        GPT, {"steps": 1, "batch": B, "params": 0})
    assert ops_b == 2 * ops and byts_b == 2 * 4 * 2 * B * T * 768 \
        + 4 * B * H * T


def test_ce_bytes_by_hand():
    R, V = 64 * 1024, 50257
    items = work.ce_train(GPT, {"steps": 1, "batch": 64, "params": 0})
    assert [b for _, b, _ in items] == [2 * R * V, 4 * R * V]


def test_gemm_train_is_three_times_the_forward_products():
    w = {"steps": 1, "batch": 2, "params": 0}
    ops = sum(o * c for o, _, c in work.gemm_train(GPT, w))
    rows, C, V = 2 * 1024, 768, 50257
    fwd = 2 * rows * (3 * C * C + C * C + 8 * C * C) * 12 + 2 * rows * C * V
    assert ops == 3 * fwd
    # vit: the patch embedding takes no input gradient
    ops_v = sum(o * c for o, _, c in work.gemm_train(VIT, w))
    patch = 2 * 2 * 196 * 768 * 768
    blocks = (2 * 197) * 24 * C * C * 12
    head = 2 * 2 * C * 1000
    assert ops_v == 3 * (blocks + head) + 2 * patch


def test_prefill_counts_prompts_not_padding():
    w = {"prompt_lens": [100, 300]}
    (ops_a, _, _), (ops_b, _, _) = work.flash_fwd_prefill(GPT, w)
    assert ops_a == 4 * 64 * (100 * 101 / 2) * 12
    assert ops_b == 4 * 64 * (300 * 301 / 2) * 12
    mf = work.model_flops(GPT, w)
    C, V = 768, 50257
    want = sum(T * 24 * C * C * 12 + 4 * T * T * C * 12 + 2 * C * V
               for T in (100, 300))
    assert mf == want


def test_mfu_is_all_work_over_the_window():
    out = types.SimpleNamespace(work={"steps": 10, "batch": 64})
    s = summary({"k": 1.0}, busy=1.9, window=4.0)
    got = model.mfu(ctx(GPT), out, s, {})
    want = 100 * 10 * 64 * flops.train_flops_per_example(GPT) / 4.0 / 989e12
    assert got == pytest.approx(want)


def test_eager_share_and_idle_share():
    s = summary({"void flash_fwd_wgmma<64>(Maps, Args)": 1.0,
                 "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTT": 2.0,
                 "void at::native::vectorized_elementwise_kernel<4>": 3.0,
                 "Memcpy DtoD (Device -> Device)": 2.0,
                 "void ce_fwd<__nv_bfloat16>(...)": 1.0,
                 "void adamw<float>(...)": 1.0}, busy=9.0, window=12.0)
    assert kernels.eager_share(None, None, s, {}) == pytest.approx(50.0)
    assert kernels.idle_share(None, None, s, {}) == pytest.approx(25.0)
    assert groups.group("void at::native::reduce_kernel<512, 1>") == \
        "eager reductions"
    assert groups.group("void ce_bwd<__nv_bfloat16>(...)") == \
        "fused CE (K5/K6)"


def test_readers_are_silent_without_anything_to_read():
    out = types.SimpleNamespace(work={"steps": 1, "batch": 1, "params": 1},
                                counters={})
    empty = summary({}, busy=0.0, window=1.0)
    m = metric({"pattern": "flash_bwd", "work": "flash_bwd_train"})
    assert kernels.roofline(ctx(GPT), out, empty, m) is None
    assert kernels.roofline(ctx(GPT), out, None, m) is None
    assert kernels.eager_share(None, out, empty, {}) is None
    assert kernels.idle_share(None, out, empty, {}) is None
    assert model.mfu(ctx(GPT), out, empty, {}) is None
    assert model.ratio(None, out, empty,
                       metric({"num": "a", "den": "b"})) is None
    out.counters = {"a": 30, "b": 4}
    assert model.ratio(None, out, empty,
                       metric({"num": "a", "den": "b"})) == 7.5


def test_union_and_gaps_of_overlapping_kernels():
    iv = [(1.0, 2.0, "a"), (1.5, 3.0, "b"), (5.0, 6.0, "c"), (9.5, 11.0, "d")]
    busy, gaps = _union_and_gaps(iv, 0.0, 10.0)
    assert busy == pytest.approx(2.0 + 1.0 + 0.5)
    assert gaps == [(0.0, 1.0), (3.0, 5.0), (6.0, 9.5)]

