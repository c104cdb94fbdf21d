"""The port's kernels as `torch.library` custom ops (`vitrs::*`): each op's
schema and fake (shape-only) version checked by `torch.library.opcheck`
against its CPU implementation, the plain version, at small shapes (the
flash ops also on the ring's rectangle, a query offset past the keys'
end: dq like q, dk and dv like k); and an
op traced by `torch.export` stays one node of the graph."""

import math

import numpy as np
import pytest
import torch

from vitrs_tpu_torch.ops import (basic, flash_attention as FA,
                                 flash_attention_gqa as FG,
                                 flash_prefill as FP, fused_adamw as FW,
                                 fused_ce as CE, fused_head_ce as HC)

CHECKS = ("test_schema", "test_faketensor")
D = 64             # GPT-2's head dim, one of FA.HEAD_DIMS
assert D in FA.HEAD_DIMS


def _t(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dtype)


def _cases():
    rng = np.random.default_rng(0)
    B, T, NH, KH = 2, 8, 2, 1
    C, KV = NH * D, KH * D
    qkv = _t(rng, B, T, 3 * C)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    s = 1.0 / math.sqrt(D)
    out, lse = FA.flash_fwd_plain(q, k, v, NH, True, s)
    do = _t(rng, B, T, C)
    gq = _t(rng, B, T, C + 2 * KV)
    gq_q, gq_k, gq_v = FG.split_gqa(gq, NH, KH)
    gout, glse = FG.flash_gqa_fwd_plain(gq_q, gq_k, gq_v, NH, KH, True, s)
    # the rectangle of the ring's cut hop: 5 queries at offset 4 against 6
    # keys, under a window of 3
    rq, rk, rv = q[:, :5], k[:, 2:], v[:, 2:]
    rout, rlse = FA.flash_fwd_plain(rq, rk, rv, NH, True, s, q_offset=4,
                                    window=3)
    grq, grk, grv = gq_q[:, :5], gq_k[:, 2:], gq_v[:, 2:]
    grout, grlse = FG.flash_gqa_fwd_plain(grq, grk, grv, NH, KH, True, s, 3,
                                          False, 4)
    cache = _t(rng, B, 256, KV)
    R, V = 6, 64
    logits = _t(rng, R, V)
    tgt = torch.from_numpy(rng.integers(0, 50, R))
    clse, _ = CE.ce_fwd_plain(logits, tgt, 50)
    n = 37
    return {
        "flash_fwd": (FA.flash_fwd_op, (q, k, v, NH, True, s, 0, False)),
        "flash_fwd_rope_band": (FA.flash_fwd_op,
                                (q, k, v, NH, True, s, 4, True)),
        "flash_bwd": (FA.flash_bwd_op,
                      (q, k, v, out, lse, do, NH, True, s, 0, False)),
        "flash_gqa_fwd": (FG.flash_gqa_fwd_op,
                          (gq_q, gq_k, gq_v, NH, KH, True, s, 0, False)),
        "flash_gqa_bwd": (FG.flash_gqa_bwd_op,
                          (gq_q, gq_k, gq_v, gout, glse, do, NH, KH, True, s,
                           0, False)),
        "flash_fwd_rect": (FA.flash_fwd_op,
                           (rq, rk, rv, NH, True, s, 3, False, 4)),
        "flash_bwd_rect": (FA.flash_bwd_op,
                           (rq, rk, rv, rout, rlse, do[:, :5], NH, True, s,
                            3, False, 4)),
        "flash_gqa_fwd_rect": (FG.flash_gqa_fwd_op,
                               (grq, grk, grv, NH, KH, True, s, 3, False,
                                4)),
        "flash_gqa_bwd_rect": (FG.flash_gqa_bwd_op,
                               (grq, grk, grv, grout, grlse, do[:, :5], NH,
                                KH, True, s, 3, False, 4)),
        "flash_prefill": (FP.flash_prefill_op,
                          (q[:, :4], cache[..., :KV], cache, NH, KH, 3, s, 0)),
        "ce_fwd": (CE.ce_fwd, (logits, tgt, 50)),
        "ce_bwd": (CE.ce_bwd, (logits, tgt, clse, _t(rng, R), 50)),
        "head_ce_fwd": (HC.head_ce_fwd, (_t(rng, R, 32), _t(rng, 128, 32),
                                         tgt, 100)),
        "adamw_": (FW.adamw_op, (_t(rng, n), _t(rng, n), _t(rng, n),
                                 _t(rng, n).abs(), 3.0, 1e-2, 0.9, 0.999,
                                 1e-8, 0.1)),
        "gelu_fwd": (basic.gelu_fwd_op, (_t(rng, 3, n, dtype=torch.bfloat16),
                                      False)),
        "gelu_fwd_erf": (basic.gelu_fwd_op, (_t(rng, n), True)),
        "gelu_bwd": (basic.gelu_bwd_op, (_t(rng, n), _t(rng, n), False)),
        "gelu_bwd_erf": (basic.gelu_bwd_op, (_t(rng, 2, n, dtype=torch.bfloat16),
                                          _t(rng, 2, n, dtype=torch.bfloat16),
                                          True)),
    }


@pytest.mark.parametrize("name", sorted(_cases()))
def test_opcheck_cpu(name):
    op, args = _cases()[name]
    assert torch.library.opcheck(op, args, test_utils=CHECKS) == {
        c: "SUCCESS" for c in CHECKS}


def test_ops_live_in_one_namespace():
    names = {op.name() for op, _ in _cases().values()}
    assert names == {f"vitrs::{n}" for n in (
        "flash_fwd", "flash_bwd", "flash_gqa_fwd", "flash_gqa_bwd",
        "flash_prefill", "ce_fwd", "ce_bwd", "head_ce_fwd", "gelu_fwd",
        "gelu_bwd", "adamw_")}


def test_adamw_op_updates_in_place_as_the_plain_version():
    rng = np.random.default_rng(1)
    p, g, m, v = (_t(rng, 19) for _ in range(4))
    v = v.abs()
    want = [t.clone() for t in (p, m, v)]
    FW.adamw_plain(want[0], g, want[1], want[2], 2, 1e-2, weight_decay=0.1)
    FW.adamw_op(p, g, m, v, 2.0, 1e-2, 0.9, 0.999, 1e-8, 0.1)
    for got, w in zip((p, m, v), want):
        torch.testing.assert_close(got, w, rtol=0, atol=0)


def test_export_keeps_the_kernel_one_node():
    class Attn(torch.nn.Module):
        def forward(self, qkv):
            return FA.flash_attention_fwd(qkv, 2)[0]

    qkv = _t(np.random.default_rng(2), 1, 8, 3 * 2 * D)
    ep = torch.export.export(Attn(), (qkv,))
    targets = [n.target for n in ep.graph.nodes if n.op == "call_function"]
    assert torch.ops.vitrs.flash_fwd.default in targets
    torch.testing.assert_close(ep.module()(qkv), Attn()(qkv), rtol=0, atol=0)


def test_a_device_without_an_implementation_raises():
    """The ops have CPU and CUDA implementations only: a meta tensor takes
    the fake version, and nothing computes on any other device."""
    q = torch.empty((1, 8, 2 * D), device="meta")
    out, lse = FA.flash_fwd_op(q, q, q, 2, True, 0.125, 0, False)
    assert out.shape == q.shape and lse.shape == (1, 2, 8)
    assert not FA.flash_fwd_cuda.launches
