"""Bit-exact parity mode — the port of `vitrs_tpu/ops/bitexact.py`.

Computes the reference model's loss and all 16 parameter gradients with the
exact per-lane IEEE-754 f32 operation sequence of the reference's scalar
loops (rusty_vit.rs:484-854, train_vit.rs:559-601), vectorised only over
independent lanes; every reduction is a Python loop in the reference's
ascending order (no torch.sum, mean, matmul or softmax where the JAX module
loops).  Held bitwise (==, not allclose) against the scalar transcription
oracle (oracle/bitexact_ref.py) on the CPU and on the card.

Eager torch ops on the tensors' own device: each op is its own kernel, so
no multiply-add can be contracted into an FMA across ops, and PyTorch's
f32 add, mul, div and sqrt are correctly rounded on the CPU and on CUDA
(no fast-math), hence bit-identical to numpy.  Transcendentals come from
bitmath.py (the polynomial exp/tanh/cosh in `bitmath.TORCH`).  Scalars
enter as Python floats on a tensor's right, which hold each f32 constant
exactly; 1/x is a true division (`bitmath.TORCH.reciprocal`).

A tiny-scale tool by design (Python loops, one kernel launch per op); the
production path (models/model.py) keeps cuBLAS and the flash kernels.  The
quirks G5/G6/G11/G15 are reproduced as written, like the oracle.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..bitmath import TORCH, cosh32, exp32, tanh32
from ._build import resolve_device

F = np.float32
GELU_S = float(F(np.sqrt(np.float32(2.0) / np.float32(np.pi))))
C_GELU = float(F(0.044715))
C3_GELU = float(F(3.0) * F(0.044715))
EPS = float(F(1e-5))
QUIRK_MAX_INIT = float(F(-10000.0))
recip = TORCH.reciprocal


def _zeros(shape, like):
    return torch.zeros(shape, dtype=torch.float32, device=like.device)


def matmul_forward(x, w, b=None):
    """val = bias; val += x[i] * w[o, i], i ascending (rusty_vit.rs:484-498)."""
    B, T, C = x.shape
    OC = w.shape[0]
    acc = b.expand(B, T, OC) if b is not None else _zeros((B, T, OC), x)
    for i in range(C):
        acc = acc + x[:, :, i:i + 1] * w[None, None, :, i]
    return acc


def matmul_backward(dout, x, w, has_bias=True):
    """Two passes in the reference order (rusty_vit.rs:693-720): dinp
    accumulates over o ascending; dweight/dbias over bt ascending."""
    B, T, C = x.shape
    OC = w.shape[0]
    dx = _zeros((B, T, C), x)
    for o in range(OC):
        dx = dx + w[None, None, o, :] * dout[:, :, o:o + 1]
    dw = torch.zeros_like(w)
    db = _zeros((OC,), x) if has_bias else None
    xf = x.reshape(B * T, C)
    df = dout.reshape(B * T, OC)
    for bt in range(B * T):
        if has_bias:
            db = db + df[bt]
        dw = dw + xf[bt][None, :] * df[bt][:, None]
    return dx, dw, db


def layernorm_forward(x, w, b):
    """Ascending mean/var accumulation, /C division (rusty_vit.rs:578-605)."""
    B, T, C = x.shape
    cf = float(C)
    m = _zeros((B, T), x)
    for i in range(C):
        m = m + x[:, :, i]
    m = m / cf
    v = _zeros((B, T), x)
    for i in range(C):
        xs = x[:, :, i] - m
        v = v + xs * xs
    v = v / cf
    s = recip(torch.sqrt(v + EPS))
    n = s[..., None] * (x - m[..., None])
    return n * w + b, m, s


def layernorm_backward(dout, x, w, mean, rstd, dx_acc=None):
    """rusty_vit.rs:737-783: two ascending reduce loops, then the elementwise
    dval sequence (+=dnorm; -=dnorm_mean; -=norm*dnnm; *=rstd)."""
    B, T, C = x.shape
    cf = float(C)
    m = mean[..., None]
    s = rstd[..., None]
    dnm = _zeros((B, T), x)
    dnnm = _zeros((B, T), x)
    for i in range(C):
        norm_i = (x[:, :, i] - mean) * rstd
        dn_i = w[i] * dout[:, :, i]
        dnm = dnm + dn_i
        dnnm = dnnm + dn_i * norm_i
    dnm = dnm / cf
    dnnm = dnnm / cf
    norm = (x - m) * s
    dn = w * dout
    dval = ((dn - dnm[..., None]) - norm * dnnm[..., None]) * s
    dx = dval if dx_acc is None else dx_acc + dval
    dw = _zeros((C,), x)
    db = _zeros((C,), x)
    nf = norm.reshape(B * T, C)
    df = dout.reshape(B * T, C)
    for bt in range(B * T):
        db = db + df[bt]
        dw = dw + nf[bt] * df[bt]
    return dx, dw, db


def _split_heads(qkv, num_heads):
    B, T, C3 = qkv.shape
    C = C3 // 3
    HS = C // num_heads
    x = qkv.reshape(B, T, 3, num_heads, HS)
    return x[:, :, 0], x[:, :, 1], x[:, :, 2], C, HS   # (B,T,NH,HS) each


def attention_forward(qkv, num_heads):
    """Scalar online-softmax order per (b,t,h) lane: -10000 max init (G11),
    exp-sum ascending, normalization excluding t2==t (G5), V-accum t2
    ascending (rusty_vit.rs:512-563).  Returns (out, att) with att as a
    nested python list att[t][t2] of (B,NH) lane tensors."""
    q, k, v, C, HS = _split_heads(qkv, num_heads)
    B, T, NH = q.shape[0], q.shape[1], q.shape[2]
    scale = float(F(1.0) / np.sqrt(F(HS)))
    att: list = []
    outs = []
    for t in range(T):
        pre = []
        maxval = torch.full((B, NH), QUIRK_MAX_INIT, device=qkv.device)
        for t2 in range(t + 1):
            val = _zeros((B, NH), qkv)
            for i in range(HS):
                val = val + q[:, t, :, i] * k[:, t2, :, i]
            val = val * scale
            maxval = torch.where(val > maxval, val, maxval)
            pre.append(val)
        expsum = torch.zeros_like(maxval)
        e = []
        for t2 in range(t + 1):
            ev = exp32(pre[t2] - maxval, TORCH)
            expsum = expsum + ev
            e.append(ev)
        inv = torch.where(expsum == 0.0, 0.0, recip(expsum))
        row = [e[t2] * inv for t2 in range(t)] + [e[t]]     # G5: t2==t raw
        att.append(row)
        out_t = _zeros((B, NH, HS), qkv)
        for t2 in range(t + 1):
            out_t = out_t + row[t2][..., None] * v[:, t2]
        outs.append(out_t)
    out = torch.stack(outs, dim=1).reshape(B, T, C)
    return out, att


def attention_backward(dout, qkv, att, num_heads):
    """train_vit.rs:559-601 loop nests: datt over i ascending, dv/dk over
    queries t ascending, dpreatt over t2 ascending, (x*dpre)*scale."""
    q, k, v, C, HS = _split_heads(qkv, num_heads)
    B, T, NH = q.shape[0], q.shape[1], q.shape[2]
    scale = float(F(1.0) / np.sqrt(F(HS)))
    do = dout.reshape(B, T, NH, HS)
    dv_l = [_zeros((B, NH, HS), qkv) for _ in range(T)]
    dk_l = [_zeros((B, NH, HS), qkv) for _ in range(T)]
    dq_l = [_zeros((B, NH, HS), qkv) for _ in range(T)]
    for t in range(T):
        datt = []
        for t2 in range(t + 1):
            acc = _zeros((B, NH), qkv)
            for i in range(HS):
                acc = acc + v[:, t2, :, i] * do[:, t, :, i]
            datt.append(acc)
            dv_l[t2] = dv_l[t2] + att[t][t2][..., None] * do[:, t]
        att_row = torch.stack(att[t], dim=-1)              # (B,NH,t+1)
        eye = torch.eye(t + 1, dtype=torch.float32, device=qkv.device)
        dpre = _zeros((B, NH, t + 1), qkv)
        for t2 in range(t + 1):
            local = att[t][t2][..., None] * (eye[t2] - att_row)
            dpre = dpre + local * datt[t2][..., None]
        for t2 in range(t + 1):
            dq_l[t] = dq_l[t] + (k[:, t2] * dpre[:, :, t2:t2 + 1]) * scale
            dk_l[t2] = dk_l[t2] + (q[:, t] * dpre[:, :, t2:t2 + 1]) * scale
    dq = torch.stack(dq_l, dim=1).reshape(B, T, C)
    dk = torch.stack(dk_l, dim=1).reshape(B, T, C)
    dv = torch.stack(dv_l, dim=1).reshape(B, T, C)
    return torch.cat([dq, dk, dv], dim=-1)


def gelu_forward(x):
    cube = x * C_GELU * x * x
    return x * 0.5 * (tanh32((x + cube) * GELU_S, TORCH) + 1.0)


def gelu_backward(dout, x):
    """G15 as written: sech^2(2a) via cosh(2a) (rusty_vit.rs:800-802)."""
    cube = x * C_GELU * x * x
    a = (x + cube) * GELU_S
    th = tanh32(a, TORCH)
    ch = cosh32(a * 2.0, TORCH)
    sech = recip(ch * ch)
    local = ((th + 1.0) * 0.5
             + x * 0.5 * sech * GELU_S * (x * C3_GELU * x + 1.0))
    return local * dout


def softmax_forward(logits):
    """G11 max init; ascending exp-sum; element-by-sum DIVISION."""
    B, T, V = logits.shape
    maxval = torch.full((B, T), QUIRK_MAX_INIT, device=logits.device)
    for i in range(V):
        maxval = torch.where(logits[:, :, i] > maxval, logits[:, :, i], maxval)
    s = _zeros((B, T), logits)
    e = []
    for i in range(V):
        ev = exp32(logits[:, :, i] - maxval, TORCH)
        s = s + ev
        e.append(ev)
    return torch.stack([ev / s for ev in e], dim=-1)


def model_forward(params: Dict, inputs, targets: Optional[np.ndarray],
                  num_heads: int, device="cuda"
                  ) -> Tuple[torch.Tensor, dict]:
    """Forward in the reference's exact op order (rusty_vit.rs:269-351) on
    `device` (the card unless the caller asks for the CPU).  params: numpy
    arrays or tensors.  Loss mean accumulates flat-ascending then divides,
    like :342-347; -1.0 without targets (the inference sentinel)."""
    device = resolve_device(device)
    p = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
         if not isinstance(v, torch.Tensor)
         else v.to(device=device, dtype=torch.float32)
         for k, v in params.items()}
    inputs = np.asarray(inputs)
    B, T = inputs.shape
    L = p["ln1w"].shape[0]
    acts: dict = {k: [] for k in
                  ("ln1", "ln1_mean", "ln1_rstd", "qkv", "atty", "att",
                   "attproj", "residual2", "ln2", "ln2_mean", "ln2_rstd",
                   "fch", "fch_gelu", "fcproj", "residual3")}
    tok = torch.as_tensor(inputs, dtype=torch.long, device=device)
    x = p["wte"][tok] + p["wpe"][None, :T, :]
    acts["encoded"] = x
    residual = x
    for l in range(L):
        ln1, m1, r1 = layernorm_forward(residual, p["ln1w"][l], p["ln1b"][l])
        qkv = matmul_forward(ln1, p["qkvw"][l], p["qkvb"][l])
        atty, att = attention_forward(qkv, num_heads)
        attproj = matmul_forward(atty, p["attprojw"][l], p["attprojb"][l])
        residual2 = residual + attproj
        ln2, m2, r2 = layernorm_forward(residual2, p["ln2w"][l], p["ln2b"][l])
        fch = matmul_forward(ln2, p["fcw"][l], p["fcb"][l])
        fch_gelu = gelu_forward(fch)
        fcproj = matmul_forward(fch_gelu, p["fcprojw"][l], p["fcprojb"][l])
        residual3 = residual2 + fcproj
        for k_, v_ in (("ln1", ln1), ("ln1_mean", m1), ("ln1_rstd", r1),
                       ("qkv", qkv), ("atty", atty), ("att", att),
                       ("attproj", attproj), ("residual2", residual2),
                       ("ln2", ln2), ("ln2_mean", m2), ("ln2_rstd", r2),
                       ("fch", fch), ("fch_gelu", fch_gelu),
                       ("fcproj", fcproj), ("residual3", residual3)):
            acts[k_].append(v_)
        residual = residual3
    lnf, mf, rf = layernorm_forward(residual, p["lnfw"], p["lnfb"])
    logits = matmul_forward(lnf, p["wte"], None)
    probs = softmax_forward(logits)
    acts.update(lnf=lnf, lnf_mean=mf, lnf_rstd=rf, logits=logits, probs=probs,
                params=p)
    if targets is None:
        return torch.tensor(-1.0, device=device), acts
    targets = np.asarray(targets)
    mean_loss = torch.zeros((), dtype=torch.float32, device=device)
    for bi in range(B):
        for t in range(T):
            mean_loss = mean_loss + -probs[bi, t, int(targets[bi, t])]
    mean_loss = mean_loss / float(B * T)
    return mean_loss, acts


def model_backward(acts: dict, inputs, targets, num_heads: int) -> Dict:
    """Hand-sequenced reverse in the reference's order (rusty_vit.rs:354-449),
    including the += order into the shared dresidual stream."""
    p = acts["params"]
    inputs = np.asarray(inputs)
    targets = np.asarray(targets)
    B, T = inputs.shape
    V, C = p["wte"].shape
    L = p["ln1w"].shape[0]
    g = {k: torch.zeros_like(v) for k, v in p.items()}

    dloss = float(F(1.0) / F(B * T))
    onehot = np.zeros((B, T, V), np.float32)
    for bi in range(B):
        for t in range(T):
            onehot[bi, t, targets[bi, t]] = 1.0
    onehot = torch.as_tensor(onehot, device=p["wte"].device)
    dlogits = (acts["probs"] - onehot) * dloss
    dlnf, dwte_head, _ = matmul_backward(dlogits, acts["lnf"], p["wte"],
                                         has_bias=False)
    g["wte"] = g["wte"] + dwte_head
    dresidual3, dlnfw, dlnfb = layernorm_backward(
        dlnf, acts["residual3"][L - 1], p["lnfw"], acts["lnf_mean"],
        acts["lnf_rstd"])
    g["lnfw"] = g["lnfw"] + dlnfw
    g["lnfb"] = g["lnfb"] + dlnfb

    def add_at(name, l, d):
        g[name][l] = g[name][l] + d

    for l in reversed(range(L)):
        res_in = acts["encoded"] if l == 0 else acts["residual3"][l - 1]
        dfcproj = dresidual3
        dfch_gelu, dpw, dpb = matmul_backward(dfcproj, acts["fch_gelu"][l],
                                              p["fcprojw"][l])
        add_at("fcprojw", l, dpw)
        add_at("fcprojb", l, dpb)
        dfch = gelu_backward(dfch_gelu, acts["fch"][l])
        dln2, dfw, dfb = matmul_backward(dfch, acts["ln2"][l], p["fcw"][l])
        add_at("fcw", l, dfw)
        add_at("fcb", l, dfb)
        dresidual2, dw2, db2 = layernorm_backward(
            dln2, acts["residual2"][l], p["ln2w"][l], acts["ln2_mean"][l],
            acts["ln2_rstd"][l], dx_acc=dresidual3)
        add_at("ln2w", l, dw2)
        add_at("ln2b", l, db2)
        dattproj = dresidual2
        datty, daw, dab = matmul_backward(dattproj, acts["atty"][l],
                                          p["attprojw"][l])
        add_at("attprojw", l, daw)
        add_at("attprojb", l, dab)
        dqkv = attention_backward(datty, acts["qkv"][l], acts["att"][l],
                                  num_heads)
        dln1, dqw, dqb = matmul_backward(dqkv, acts["ln1"][l], p["qkvw"][l])
        add_at("qkvw", l, dqw)
        add_at("qkvb", l, dqb)
        dresidual3, dw1, db1 = layernorm_backward(
            dln1, res_in, p["ln1w"][l], acts["ln1_mean"][l],
            acts["ln1_rstd"][l], dx_acc=dresidual2)
        add_at("ln1w", l, dw1)
        add_at("ln1b", l, db1)
    # encoder_backward (G2): (b, t) ascending scatter
    for bi in range(B):
        for t in range(T):
            add_at("wte", int(inputs[bi, t]), dresidual3[bi, t])
            add_at("wpe", t, dresidual3[bi, t])
    return g


def loss_and_grads(params: Dict, inputs, targets, num_heads: int,
                   device="cuda"):
    """(loss, grads) through the forced-order path, on `device` (the card
    unless the caller asks for the CPU).  Eager by contract."""
    loss, acts = model_forward(params, inputs, targets, num_heads, device)
    return loss, model_backward(acts, inputs, targets, num_heads)
