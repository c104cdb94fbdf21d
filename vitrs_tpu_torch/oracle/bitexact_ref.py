"""Scalar bit-exact oracle — literal transcription of the reference's loops.
The port's copy of `vitrs_tpu/oracle/bitexact_ref.py` (numpy only), with
the transcendentals of the port's bitmath.py, bitwise equal to the JAX
package's.

Unlike numpy_ref.py (vectorized, numpy reduction order), this module executes
the EXACT scalar operation sequence of the reference kernels, element by
element, entirely in f32:

  * matmul:      rusty_vit.rs:484-498   (val = bias; val += inp[i]*w[i], i asc)
  * attention:   rusty_vit.rs:512-563   (running max from -10000, exp-sum asc,
                                         normalize 0..t [G5], V-accum t2 asc)
  * layernorm:   rusty_vit.rs:578-605   (mean asc /C, var asc /C, 1/sqrt)
  * gelu:        rusty_vit.rs:614-623
  * softmax:     rusty_vit.rs:634-658   (max from -10000 [G11], /= sum)
  * crossentropy:rusty_vit.rs:836-843   (loss = -probs[target], G6)
  * backwards:   rusty_vit.rs:670-854 + train_vit.rs:559-601, with the exact
                 accumulation orders of each loop nest (matmul dinp over o
                 asc; dweight/dbias over bt asc; attention's three loop nests;
                 layernorm's two-pass dnorm means; gelu G15 cosh(2a))
  * orchestration: forward rusty_vit.rs:269-351, backward :354-449 (the
                 += order into the shared dresidual stream is preserved)

Transcendentals come from bitmath.py (shared f32 polynomial exp/tanh/cosh)
so the jitted-framework side (ops/bitexact.py) can reproduce every bit.

Python-loop scalar code: only usable at tiny scale (the bit-parity gate,
BASELINE.md 'fp32 bit-parity at tiny scale').
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..bitmath import exp32, tanh32, cosh32

F = np.float32
GELU_S = F(np.sqrt(np.float32(2.0) / np.float32(np.pi)))
C_GELU = F(0.044715)
EPS = F(1e-5)


def matmul_forward(x, w, b=None):
    B, T, C = x.shape
    OC = w.shape[0]
    out = np.empty((B, T, OC), np.float32)
    for bi in range(B):
        for t in range(T):
            for o in range(OC):
                val = b[o] if b is not None else F(0.0)
                for i in range(C):
                    val += x[bi, t, i] * w[o, i]
                out[bi, t, o] = val
    return out


def matmul_backward(dout, x, w, has_bias=True):
    B, T, C = x.shape
    OC = w.shape[0]
    dx = np.zeros((B, T, C), np.float32)
    dw = np.zeros_like(w)
    db = np.zeros(OC, np.float32) if has_bias else None
    for bi in range(B):                        # pass 1: dinp, o ascending
        for t in range(T):
            for o in range(OC):
                d = dout[bi, t, o]
                for i in range(C):
                    dx[bi, t, i] += w[o, i] * d
    for o in range(OC):                        # pass 2: dw/db, bt ascending
        for bi in range(B):
            for t in range(T):
                d = dout[bi, t, o]
                if has_bias:
                    db[o] += d
                for i in range(C):
                    dw[o, i] += x[bi, t, i] * d
    return dx, dw, db


def layernorm_forward(x, w, b):
    B, T, C = x.shape
    out = np.empty_like(x)
    mean = np.empty((B, T), np.float32)
    rstd = np.empty((B, T), np.float32)
    cf = F(C)
    for bi in range(B):
        for t in range(T):
            m = F(0.0)
            for i in range(C):
                m += x[bi, t, i]
            m /= cf
            v = F(0.0)
            for i in range(C):
                xs = x[bi, t, i] - m
                v += xs * xs
            v /= cf
            s = F(1.0) / np.sqrt(v + EPS)
            for i in range(C):
                n = s * (x[bi, t, i] - m)
                out[bi, t, i] = n * w[i] + b[i]
            mean[bi, t] = m
            rstd[bi, t] = s
    return out, mean, rstd


def layernorm_backward(dout, x, w, mean, rstd, dx_acc=None):
    """dx accumulates into dx_acc if given (the reference += contract)."""
    B, T, C = x.shape
    dx = dx_acc if dx_acc is not None else np.zeros_like(x)
    dw = np.zeros(C, np.float32)
    db = np.zeros(C, np.float32)
    cf = F(C)
    for bi in range(B):
        for t in range(T):
            m, s = mean[bi, t], rstd[bi, t]
            dnm = F(0.0)
            dnnm = F(0.0)
            for i in range(C):
                norm = (x[bi, t, i] - m) * s
                dn = w[i] * dout[bi, t, i]
                dnm += dn
                dnnm += dn * norm
            dnm /= cf
            dnnm /= cf
            for i in range(C):
                norm = (x[bi, t, i] - m) * s
                dn = w[i] * dout[bi, t, i]
                db[i] += dout[bi, t, i]
                dw[i] += norm * dout[bi, t, i]
                dval = F(0.0)
                dval += dn
                dval -= dnm
                dval -= norm * dnnm
                dval *= s
                dx[bi, t, i] += dval
    return dx, dw, db


def attention_forward(qkv, num_heads):
    """Causal, quirks-as-written: -10000 max init (G11), normalization loop
    excludes t2 == t (G5), expsum==0 guard."""
    B, T, C3 = qkv.shape
    C = C3 // 3
    NH = num_heads
    HS = C // NH
    scale = F(1.0) / np.sqrt(F(HS))
    out = np.zeros((B, T, C), np.float32)
    att = np.zeros((B, NH, T, T), np.float32)
    preatt = np.zeros((B, NH, T, T), np.float32)
    for bi in range(B):
        for t in range(T):
            for h in range(NH):
                q0 = h * HS
                maxval = F(-10000.0)
                for t2 in range(t + 1):
                    val = F(0.0)
                    for i in range(HS):
                        val += qkv[bi, t, q0 + i] * qkv[bi, t2, C + q0 + i]
                    val *= scale
                    if val > maxval:
                        maxval = val
                    preatt[bi, h, t, t2] = val
                expsum = F(0.0)
                for t2 in range(t + 1):
                    expv = exp32(preatt[bi, h, t, t2] - maxval, np)
                    expsum += expv
                    att[bi, h, t, t2] = expv
                inv = F(0.0) if expsum == F(0.0) else F(1.0) / expsum
                for t2 in range(t):                       # G5: excludes t2==t
                    att[bi, h, t, t2] *= inv
                for t2 in range(t + 1):
                    a = att[bi, h, t, t2]
                    for i in range(HS):
                        out[bi, t, q0 + i] += a * qkv[bi, t2, 2 * C + q0 + i]
    return out, att, preatt


def attention_backward(dout, qkv, att, num_heads):
    """train_vit.rs:559-601, exact loop nests and accumulation order."""
    B, T, C = dout.shape
    NH = num_heads
    HS = C // NH
    scale = F(1.0) / np.sqrt(F(HS))
    dqkv = np.zeros_like(qkv)
    datt = np.zeros_like(att)
    dpre = np.zeros_like(att)
    for bi in range(B):
        for t in range(T):
            for h in range(NH):
                q0 = h * HS
                for t2 in range(t + 1):
                    for i in range(HS):
                        datt[bi, h, t, t2] += (qkv[bi, t2, 2 * C + q0 + i]
                                               * dout[bi, t, q0 + i])
                        dqkv[bi, t2, 2 * C + q0 + i] += (att[bi, h, t, t2]
                                                         * dout[bi, t, q0 + i])
                for t2 in range(t + 1):
                    for t3 in range(t + 1):
                        ind = F(1.0) if t2 == t3 else F(0.0)
                        local = att[bi, h, t, t2] * (ind - att[bi, h, t, t3])
                        dpre[bi, h, t, t3] += local * datt[bi, h, t, t2]
                for t2 in range(t + 1):
                    for i in range(HS):
                        dqkv[bi, t, q0 + i] += (qkv[bi, t2, C + q0 + i]
                                                * dpre[bi, h, t, t2] * scale)
                        dqkv[bi, t2, C + q0 + i] += (qkv[bi, t, q0 + i]
                                                     * dpre[bi, h, t, t2] * scale)
    return dqkv


def gelu_forward(x):
    out = np.empty_like(x)
    flat = x.reshape(-1)
    of = out.reshape(-1)
    for i in range(flat.size):
        xi = flat[i]
        cube = C_GELU * xi * xi * xi
        of[i] = F(0.5) * xi * (F(1.0) + tanh32(GELU_S * (xi + cube), np))
    return out


def gelu_backward(dout, x):
    """G15 as written: cosh(2a) where the true derivative needs cosh(a)."""
    out = np.empty_like(x)
    xf, df, of = x.reshape(-1), dout.reshape(-1), out.reshape(-1)
    for i in range(xf.size):
        xi = xf[i]
        cube = C_GELU * xi * xi * xi
        a = GELU_S * (xi + cube)
        th = tanh32(a, np)
        ch = cosh32(F(2.0) * a, np)
        sech = F(1.0) / (ch * ch)
        local = (F(0.5) * (F(1.0) + th)
                 + xi * F(0.5) * sech * GELU_S
                 * (F(1.0) + F(3.0) * C_GELU * xi * xi))
        of[i] = local * df[i]
    return out


def softmax_forward(logits):
    """G11: running max from -10000; division (not multiply-by-inverse)."""
    B, T, V = logits.shape
    probs = np.empty_like(logits)
    for bi in range(B):
        for t in range(T):
            maxval = F(-10000.0)
            for i in range(V):
                if logits[bi, t, i] > maxval:
                    maxval = logits[bi, t, i]
            s = F(0.0)
            for i in range(V):
                probs[bi, t, i] = exp32(logits[bi, t, i] - maxval, np)
                s += probs[bi, t, i]
            for i in range(V):
                probs[bi, t, i] /= s
    return probs


def model_forward(params: Dict[str, np.ndarray], inputs: np.ndarray,
                  targets: Optional[np.ndarray], num_heads: int
                  ) -> Tuple[np.float32, dict]:
    """rusty_vit.rs:269-351, scalar order; returns (mean_loss, acts)."""
    B, T = inputs.shape
    L = params["ln1w"].shape[0]
    acts: dict = {k: [] for k in
                  ("ln1", "ln1_mean", "ln1_rstd", "qkv", "atty", "att",
                   "attproj", "residual2", "ln2", "ln2_mean", "ln2_rstd",
                   "fch", "fch_gelu", "fcproj", "residual3")}
    x = np.empty((B, T, params["wte"].shape[1]), np.float32)
    for bi in range(B):
        for t in range(T):
            x[bi, t] = params["wte"][inputs[bi, t]] + params["wpe"][t]
    acts["encoded"] = x
    residual = x
    for l in range(L):
        ln1, m1, r1 = layernorm_forward(residual, params["ln1w"][l],
                                        params["ln1b"][l])
        qkv = matmul_forward(ln1, params["qkvw"][l], params["qkvb"][l])
        atty, att, _ = attention_forward(qkv, num_heads)
        attproj = matmul_forward(atty, params["attprojw"][l],
                                 params["attprojb"][l])
        residual2 = residual + attproj       # elementwise, orderless
        ln2, m2, r2 = layernorm_forward(residual2, params["ln2w"][l],
                                        params["ln2b"][l])
        fch = matmul_forward(ln2, params["fcw"][l], params["fcb"][l])
        fch_gelu = gelu_forward(fch)
        fcproj = matmul_forward(fch_gelu, params["fcprojw"][l],
                                params["fcprojb"][l])
        residual3 = residual2 + fcproj
        for k_, v_ in (("ln1", ln1), ("ln1_mean", m1), ("ln1_rstd", r1),
                       ("qkv", qkv), ("atty", atty), ("att", att),
                       ("attproj", attproj), ("residual2", residual2),
                       ("ln2", ln2), ("ln2_mean", m2), ("ln2_rstd", r2),
                       ("fch", fch), ("fch_gelu", fch_gelu),
                       ("fcproj", fcproj), ("residual3", residual3)):
            acts[k_].append(v_)
        residual = residual3
    lnf, mf, rf = layernorm_forward(residual, params["lnfw"], params["lnfb"])
    logits = matmul_forward(lnf, params["wte"], None)
    probs = softmax_forward(logits)
    acts.update(lnf=lnf, lnf_mean=mf, lnf_rstd=rf, logits=logits, probs=probs)
    if targets is None:
        return F(-1.0), acts
    # G6: loss = -probs[target]; mean accumulated flat-ascending then divided
    mean_loss = F(0.0)
    losses = np.empty((B, T), np.float32)
    for bi in range(B):
        for t in range(T):
            losses[bi, t] = -probs[bi, t, targets[bi, t]]
    for i in range(B * T):
        mean_loss += losses.reshape(-1)[i]
    mean_loss /= F(B * T)
    acts["losses"] = losses
    return mean_loss, acts


def model_backward(params: Dict[str, np.ndarray], acts: dict,
                   inputs: np.ndarray, targets: np.ndarray,
                   num_heads: int) -> Dict[str, np.ndarray]:
    """rusty_vit.rs:354-449 with llm.c's intended crossentropy_softmax_backward
    (G3: dlogits = (p - onehot) * dloss) and encoder_backward (G2)."""
    B, T = inputs.shape
    V, C = params["wte"].shape
    L = params["ln1w"].shape[0]
    g = {k: np.zeros_like(v) for k, v in params.items()}

    dloss_mean = F(1.0) / F(B * T)
    probs = acts["probs"]
    dlogits = np.empty_like(probs)
    for bi in range(B):
        for t in range(T):
            for i in range(V):
                ind = F(1.0) if i == targets[bi, t] else F(0.0)
                dlogits[bi, t, i] = (probs[bi, t, i] - ind) * dloss_mean
    dlnf, dwte_head, _ = matmul_backward(dlogits, acts["lnf"], params["wte"],
                                         has_bias=False)
    g["wte"] += dwte_head
    residual = acts["residual3"][L - 1]
    dresidual3, dlnfw, dlnfb = layernorm_backward(
        dlnf, residual, params["lnfw"], acts["lnf_mean"], acts["lnf_rstd"])
    g["lnfw"] += dlnfw
    g["lnfb"] += dlnfb
    for l in reversed(range(L)):
        res_in = acts["encoded"] if l == 0 else acts["residual3"][l - 1]
        dresidual2 = dresidual3.copy()       # residual_backward: += dout
        dfcproj = dresidual3
        dfch_gelu, dpw, dpb = matmul_backward(dfcproj, acts["fch_gelu"][l],
                                              params["fcprojw"][l])
        g["fcprojw"][l] += dpw
        g["fcprojb"][l] += dpb
        dfch = gelu_backward(dfch_gelu, acts["fch"][l])
        dln2, dfw, dfb = matmul_backward(dfch, acts["ln2"][l], params["fcw"][l])
        g["fcw"][l] += dfw
        g["fcb"][l] += dfb
        _, dw2, db2 = layernorm_backward(dln2, acts["residual2"][l],
                                         params["ln2w"][l],
                                         acts["ln2_mean"][l],
                                         acts["ln2_rstd"][l],
                                         dx_acc=dresidual2)
        g["ln2w"][l] += dw2
        g["ln2b"][l] += db2
        dres_in = dresidual2.copy()          # residual_backward again
        dattproj = dresidual2
        datty, daw, dab = matmul_backward(dattproj, acts["atty"][l],
                                          params["attprojw"][l])
        g["attprojw"][l] += daw
        g["attprojb"][l] += dab
        dqkv = attention_backward(datty, acts["qkv"][l], acts["att"][l],
                                  num_heads)
        dln1, dqw, dqb = matmul_backward(dqkv, acts["ln1"][l],
                                         params["qkvw"][l])
        g["qkvw"][l] += dqw
        g["qkvb"][l] += dqb
        _, dw1, db1 = layernorm_backward(dln1, res_in, params["ln1w"][l],
                                         acts["ln1_mean"][l],
                                         acts["ln1_rstd"][l], dx_acc=dres_in)
        g["ln1w"][l] += dw1
        g["ln1b"][l] += db1
        dresidual3 = dres_in
    # encoder_backward (G2): dwte[ix] += d, dwpe[t] += d, (b, t) ascending
    for bi in range(B):
        for t in range(T):
            g["wte"][inputs[bi, t]] += dresidual3[bi, t]
            g["wpe"][t] += dresidual3[bi, t]
    return g
