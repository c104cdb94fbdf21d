"""NumPy parity oracle — reference-as-written semantics.  The port's copy
of `vitrs_tpu/oracle/numpy_ref.py` (numpy only; tests pin it equal to the
original on the same inputs), plus `model_backward_quirks` below.

This module re-implements the math of the reference (ViT.rs) exactly as
written, in NumPy, to serve as the ground truth the framework is validated
against (SURVEY.md §7 stage 1).  It is NOT part of the production path.

`quirks=True` reproduces the reference's literal behavior:
  G5  — attention softmax normalization loop runs 0..t, *excluding* t2 == t
        (attention.rs:42-44, rusty_vit.rs:546-548, train_vit.rs:434-436): the
        current token's own weight is left un-normalized.
  G6  — crossentropy_forward negates the raw probability, no log
        (rusty_vit.rs:836-843: `-*logits.add(i*nc+target)` called with probs).
  G11 — running-max initialized to -10000.0, not -inf (rusty_vit.rs:524,640;
        train_vit.rs:412).

`quirks=False` is the corrected math (true softmax, -log p loss, -inf init),
matching the production JAX path's semantics so both can be cross-checked.

Backward is the reference's hand-sequenced reverse pass (rusty_vit.rs:354-449)
with += accumulation; the two ops the reference calls but never defines —
encoder_backward and crossentropy_softmax_backward (gaps G2/G3) — are supplied
with their llm.c-intended semantics, as the survey prescribes.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

GELU_S = np.sqrt(2.0 / np.pi).astype(np.float32)
EPS = 1e-5


# ---------------------------------------------------------------------------
# kernels (reference L1 layer, rusty_vit.rs:460-854)
# ---------------------------------------------------------------------------

def encoder_forward(inputs, wte, wpe):
    """llm.c semantics for the undefined encoder (G2): wte lookup + wpe add."""
    B, T = inputs.shape
    return wte[inputs] + wpe[None, :T, :]


def encoder_backward(dencoded, inputs, V, maxT):
    B, T, C = dencoded.shape
    dwte = np.zeros((V, C), dencoded.dtype)
    np.add.at(dwte, inputs.reshape(-1), dencoded.reshape(-1, C))
    dwpe = np.zeros((maxT, C), dencoded.dtype)
    dwpe[:T] = dencoded.sum(axis=0)
    return dwte, dwpe


def layernorm_forward(x, w, b):
    """rusty_vit.rs:578-605; stashes mean and rstd like the reference."""
    mean = x.mean(axis=-1)
    var = ((x - mean[..., None]) ** 2).mean(axis=-1)
    rstd = 1.0 / np.sqrt(var + EPS)
    out = (x - mean[..., None]) * rstd[..., None] * w + b
    return out, mean, rstd


def layernorm_backward(dout, x, w, mean, rstd):
    """rusty_vit.rs:737-783: fused dgamma/dbeta/dx using stashed mean/rstd."""
    norm = (x - mean[..., None]) * rstd[..., None]
    dnorm = w * dout
    dbias = dout.reshape(-1, dout.shape[-1]).sum(0)
    dweight = (norm * dout).reshape(-1, dout.shape[-1]).sum(0)
    dnorm_mean = dnorm.mean(axis=-1, keepdims=True)
    dnorm_norm_mean = (dnorm * norm).mean(axis=-1, keepdims=True)
    dx = (dnorm - dnorm_mean - norm * dnorm_norm_mean) * rstd[..., None]
    return dx, dweight, dbias


def matmul_forward(x, w, b=None):
    """y = x @ W.T + b with W stored (OC, C) row-major (rusty_vit.rs:484-498)."""
    y = x @ w.T
    if b is not None:
        y = y + b
    return y


def matmul_backward(dout, x, w):
    """rusty_vit.rs:693-720: dinp, dweight, dbias."""
    dx = dout @ w
    C = x.shape[-1]
    OC = dout.shape[-1]
    dw = dout.reshape(-1, OC).T @ x.reshape(-1, C)
    db = dout.reshape(-1, OC).sum(0)
    return dx, dw, db


def attention_forward(qkv, num_heads, quirks=False, causal=True):
    """Multi-head causal attention over packed qkv (B,T,3C).

    Mirrors rusty_vit.rs:512-563 / attention.rs.  Returns (out, att, preatt)
    with att/preatt shaped (B, NH, T, T) and zero outside the causal prefix,
    exactly the stashed buffers the reference keeps for backward.
    """
    B, T, C3 = qkv.shape
    C = C3 // 3
    NH = num_heads
    HS = C // NH
    scale = 1.0 / np.sqrt(HS)
    q = qkv[:, :, :C].reshape(B, T, NH, HS).transpose(0, 2, 1, 3)
    k = qkv[:, :, C:2 * C].reshape(B, T, NH, HS).transpose(0, 2, 1, 3)
    v = qkv[:, :, 2 * C:].reshape(B, T, NH, HS).transpose(0, 2, 1, 3)

    scores = np.einsum("bhqd,bhkd->bhqk", q, k) * scale        # (B,NH,T,T)
    if causal:
        mask = np.tril(np.ones((T, T), bool))
    else:
        mask = np.ones((T, T), bool)
    neg = np.float32(-np.inf)
    masked = np.where(mask, scores, neg)
    maxval = masked.max(axis=-1, keepdims=True)
    if quirks:
        maxval = np.maximum(maxval, -10000.0)                   # G11
    e = np.where(mask, np.exp(masked - maxval), 0.0)
    s = e.sum(axis=-1, keepdims=True)
    inv = np.where(s == 0.0, 0.0, 1.0 / s)                      # expsum==0 guard
    att = e * inv
    if quirks and causal:
        # G5: diagonal (t2 == t) element keeps its *unnormalized* value
        diag = np.arange(T)
        att[:, :, diag, diag] = e[:, :, diag, diag]
    preatt = np.where(mask, scores, 0.0)
    out = np.einsum("bhqk,bhkd->bhqd", att, v)
    out = out.transpose(0, 2, 1, 3).reshape(B, T, C)
    return out, att, preatt


def attention_backward(dout, qkv, att, num_heads, causal=True):
    """train_vit.rs:559-601 semantics: dV/datt from dout, softmax Jacobian
    att*(delta - att) into dpreatt, then dQ/dK with scale on both."""
    B, T, C = dout.shape
    NH = num_heads
    HS = C // NH
    scale = 1.0 / np.sqrt(HS)
    q = qkv[:, :, :C].reshape(B, T, NH, HS).transpose(0, 2, 1, 3)
    k = qkv[:, :, C:2 * C].reshape(B, T, NH, HS).transpose(0, 2, 1, 3)
    v = qkv[:, :, 2 * C:].reshape(B, T, NH, HS).transpose(0, 2, 1, 3)
    do = dout.reshape(B, T, NH, HS).transpose(0, 2, 1, 3)

    dv = np.einsum("bhqk,bhqd->bhkd", att, do)
    datt = np.einsum("bhqd,bhkd->bhqk", do, v)
    if causal:
        mask = np.tril(np.ones((T, T), bool))
        datt = np.where(mask, datt, 0.0)
    # softmax Jacobian: dpre[q,k] = sum_j att[q,j] * (delta_jk - att[q,k]) * datt[q,j]
    inner = (datt * att).sum(axis=-1, keepdims=True)
    dpre = att * (datt - inner) * scale
    dq = np.einsum("bhqk,bhkd->bhqd", dpre, k)
    dk = np.einsum("bhqk,bhqd->bhkd", dpre, q)
    dqkv = np.concatenate([
        dq.transpose(0, 2, 1, 3).reshape(B, T, C),
        dk.transpose(0, 2, 1, 3).reshape(B, T, C),
        dv.transpose(0, 2, 1, 3).reshape(B, T, C)], axis=-1)
    return dqkv, dpre


def gelu_forward(x):
    """tanh-approx GELU, rusty_vit.rs:614-623."""
    cube = 0.044715 * x * x * x
    return 0.5 * x * (1.0 + np.tanh(GELU_S * (x + cube)))


def gelu_backward(dout, x, quirks=False):
    """Analytic tanh-GELU gradient.

    Gap G15 (discovered during the build, not in SURVEY.md's ledger): the
    reference computes `coshf_out = cosh(2*tanh_arg)` and uses
    1/coshf_out^2 (rusty_vit.rs:800-802) — i.e. sech^2(2a) where the true
    derivative needs sech^2(a) (llm.c uses cosh(tanh_arg)).  A transcription
    bug, latent because the repo never compiled.  quirks=True reproduces it;
    default is the correct math (which is what the finite-difference tests
    pin)."""
    cube = 0.044715 * x * x * x
    a = GELU_S * (x + cube)
    t = np.tanh(a)
    if quirks:
        sech2 = 1.0 / np.cosh(2.0 * a) ** 2       # reference-as-written (G15)
    else:
        sech2 = 1.0 / np.cosh(a) ** 2
    local = 0.5 * (1.0 + t) + x * 0.5 * sech2 * GELU_S * (1.0 + 3.0 * 0.044715 * x * x)
    return local * dout


def softmax_forward(logits, quirks=False):
    """rusty_vit.rs:634-658 — row softmax with max subtraction; quirk G11
    initializes the running max at -10000."""
    m = logits.max(axis=-1, keepdims=True)
    if quirks:
        m = np.maximum(m, -10000.0)
    e = np.exp(logits - m)
    return e / e.sum(axis=-1, keepdims=True)


def crossentropy_forward(probs, targets, quirks=False):
    """quirk G6: reference negates the raw probability without log."""
    B, T, V = probs.shape
    p = probs.reshape(-1, V)[np.arange(B * T), targets.reshape(-1)].reshape(B, T)
    return -p if quirks else -np.log(p)


def softmax_backward_dense(dout, probs):
    """Dense softmax Jacobian (rusty_vit.rs:819-834) — defined in the
    reference but never called on the model path (gap G12); kept for
    inventory completeness and as a check against the fused CE-softmax
    backward.  dinp[i] = sum_j (p[i] - delta_ij) * dout[j]... as written the
    reference accumulates (p_i - delta_ij)*dout_j, i.e. p_i*sum(dout) - dout_i."""
    s = dout.sum(axis=-1, keepdims=True)
    return probs * s - dout


def crossentropy_backward_dense(probs_or_logits, targets):
    """rusty_vit.rs:845-854 as written: dlogits[j] = -value[j] if j==target
    else 0 — also never called (gap G12)."""
    out = np.zeros_like(probs_or_logits)
    B, T, V = probs_or_logits.shape
    flat = out.reshape(-1, V)
    src = probs_or_logits.reshape(-1, V)
    idx = np.arange(B * T)
    flat[idx, targets.reshape(-1)] = -src[idx, targets.reshape(-1)]
    return out


def crossentropy_softmax_backward(dlosses, probs, targets):
    """llm.c-intended fused backward for the undefined symbol (G3):
    dlogits = (probs - onehot) * dloss."""
    B, T, V = probs.shape
    onehot = np.zeros_like(probs)
    onehot.reshape(-1, V)[np.arange(B * T), targets.reshape(-1)] = 1.0
    return (probs - onehot) * dlosses[..., None]


# ---------------------------------------------------------------------------
# model orchestration (reference L2, rusty_vit.rs:269-449)
# ---------------------------------------------------------------------------

def model_forward(params: Dict[str, np.ndarray], inputs: np.ndarray,
                  targets: Optional[np.ndarray], num_heads: int,
                  quirks: bool = False) -> Tuple[float, dict]:
    """Exact op sequence of rusty_vit.rs:269-351. Returns (mean_loss, acts).

    mean_loss == -1.0 when targets is None (inference mode sentinel,
    rusty_vit.rs:348-350)."""
    L = params["ln1w"].shape[0]
    acts = {"ln1": [], "ln1_mean": [], "ln1_rstd": [], "qkv": [], "atty": [],
            "att": [], "preatt": [], "attproj": [], "residual2": [], "ln2": [],
            "ln2_mean": [], "ln2_rstd": [], "fch": [], "fch_gelu": [],
            "fcproj": [], "residual3": []}
    x = encoder_forward(inputs, params["wte"], params["wpe"])
    acts["encoded"] = x
    residual = x
    for l in range(L):
        ln1, m1, r1 = layernorm_forward(residual, params["ln1w"][l], params["ln1b"][l])
        qkv = matmul_forward(ln1, params["qkvw"][l], params["qkvb"][l])
        atty, att, preatt = attention_forward(qkv, num_heads, quirks=quirks)
        attproj = matmul_forward(atty, params["attprojw"][l], params["attprojb"][l])
        residual2 = residual + attproj
        ln2, m2, r2 = layernorm_forward(residual2, params["ln2w"][l], params["ln2b"][l])
        fch = matmul_forward(ln2, params["fcw"][l], params["fcb"][l])
        fch_gelu = gelu_forward(fch)
        fcproj = matmul_forward(fch_gelu, params["fcprojw"][l], params["fcprojb"][l])
        residual3 = residual2 + fcproj
        for k_, v_ in (("ln1", ln1), ("ln1_mean", m1), ("ln1_rstd", r1),
                       ("qkv", qkv), ("atty", atty), ("att", att),
                       ("preatt", preatt), ("attproj", attproj),
                       ("residual2", residual2), ("ln2", ln2), ("ln2_mean", m2),
                       ("ln2_rstd", r2), ("fch", fch), ("fch_gelu", fch_gelu),
                       ("fcproj", fcproj), ("residual3", residual3)):
            acts[k_].append(v_)
        residual = residual3
    lnf, mf, rf = layernorm_forward(residual, params["lnfw"], params["lnfb"])
    logits = matmul_forward(lnf, params["wte"], None)       # weight-tied, no bias
    probs = softmax_forward(logits, quirks=quirks)
    acts.update(lnf=lnf, lnf_mean=mf, lnf_rstd=rf, logits=logits, probs=probs)
    if targets is None:
        return -1.0, acts
    losses = crossentropy_forward(probs, targets, quirks=quirks)
    acts["losses"] = losses
    return float(losses.mean()), acts


def model_backward(params: Dict[str, np.ndarray], acts: dict, inputs: np.ndarray,
                   targets: np.ndarray, num_heads: int) -> Dict[str, np.ndarray]:
    """Hand-sequenced reverse pass of rusty_vit.rs:354-449 (corrected-math
    semantics throughout — the reference's backward is llm.c's, which is the
    gradient of the *corrected* forward)."""
    B, T = inputs.shape
    V, C = params["wte"].shape
    L = params["ln1w"].shape[0]
    maxT = params["wpe"].shape[0]
    g = {k: np.zeros_like(v) for k, v in params.items()}

    dlosses = np.full((B, T), 1.0 / (B * T), dtype=np.float32)
    dlogits = crossentropy_softmax_backward(dlosses, acts["probs"], targets)
    # head matmul backward: logits = lnf @ wte.T  (tied weights, rusty_vit.rs:372)
    dlnf, dwte_head, _ = matmul_backward(dlogits, acts["lnf"], params["wte"])
    g["wte"] += dwte_head
    residual = acts["residual3"][L - 1]
    dres, dlnfw, dlnfb = layernorm_backward(dlnf, residual, params["lnfw"],
                                            acts["lnf_mean"], acts["lnf_rstd"])
    g["lnfw"] += dlnfw
    g["lnfb"] += dlnfb
    dresidual3 = dres
    for l in reversed(range(L)):
        res_in = acts["encoded"] if l == 0 else acts["residual3"][l - 1]
        # residual3 = residual2 + fcproj
        dresidual2 = dresidual3.copy()
        dfcproj = dresidual3
        dfch_gelu, dfcw_, dfcb_ = matmul_backward(dfcproj, acts["fch_gelu"][l],
                                                  params["fcprojw"][l])
        g["fcprojw"][l] += dfcw_
        g["fcprojb"][l] += dfcb_
        dfch = gelu_backward(dfch_gelu, acts["fch"][l])
        dln2, dfw, dfb = matmul_backward(dfch, acts["ln2"][l], params["fcw"][l])
        g["fcw"][l] += dfw
        g["fcb"][l] += dfb
        dx2, dw2, db2 = layernorm_backward(dln2, acts["residual2"][l],
                                           params["ln2w"][l], acts["ln2_mean"][l],
                                           acts["ln2_rstd"][l])
        g["ln2w"][l] += dw2
        g["ln2b"][l] += db2
        dresidual2 = dresidual2 + dx2
        # residual2 = residual_in + attproj
        dres_in = dresidual2.copy()
        dattproj = dresidual2
        datty, daw, dab = matmul_backward(dattproj, acts["atty"][l],
                                          params["attprojw"][l])
        g["attprojw"][l] += daw
        g["attprojb"][l] += dab
        dqkv, _ = attention_backward(datty, acts["qkv"][l], acts["att"][l],
                                     num_heads)
        dln1, dqw, dqb = matmul_backward(dqkv, acts["ln1"][l], params["qkvw"][l])
        g["qkvw"][l] += dqw
        g["qkvb"][l] += dqb
        dx1, dw1, db1 = layernorm_backward(dln1, res_in, params["ln1w"][l],
                                           acts["ln1_mean"][l], acts["ln1_rstd"][l])
        g["ln1w"][l] += dw1
        g["ln1b"][l] += db1
        dresidual3 = dres_in + dx1
    dwte_enc, dwpe = encoder_backward(dresidual3, inputs, V, maxT)
    g["wte"] += dwte_enc
    g["wpe"] += dwpe
    return g


def init_parameters(cfg_shapes: Dict[str, tuple], seed: int = 0) -> Dict[str, np.ndarray]:
    """Seeded analogue of the reference init (rusty_vit.rs:864-903):
    uniform [0, 0.02) weights, LN weights 1, biases 0."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shp in cfg_shapes.items():
        if name in ("ln1w", "ln2w", "lnfw"):
            out[name] = np.ones(shp, np.float32)
        elif name.endswith("b") or name == "cls":
            out[name] = np.zeros(shp, np.float32)
        else:
            out[name] = (rng.random(shp, dtype=np.float32) * 0.02)
    return out


# ---------------------------------------------------------------------------
# the port's addition: the gradient of the as-written (quirks=True) forward
# ---------------------------------------------------------------------------

def attention_backward_quirks(dout, qkv, att, num_heads):
    """The exact gradient of attention_forward(quirks=True, causal=True).

    Off the diagonal att is the true softmax p = e / S, whose Jacobian is
    p (delta - p); the diagonal is the raw e_t = exp(s_t - m) (G5), whose
    derivative reaches the row max m, and through m the argmax key (the
    derivative splits evenly over tied maxima), unless G11's floor -1e4
    holds m.  Returns dqkv."""
    B, T, C = dout.shape
    NH = num_heads
    HS = C // NH
    scale = 1.0 / np.sqrt(HS)

    def heads(t):
        return t.reshape(B, T, NH, HS).transpose(0, 2, 1, 3)

    q, k, v = (heads(qkv[:, :, i * C:(i + 1) * C]) for i in range(3))
    do = heads(dout)
    mask = np.tril(np.ones((T, T), bool))
    masked = np.where(mask, np.einsum("bhqd,bhkd->bhqk", q, k) * scale,
                      np.float32(-np.inf))
    rowmax = masked.max(axis=-1, keepdims=True)
    e = np.where(mask, np.exp(masked - np.maximum(rowmax, -10000.0)), 0.0)
    p = e / e.sum(axis=-1, keepdims=True)
    tie = (masked == rowmax) & (rowmax > -10000.0)
    tie = tie / tie.sum(axis=-1, keepdims=True)
    eye = np.eye(T, dtype=bool)
    datt = np.where(mask, np.einsum("bhqd,bhkd->bhqk", do, v), 0.0)
    off = np.where(eye, 0.0, datt * att)
    diag = (np.diagonal(datt, axis1=-2, axis2=-1)
            * np.diagonal(e, axis1=-2, axis2=-1))[..., None]
    dpre = (off - p * off.sum(axis=-1, keepdims=True)
            + np.where(eye, diag, 0.0) - tie * diag) * scale
    dq = np.einsum("bhqk,bhkd->bhqd", dpre, k)
    dk = np.einsum("bhqk,bhqd->bhkd", dpre, q)
    dv = np.einsum("bhqk,bhqd->bhkd", att, do)

    def merge(t):
        return t.transpose(0, 2, 1, 3).reshape(B, T, C)

    return np.concatenate([merge(dq), merge(dk), merge(dv)], axis=-1)


def model_backward_quirks(params: Dict[str, np.ndarray], acts: dict,
                          inputs: np.ndarray, targets: np.ndarray,
                          num_heads: int) -> Dict[str, np.ndarray]:
    """The exact gradient of model_forward(quirks=True)'s loss, which
    autograd takes through the as-written forward: the reference's own
    backward (`model_backward`) is llm.c's, the gradient of the corrected
    forward, and its G15 GELU backward is not the GELU forward's
    derivative.  Differs from `model_backward` in two places: the G6 loss
    -mean(p_target) gives dlogits = p_target (probs - onehot) / (B T),
    and attention is `attention_backward_quirks`.  acts from
    model_forward(..., quirks=True)."""
    B, T = inputs.shape
    V, C = params["wte"].shape
    L = params["ln1w"].shape[0]
    maxT = params["wpe"].shape[0]
    g = {k: np.zeros_like(v) for k, v in params.items()}
    probs = acts["probs"]
    picked = probs.reshape(-1, V)[np.arange(B * T),
                                  targets.reshape(-1)].reshape(B, T)
    dlosses = (picked / (B * T)).astype(np.float32)
    dlogits = crossentropy_softmax_backward(dlosses, probs, targets)
    dlnf, dwte_head, _ = matmul_backward(dlogits, acts["lnf"], params["wte"])
    g["wte"] += dwte_head
    dres, dlnfw, dlnfb = layernorm_backward(dlnf, acts["residual3"][L - 1],
                                            params["lnfw"], acts["lnf_mean"],
                                            acts["lnf_rstd"])
    g["lnfw"] += dlnfw
    g["lnfb"] += dlnfb
    for l in reversed(range(L)):
        res_in = acts["encoded"] if l == 0 else acts["residual3"][l - 1]
        dfch_gelu, dw, db = matmul_backward(dres, acts["fch_gelu"][l],
                                            params["fcprojw"][l])
        g["fcprojw"][l] += dw
        g["fcprojb"][l] += db
        dfch = gelu_backward(dfch_gelu, acts["fch"][l])
        dln2, dw, db = matmul_backward(dfch, acts["ln2"][l], params["fcw"][l])
        g["fcw"][l] += dw
        g["fcb"][l] += db
        dx, dw, db = layernorm_backward(dln2, acts["residual2"][l],
                                        params["ln2w"][l], acts["ln2_mean"][l],
                                        acts["ln2_rstd"][l])
        g["ln2w"][l] += dw
        g["ln2b"][l] += db
        dres2 = dres + dx
        datty, dw, db = matmul_backward(dres2, acts["atty"][l],
                                        params["attprojw"][l])
        g["attprojw"][l] += dw
        g["attprojb"][l] += db
        dqkv = attention_backward_quirks(datty, acts["qkv"][l], acts["att"][l],
                                         num_heads)
        dln1, dw, db = matmul_backward(dqkv, acts["ln1"][l], params["qkvw"][l])
        g["qkvw"][l] += dw
        g["qkvb"][l] += db
        dx, dw, db = layernorm_backward(dln1, res_in, params["ln1w"][l],
                                        acts["ln1_mean"][l],
                                        acts["ln1_rstd"][l])
        g["ln1w"][l] += dw
        g["ln1b"][l] += db
        dres = dres2 + dx
    dwte_enc, dwpe = encoder_backward(dres, inputs, V, maxT)
    g["wte"] += dwte_enc
    g["wpe"] += dwpe
    return g
