"""The operations and bytes of each kernel metric's work, counted from the
cell's shapes and requests, whatever implements the kernels.

Each function takes the cell's `Shape` and the outcome's `work` record
(what the traced window completed: "steps" of a training cell,
"batches" of an inference cell, "prompts", the prompt lengths a prefill
cell served) and returns a list of (ops, bytes, count) items, one per kind
of launch.  A roofline share sums max(ops / peak FLOP/s, bytes / peak
bytes/s) x count over the items and divides it by the device time of the
kernels the metric's pattern matches (`readers/kernels.py`).

Rules (PERF.md section 2): each input byte is read once and each output
byte written once (bf16 activations and weights, fp32 optimizer state
and statistics); causal attention counts its visible pairs only; the
attention backward counts the four products it needs (dV, dP, dQ, dK), not
the forward's recomputed S; matmuls count the unpadded vocabulary; in a
prefill cell only the prompts' own tokens count, not the padding of a
bucket or of a group, and the head runs on one row a prompt.
"""

from __future__ import annotations

from typing import List, Tuple

from . import flops as F

BF16, FP32 = 2, 4

Item = Tuple[float, float, float]   # (ops, bytes, count)


def _mm(m: int, k: int, n: int, count: float = 1.0) -> Item:
    """(m, k) @ (k, n) in bf16."""
    return (2.0 * m * k * n, BF16 * (m * k + k * n + m * n), count)


def _layer_mms(s, rows: int, count: float) -> List[Item]:
    C, H = s.channels, s.mlp_ratio * s.channels
    return [_mm(rows, C, s.qkv_dim, count), _mm(rows, C, C, count),
            _mm(rows, C, H, count), _mm(rows, H, C, count)]


def _with_backward(items: List[Item]) -> List[Item]:
    """Each forward product (m, k) @ (k, n) and its two backward products,
    dX = dY (m, n) @ W^T and dW = X^T (k, m) @ dY: three of equal ops."""
    out = []
    for item in items:
        out.append(item)
        out.append(item)          # dX: reads dY and W, writes dX
        out.append(item)          # dW: reads X and dY, writes dW
    return out


def _pairs(T: int, causal: bool) -> float:
    return T * (T + 1) / 2.0 if causal else float(T * T)


def _attn_fwd(s, batch: int, T: int, causal: bool, count: float) -> Item:
    D, H = s.head_size, s.num_heads
    ops = 4.0 * D * _pairs(T, causal) * H * batch
    byts = BF16 * 4 * batch * T * s.channels + FP32 * batch * H * T
    return (ops, byts, count)


def _attn_bwd(s, batch: int, T: int, causal: bool, count: float) -> Item:
    D, H = s.head_size, s.num_heads
    ops = 8.0 * D * _pairs(T, causal) * H * batch
    byts = BF16 * 8 * batch * T * s.channels + FP32 * batch * H * T
    return (ops, byts, count)


def _batch_and_T(s, work) -> Tuple[int, int]:
    return work["batch"], s.seq_len


# -- matmuls -----------------------------------------------------------------

def gemm_train(s, work) -> List[Item]:
    B, T = _batch_and_T(s, work)
    n = work["steps"]
    rows = B * T
    fwd = _layer_mms(s, rows, n * s.num_layers)
    if s.mode == "gpt":
        fwd.append(_mm(rows, s.channels, s.vocab_size, n))
        return _with_backward(fwd)
    patch = _mm(B * s.num_patches, s.patch_size ** 2 * s.in_chans,
                s.channels, n)
    head = _mm(B, s.channels, s.num_classes, n)
    # the images take no gradient: the patch embedding's backward is dW only
    return _with_backward(fwd + [head]) + [patch, patch]


def gemm_infer(s, work) -> List[Item]:
    B, T = _batch_and_T(s, work)
    n = work["batches"]
    items = _layer_mms(s, B * T, n * s.num_layers)
    items.append(_mm(B * s.num_patches, s.patch_size ** 2 * s.in_chans,
                     s.channels, n))
    items.append(_mm(B, s.channels, s.num_classes, n))
    return items


def gemm_prefill(s, work) -> List[Item]:
    items = []
    for T0 in work["prompt_lens"]:
        items += _layer_mms(s, T0, s.num_layers)
        items.append(_mm(1, s.channels, s.vocab_size, 1))
    return items


# -- attention kernels -----------------------------------------------------

def flash_fwd_train(s, work) -> List[Item]:
    B, T = _batch_and_T(s, work)
    return [_attn_fwd(s, B, T, s.mode == "gpt", work["steps"] * s.num_layers)]


def flash_bwd_train(s, work) -> List[Item]:
    B, T = _batch_and_T(s, work)
    return [_attn_bwd(s, B, T, s.mode == "gpt", work["steps"] * s.num_layers)]


def flash_fwd_infer(s, work) -> List[Item]:
    B, T = _batch_and_T(s, work)
    return [_attn_fwd(s, B, T, False, work["batches"] * s.num_layers)]


def flash_fwd_prefill(s, work) -> List[Item]:
    return [_attn_fwd(s, 1, T0, True, s.num_layers)
            for T0 in work["prompt_lens"]]


# -- loss and optimizer ----------------------------------------------------

def ce_train(s, work) -> List[Item]:
    """K5 reads the (rows, V) bf16 logits; K6 reads them and writes their
    gradient."""
    B, T = _batch_and_T(s, work)
    logits = BF16 * B * T * s.vocab_size
    return [(0.0, logits, work["steps"]), (0.0, 2 * logits, work["steps"])]


def adamw_train(s, work) -> List[Item]:
    """K7 reads p, g, m, v and writes p, m, v, all fp32."""
    return [(0.0, FP32 * 7 * work["params"], work["steps"])]


# -- model FLOPs for MFU ---------------------------------------------------

def model_flops(s, work) -> float:
    """The model FLOPs of what the window completed (flops.py's
    conventions): 3x the forward a training example, the forward an
    inference example, and a prefill prompt's forward at its own length
    with the head on its one served row."""
    if "prompt_lens" in work:
        total = 0.0
        for T0 in work["prompt_lens"]:
            at = s.replace(max_seq_len=T0)
            total += (F.forward_flops_per_example(at)
                      - 2 * T0 * s.channels * s.vocab_size
                      + 2 * s.channels * s.vocab_size)
        return total
    if "steps" in work:
        return F.train_flops_per_example(s) * work["steps"] * work["batch"]
    return F.forward_flops_per_example(s) * work["batches"] * work["batch"]
