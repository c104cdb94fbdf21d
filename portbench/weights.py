"""Weights and inputs made from the seed, on the device, by the benchmark
itself: the same tensors go to the program and to the reference.

`make_weights` draws every parameter of the canonical layout in one call
(normal, std 0.02, clipped at 2 std, on a generator on the device), then
scales the residual projections by 1/sqrt(2L), as GPT-2's initialisation
does, and spreads the affine parameters as trained ones are spread: the
LayerNorm gains 1 + N(0, 0.1) (clipped at 2 std), the biases, the
LayerNorm offsets and the CLS token as drawn (std 0.02).  So every bias
add and every LayerNorm's gain and offset changes the served logits, the
cache and the gradients: a program that drops one, or takes it from
another layer, is seen.  Biases much wider than the weights' own std
would swamp the token-dependent part of the residual stream (each layer
adds them to every position alike) and leave a comparison little to see.
`batch_generator` seeds a device generator for the i-th batch of a run,
so a batch can be made again after the window from (seed, i) alone.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .reference import layout

_MIX = 0x9E3779B97F4A7C15
# the LayerNorm gains' spread over the drawn std 0.02: std 0.1 about 1
GAIN_SCALE = 5.0


def sub_seed(seed: int, i: int) -> int:
    """A 63-bit seed for stream i of a run's seed."""
    return ((int(seed) * _MIX) ^ (int(i) * 0xBF58476D1CE4E5B9)) % (1 << 63)


def generator(seed: int, i: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, i))
    return g


def make_weights(s, seed: int, device) -> Dict[str, torch.Tensor]:
    """The canonical fp32 tensors, as views into one flat vector."""
    shapes = layout.shapes(s)
    n = layout.num_parameters(s)
    flat = torch.empty(n, dtype=torch.float32, device=device)
    flat.normal_(0.0, 0.02, generator=generator(seed, 0, device))
    flat.clamp_(-0.04, 0.04)
    out, off = {}, 0
    for name in layout.order(s):
        size = math.prod(shapes[name])
        t = flat[off:off + size].view(shapes[name])
        off += size
        if name in ("ln1w", "ln2w", "lnfw"):
            t.mul_(GAIN_SCALE).add_(1.0)
        elif name in ("attprojw", "fcprojw"):
            t.mul_(1.0 / math.sqrt(2.0 * s.num_layers))
        out[name] = t
    return out


def tokens(s, batch: int, seq: int, seed: int, i: int, device):
    """(inputs, targets): batch rows of seq + 1 uniform token ids, shifted."""
    g = generator(seed, 1000 + i, device)
    t = torch.randint(0, s.vocab_size, (batch, seq + 1), generator=g,
                      device=device)
    return t[:, :-1], t[:, 1:]


def images(s, batch: int, seed: int, i: int, device):
    """(uint8 images (B, H, W, C), int64 labels (B,))."""
    g = generator(seed, 1000 + i, device)
    x = torch.randint(0, 256, (batch, s.img_size, s.img_size, s.in_chans),
                      generator=g, device=device, dtype=torch.uint8)
    y = torch.randint(0, s.num_classes, (batch,), generator=g, device=device)
    return x, y
