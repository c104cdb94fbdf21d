"""vitrs_tpu_torch — the PyTorch / CUDA port of vitrs_tpu for NVIDIA Hopper.

It sits beside the JAX package, which stays the reference: modules mirror
their JAX counterparts by name, parameters keep the JAX layout (the 16
canonical tensors, stacked on a leading L axis, matmul weights (OC, C)), and
every Pallas kernel on a ported path becomes a hand-written CUDA kernel under
csrc/, built with nvcc at first use.  This package imports torch and never
jax.

Ported so far: the GPT serving path (config, params, checkpoint, ops,
models/model.py forward, models/generate.py, serving_gen.py, the tokenizer,
the vit.py inference API, cli/generate.py) and its one kernel, the
flash-attention forward (csrc/flash_fwd.cu).
"""

from .config import PRESETS, ViTConfig, get_config
from .vit import ViT
from . import checkpoint, params

__version__ = "0.1.0"
