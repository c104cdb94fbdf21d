"""vitrs_tpu_torch — the PyTorch / CUDA port of vitrs_tpu for NVIDIA Hopper.

It sits beside the JAX package, which stays the reference: modules mirror
their JAX counterparts by name, parameters keep the JAX layout (the 16
canonical tensors, stacked on a leading L axis, matmul weights (OC, C)), and
every Pallas kernel on a ported path becomes a hand-written CUDA kernel under
csrc/, built with nvcc at first use.  This package imports torch and never
jax.

Ported so far: the GPT serving path (config, params, checkpoint, ops,
models/model.py, models/generate.py, serving_gen.py, the tokenizer,
cli/generate.py) and the single-device GPT training step (the ops'
backwards, ops/fused_qkv_attention.py, ops/fused_ce.py, ops/optimizer.py,
parallel/data_parallel.py at world size 1, train/loop.py, cli/train.py,
the vit.py five-call API), with five kernels: the flash-attention forward
(csrc/flash_fwd.cu) and backward (csrc/flash_bwd.cu), the fused
cross-entropy forward and backward (csrc/fused_ce.cu) and the fused AdamW
(csrc/fused_adamw.cu).  Later slices added grouped-query attention,
chunked prefill, rope and the sliding window, the fused head + CE, vit
mode, and the mixture-of-experts model (ops/moe.py) with the tree
optimizers Adafactor and Muon (ops/adafactor.py, ops/muon.py), which run
on the same kernels; the rest of the training loop and of serving; the
reference-exact path (quirks=True, the bit-exact mode ops/bitexact.py, the
numpy oracles in oracle/) and the model families (models/mae.py,
models/lora.py, models/clip.py, models/import_hf.py, cli/pretrain_mae.py,
cli/finetune.py); then the kernels as `torch.library` ops (`vitrs::*`),
export serving on `torch.export` (serving.py), the NaN guards
(utils/debug.py), and ZeRO-1, FSDP and hybrid FSDP on torch.distributed
(parallel/, train/mesh.py, `--mesh`).
"""

from .config import PRESETS, ViTConfig, get_config
from . import checkpoint, params

__version__ = "0.1.0"


def __getattr__(name):
    # ViT on first use: importing a submodule (serving.ServedModel, say)
    # then loads no model code
    if name == "ViT":
        from .vit import ViT
        return ViT
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
