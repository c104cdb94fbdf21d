"""A copy of the benchmark's data at tiny sizes, for runs on the CPU: the
same cells and metrics, each configuration a tiny preset of the same
family (gpt-nano; vit-tiny-4-cifar10 cut to 2 layers, with ViT-B/16's
exact GELU), each traffic mix
scaled down."""

from __future__ import annotations

import json
import os
import shutil

from portbench import spec as SP

TINY_CONFIGS = {
    "gpt2-124m": {
        "preset": "gpt-nano", "dtype": "float32", "overrides": {},
        "shape": {"mode": "gpt", "num_layers": 2, "channels": 16,
                  "num_heads": 2, "max_seq_len": 16, "vocab_size": 97,
                  "mlp_ratio": 4, "act": "gelu_tanh", "ln_eps": 1e-05}},
    "vit-b-16": {
        "preset": "vit-tiny-4-cifar10", "dtype": "float32",
        "overrides": {"num_layers": 2, "act": "gelu_erf"},
        "shape": {"mode": "vit", "num_layers": 2, "channels": 192,
                  "num_heads": 3, "max_seq_len": 65, "mlp_ratio": 4,
                  "act": "gelu_erf", "ln_eps": 1e-05, "img_size": 32,
                  "patch_size": 4, "in_chans": 3, "num_classes": 10}},
}

TINY_PARAMS = {
    "gpt2-124m.train": {"batch": 4, "ref_block": 2},
    "vit-b-16.train": {"batch": 4, "ref_block": 2},
    "gpt2-124m.prefill": {"rate": 40.0, "slots": 4, "max_len": 16,
                          "buckets": [8, 16], "median_prompt": 8,
                          "min_prompt": 2, "max_prompt": 15,
                          "check_requests": 6, "drain_s": 30},
    "vit-b-16.infer": {"batch": 4, "check_batches": 2, "ref_block": 2},
}


def write(obj, path):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def tiny_spec(tmp) -> SP.Spec:
    """A Spec over a copy of the data under tmp, cut to tiny sizes."""
    root = os.path.join(str(tmp), "portbench")
    os.makedirs(root, exist_ok=True)
    for folder in ("configs", "workloads", "metrics"):
        shutil.copytree(os.path.join(SP.ROOT, folder),
                        os.path.join(root, folder), dirs_exist_ok=True)
    shutil.copy(os.path.join(SP.ROOT, "suite.json"), root)
    spec = SP.Spec(root)
    for name, tiny in TINY_CONFIGS.items():
        conf = spec.config(name)
        conf.update(tiny)
        write(conf, os.path.join(root, "configs", name + ".json"))
    for name, params in TINY_PARAMS.items():
        wl = spec.workload(name)
        wl["params"].update(params)
        write(wl, os.path.join(root, "workloads", name + ".json"))
    return spec
