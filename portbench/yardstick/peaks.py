"""The chip's published peaks, by device name.

NVIDIA H100 SXM data sheet, dense rates without sparsity, at the 700 W
limit: 989 TFLOP/s in bf16 and fp16, 67 TFLOP/s in fp32 outside the tensor
cores, 3.35 TB/s of HBM3.  A device name no entry matches raises: no share
of a peak is claimed for a card whose peak is not written here.
"""

from __future__ import annotations

PEAKS = {
    # last word of the key, matched in the lower-cased device name
    "nvidia h100": {"flops": {"bfloat16": 989e12, "float16": 989e12,
                              "float32": 67e12},
                    "bytes_per_s": 3.35e12},
}


def peaks_for(device_name: str) -> dict:
    kind = device_name.lower()
    for key, tbl in PEAKS.items():
        if key.split()[-1] in kind:
            return tbl
    raise ValueError(f"no peaks known for device {device_name!r}; add them "
                     f"to PEAKS with their source")


def peak_flops(device_name: str, dtype: str) -> float:
    return peaks_for(device_name)["flops"][dtype]


def peak_bytes_per_s(device_name: str) -> float:
    return peaks_for(device_name)["bytes_per_s"]
