"""Multi-process setup: the port of `vitrs_tpu/parallel/multihost.py` on
`torch.distributed`.

The JAX program runs unchanged across hosts once `jax.distributed` is up;
here every rank is a process with one process group.  Each rank feeds its
stride of the global batch (the loaders' `host_id, num_hosts`) and rank 0
writes checkpoints and logs.

The backend is always explicit: NCCL for CUDA devices, gloo for the CPU,
unless the caller names one.  NCCL never falls back to gloo: a failed
bring-up raises.  Several ranks may share one card only over gloo, and only
when the caller asks for it (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               backend: Optional[str] = None, device: str = "cuda",
               timeout: float = DEFAULT_TIMEOUT_S) -> bool:
    """Idempotent process-group bring-up; returns whether a group is up.

    With no arguments it reads a launcher's environment (torchrun's
    WORLD_SIZE / RANK / MASTER_ADDR / MASTER_PORT, `env://`); with none
    there and nothing described it does nothing: a one-process run.  A
    cluster the caller describes (an `init_method` such as
    `tcp://host:port` or `file:///path`, a world size, a rank) that cannot
    be reached raises within `timeout` seconds.  `backend` defaults to
    "nccl" for a CUDA `device` and "gloo" for the CPU."""
    if dist.is_initialized():
        return True
    explicit = (init_method is not None or world_size is not None
                or rank is not None)
    if not explicit and "WORLD_SIZE" not in os.environ:
        return False
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(
        backend=backend, init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank,
        timeout=datetime.timedelta(seconds=timeout))
    return True


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def host_info() -> dict:
    return {
        "process_id": rank(),
        "num_processes": world_size(),
        "local_devices": torch.cuda.device_count(),
        "global_devices": world_size(),
        "backend": dist.get_backend() if dist.is_initialized() else None,
    }


def is_primary() -> bool:
    """True on the process that writes checkpoints and logs."""
    return rank() == 0


def local_cuda_device(name: str = "cuda") -> torch.device:
    """The CUDA device a rank runs on: `name` as given when it names an
    index ("cuda:0": ranks sharing a card, on purpose), else cuda:LOCAL_RANK
    under a launcher (cuda:0 without one).  Raises when that device does not
    exist, so that ranks never share a card silently."""
    dev = torch.device(name)
    if dev.index is not None:
        index = dev.index
    else:
        index = int(os.environ.get("LOCAL_RANK", rank() if
                                   dist.is_initialized() else 0))
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"rank {rank()} wants cuda:{index}, torch sees "
                           f"{torch.cuda.device_count()} CUDA device(s): "
                           f"name one (e.g. cuda:0) to share a card")
    return torch.device("cuda", index)
