"""Process-group initialization for tensor and data parallelism.

The counterpart of ``tmac_tpu/parallel/launch.py``: JAX stitches the
hosts' devices into one program with ``jax.distributed.initialize()``;
here every rank is a process driving one device, and
``torch.distributed.init_process_group`` joins them.  Nothing is probed:
the caller names the backend and the rank's device.

    "nccl"  one CUDA card a rank (the multi-card case; untested here: the
            repository's card machine has one H100);
    "gloo"  CPU ranks (the tests), or several ranks on one card (gloo's
            all_reduce and broadcast take CUDA tensors: two ranks on the
            one H100 run every kernel at its shard's shapes, which NCCL
            refuses, as it takes one rank a device).

The rendezvous is a shared file (``init_method="file:///path"``) or
``tcp://host:port``, given as an argument or in ``TMAC_INIT_METHOD``; the
world size and rank likewise, or in ``WORLD_SIZE`` and ``RANK`` (JAX's
``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``).
A world of one rank, none of them given, initializes nothing, as JAX's
single-host no-op.

    from tmac_tpu_torch.parallel import launch, tp
    info = launch.init("nccl", torch.device("cuda", local_rank))
    mesh = tp.make_mesh(tp=2, dp=info["process_count"] // 2)
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")

_device: Optional[torch.device] = None


def init(backend: str, device, init_method: Optional[str] = None,
         world_size: Optional[int] = None, rank: Optional[int] = None) -> dict:
    """Join this process to the group of ranks; -> JAX's dict
    (process_index, process_count, local_devices, global_devices).  device:
    this rank's device (a CUDA device must exist: a rank that finds none
    raises; nccl takes CUDA devices only).  A second call in one process
    raises, as torch's does."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank's device {device} but no CUDA device is present")
        torch.cuda.set_device(device)
    elif backend == "nccl":
        raise ValueError(f"nccl takes CUDA devices, not {device}")
    init_method = init_method or os.environ.get("TMAC_INIT_METHOD")
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    global _device
    _device = device
    if init_method is None and world_size in (None, 1):
        return _info()
    if init_method is None or world_size is None or rank is None:
        raise ValueError("a world of several ranks needs init_method, world_size and rank "
                         "(or TMAC_INIT_METHOD, WORLD_SIZE and RANK)")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)
    return _info()


def _info() -> dict:
    up = dist.is_initialized()
    n = dist.get_world_size() if up else 1
    return {"process_index": dist.get_rank() if up else 0, "process_count": n,
            "local_devices": 1, "global_devices": n}


def device() -> torch.device:
    """This rank's device, as init named it."""
    if _device is None:
        raise RuntimeError("launch.init has not run in this process")
    return _device


def shutdown() -> None:
    """Leave the group (the ranks' last call)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def scaling_efficiency(tokens_per_s: float, baseline_tokens_per_s: float,
                       n_chips: int, baseline_chips: int = 1) -> float:
    """Throughput scaling efficiency against a smaller configuration: 1.0
    is linear."""
    return (tokens_per_s / baseline_tokens_per_s) / (n_chips / baseline_chips)
