"""Process-group bring-up for the one-process-per-GPU model.

The reference runs one MPI rank per GPU; the port runs one Python process per
GPU under `torch.distributed` (NCCL between CUDA devices, gloo on the CPU).
Rank, world size and the rendezvous address come from the environment that
``torchrun`` (or a test harness) sets: ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT`` and, for the device binding, ``LOCAL_RANK``.
With ``WORLD_SIZE`` unset the program is one process and no group exists.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

# True while THIS module brought the process group up and it has not been
# destroyed, so `finalize_global_grid` only tears down what it created (the
# reference's guarded ``MPI.Finalize``).
_owns_runtime = False


def owns_runtime() -> bool:
    return _owns_runtime


def env_world_size() -> int | None:
    """``WORLD_SIZE`` from the environment, or None when unset."""
    val = os.environ.get("WORLD_SIZE")
    return None if val in (None, "") else int(val)


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")) or 0)


def is_distributed_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def init_distributed(device: torch.device, **kwargs) -> None:
    """Join the process group named by the environment (no-op if joined).

    The backend follows the device: NCCL for CUDA, gloo for the CPU.
    ``kwargs`` pass through to `torch.distributed.init_process_group`.
    """
    global _owns_runtime
    if is_distributed_initialized():
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs.setdefault("init_method", "env://")
    if device.type == "cuda":
        torch.cuda.set_device(device)  # NCCL binds to the current device
    dist.init_process_group(
        backend,
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
        **kwargs,
    )
    _owns_runtime = True


def shutdown_distributed() -> None:
    global _owns_runtime
    if is_distributed_initialized():
        dist.destroy_process_group()
    _owns_runtime = False


def process_index() -> int:
    return dist.get_rank() if is_distributed_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_distributed_initialized() else 1


def sync_all_processes() -> None:
    """Host-level barrier across all processes (no-op for one process)."""
    if process_count() > 1:
        dist.barrier()
