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


def init_distributed(device: torch.device, *, retries: int | None = None,
                     timeout_s: float | None = None, backoff_s: float | None = None,
                     **kwargs) -> None:
    """Join the process group named by the environment (no-op if joined).

    The backend follows the device: NCCL for CUDA, gloo for the CPU.
    ``kwargs`` pass through to `torch.distributed.init_process_group`.

    Bring-up is guarded, as in the JAX package: a failed join is retried
    with exponential backoff and seeded jitter under an overall deadline
    (`utils.resilience.retry_call`), and a watchdog dumps every thread's
    stack if an attempt hangs past it.  Knobs resolve kwarg > env >
    default: ``retries`` / ``IGG_INIT_RETRIES`` (3), ``timeout_s`` /
    ``IGG_INIT_TIMEOUT_S`` (600), ``backoff_s`` / ``IGG_INIT_BACKOFF_S``
    (1); ``IGG_WATCHDOG_S`` overrides the watchdog (0 = off).
    ``IGG_FAULT_INJECT=init_flake:N`` fails the first N attempts.
    """
    from ..utils import config as _config
    from ..utils import resilience as _resilience

    global _owns_runtime
    if is_distributed_initialized():
        return
    if retries is None:
        retries = _config.init_retries_env()
        retries = _resilience.DEFAULT_INIT_RETRIES if retries is None else retries
    if timeout_s is None:
        timeout_s = _config.init_timeout_env()
        timeout_s = _resilience.DEFAULT_INIT_TIMEOUT_S if timeout_s is None else timeout_s
    if backoff_s is None:
        backoff_s = _config.init_backoff_env()
        backoff_s = _resilience.DEFAULT_INIT_BACKOFF_S if backoff_s is None else backoff_s
    if retries < 0:
        raise ValueError(f"retries must be >= 0 (got {retries})")
    if timeout_s <= 0:
        raise ValueError(f"timeout_s must be > 0 (got {timeout_s})")
    backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs.setdefault("init_method", "env://")
    if device.type == "cuda":
        torch.cuda.set_device(device)  # NCCL binds to the current device
    rank = int(os.environ["RANK"])
    # Retry and fault events fired before the group is up carry this rank.
    from ..utils import telemetry as _telemetry

    _telemetry.set_rank_hint(rank)
    injector = _resilience.get_fault_injector()

    def attempt():
        injector.maybe_flake_init()
        try:
            dist.init_process_group(
                backend, rank=rank, world_size=int(os.environ["WORLD_SIZE"]), **kwargs
            )
        except BaseException:
            # A half-joined group must not poison the next attempt.
            if is_distributed_initialized():
                dist.destroy_process_group()
            raise

    wd_env = _config.watchdog_env()
    with _resilience.watchdog(timeout_s if wd_env is None else wd_env):
        _resilience.retry_call(
            attempt, retries=retries, timeout_s=timeout_s, base_backoff_s=backoff_s,
            seed=rank, describe="torch.distributed.init_process_group",
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


def sync_all_processes(device: torch.device | None = None) -> None:
    """Host-level barrier across all processes (no-op for one process).

    Under NCCL the barrier runs on the rank's device: ``device`` (default
    the current CUDA device) goes in as ``device_ids``; gloo needs none.
    """
    if process_count() <= 1:
        return
    if dist.get_backend() == "nccl":
        index = torch.cuda.current_device() if device is None else device.index
        dist.barrier(device_ids=[index])
    else:
        dist.barrier()
