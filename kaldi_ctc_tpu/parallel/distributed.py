"""Multi-host SPMD runtime glue.

Replaces the reference's run.pl/queue.pl job-scheduler "distributed
runtime" (utils/run.pl:7-29, steps/ctc/train.sh:386-446): one SPMD program
launched once per host via ``jax.distributed``, with data sharded per host
and gradients reduced across devices by XLA (NCCL on GPUs, Gloo on CPU).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, TypeVar

import jax

__all__ = ["init_distributed", "host_shard", "is_primary", "process_count",
           "process_index"]

T = TypeVar("T")


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed from args or env.

    No-op in single-process runs (the common local case).  Otherwise the
    coordinator address, process count and process id come from the
    arguments or from COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID
    (set by ``cli/launch.py``); nothing auto-detects a cluster.
    """
    explicit = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if explicit is None and num_processes is None and \
            "JAX_COORDINATOR_ADDRESS" not in os.environ:
        return  # single process
    from jax._src import xla_bridge
    if xla_bridge.backends_are_initialized():
        return  # too late to initialize (interactive/test session)
    if num_processes is None and "NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None and "PROCESS_ID" in os.environ:
        process_id = int(os.environ["PROCESS_ID"])
    jax.distributed.initialize(
        coordinator_address=coordinator_address or explicit,
        num_processes=num_processes,
        process_id=process_id,
    )


def process_index() -> int:
    return jax.process_index()


def process_count() -> int:
    return jax.process_count()


def is_primary() -> bool:
    return jax.process_index() == 0


def host_shard(items: Sequence[T]) -> List[T]:
    """This host's shard of a global list (per-host data loading; the
    analogue of per-job egs archives in train.sh:408-419)."""
    n, i = jax.process_count(), jax.process_index()
    return list(items[i::n])
