"""Multi-host directory mode: static task partitioning (a copy of
``partition_tasks`` from ``rife_tpu/parallel/sharding.py``, whose module
imports jax).  ``ShardedRIFE`` (``-g all``) is not ported."""

from __future__ import annotations

from typing import Sequence


def partition_tasks(tasks: Sequence, rank: int, world: int):
    """Static file-range partitioning for multi-host directory mode
    (SURVEY.md §5: hosts never need to communicate — outputs are
    independently named files)."""
    if world <= 1:
        return list(tasks)
    return [t for i, t in enumerate(tasks) if i % world == rank]
