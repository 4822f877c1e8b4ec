"""Multi-host initialization helpers.

The reference has no distributed story whatsoever (SURVEY.md section 2.9).
For several hosts the framework follows standard single-controller JAX:
each host calls :func:`initialize` once before any jax usage, then
builds a GLOBAL mesh over all hosts' devices; XLA inserts the
collectives from the shardings (NCCL on GPUs), no comm code of ours.
"""

from __future__ import annotations

import jax

from .mesh import make_mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Wrapper over ``jax.distributed.initialize``; no-ops on single-host.

    Pass the arguments explicitly (coordinator ``host:port``, process
    count and id), or set ``JAX_COORDINATOR_ADDRESS`` for JAX to read.
    """
    import os

    if num_processes is not None and num_processes <= 1:
        return
    if num_processes is None and coordinator_address is None and not any(
            os.environ.get(k) for k in
            ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS")):
        # nothing to auto-detect from: a plain single host.  Without this
        # check jax.distributed.initialize raises instead of no-opping.
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(data: int = 1, row: int | None = None, col: int = 1):
    """Build a global (data, row, col) mesh over ALL processes' devices.

    Defaults shard the remaining factor over ``row``: the cards of one
    host reach each other at one rate, so the split follows the
    algorithm.
    """
    n = jax.device_count()
    if row is None:
        if n % (data * col):
            raise ValueError(f"{n} devices not divisible by data*col = {data * col}")
        row = n // (data * col)
    return make_mesh({"data": data, "row": row, "col": col})


def process_local_batch(global_batch: int) -> int:
    """Per-process share of a globally-sharded batch dimension."""
    if global_batch % jax.process_count():
        raise ValueError(
            f"global batch {global_batch} not divisible by "
            f"{jax.process_count()} processes")
    return global_batch // jax.process_count()
