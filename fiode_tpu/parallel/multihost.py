"""Multi-host (multi-process) bootstrap for SPMD runs.

The reference's distributed story is single-node DDP (NCCL over one
machine's GPUs, sl_pipeline.py:163-165).  The JAX equivalent spans hosts:
every process owns a subset of the global devices, runs the SAME program,
and XLA's collectives (NCCL on GPUs) cross processes and hosts.  JAX needs
exactly two things from the framework for that:

1. ``jax.distributed.initialize()`` before any other JAX call, so
   ``jax.devices()`` enumerates the GLOBAL device set (every mesh built by
   ``parallel.mesh.make_mesh`` is then automatically global — the trainer
   code does not change);
2. global arrays assembled from per-process local data
   (``jax.make_array_from_process_local_data``) instead of plain
   ``device_put`` — see ``mesh.shard_batch``'s multihost path.

The input pipeline stays deterministic-replicated: every process composes
the same config, loads/synthesizes the same dataset, and draws the same
shuffle permutations (seeded numpy), so "my rows of the global batch" is a
pure index slice — no cross-process data exchange (the pattern of the
scaling-book's data-parallel recipe).

CLI: ``python -m fiode_tpu train --multihost ...`` on every process, with
the coordinator given explicitly: set ``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``.  A 2-process CPU cluster is
exercised end-to-end by tests/test_multihost.py.
"""
from __future__ import annotations

import os
from typing import Optional

__all__ = ["bootstrap_multihost", "process_rows", "is_multihost"]


def bootstrap_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
) -> tuple:
    """Initialize the JAX distributed runtime; returns (index, count).

    Must run before any other JAX API touches a backend.  With no
    arguments the cluster shape comes from JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID (the standard JAX variables).
    Calling it in a single-process setting (no env, no args) is a no-op
    returning (0, 1) so ``--multihost`` scripts stay runnable standalone.
    """
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID") is not None:
        process_id = int(os.environ["JAX_PROCESS_ID"])

    if coordinator_address:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
        )
    return jax.process_index(), jax.process_count()


def is_multihost() -> bool:
    import jax

    return jax.process_count() > 1


def process_rows(n_rows: int, axis_size: Optional[int] = None) -> slice:
    """This process's contiguous row slice of a length-``n_rows`` global
    batch, under the deterministic-replicated input pipeline (module
    docstring): every process sees the same global batch order and keeps
    rows [i * n/p, (i+1) * n/p).  ``n_rows`` must divide evenly (sharded
    dims must, anyway)."""
    import jax

    p = jax.process_count() if axis_size is None else axis_size
    i = jax.process_index()
    if n_rows % p:
        raise ValueError(f"global batch {n_rows} not divisible by {p} processes")
    per = n_rows // p
    return slice(i * per, (i + 1) * per)
