"""Device mesh and sharding helpers.

The reference's only distributed strategy is single-node data parallelism
(PyTorch-Lightning DDP over NCCL, sl_pipeline.py:163-165).  The JAX
equivalent: a 1-D ``data`` mesh over the cards, batches sharded along it,
parameters replicated, gradients/metrics mean-reduced by XLA's all-reduce
(NCCL on GPUs) — all emitted automatically by jit from the shardings below.

For the tiny FI-ODE models no tensor/pipeline parallelism is warranted
(SURVEY.md §2.5); the long axes worth sharding are the batch, the h-sample
axis (folded into batch) and the verification grid (verify/ shards cells the
same way).
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "make_mesh", "make_mesh2d", "shard_batch", "replicate", "data_sharding",
]


def make_mesh(n_devices: Optional[int] = None, axis: str = "data") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def make_mesh2d(
    n_img: int, n_cell: int, axes: tuple = ("img", "cell")
) -> Mesh:
    """2-D mesh for certification sweeps: the image batch shards over the
    first axis and the grid-cell axis over the second, so the cards
    partition both long dimensions of the (images x cells) superchunk; the
    only collective is the per-image max over the cell axis.  NVLink joins
    every card to every other, so the mesh follows the algorithm alone."""
    devs = np.asarray(jax.devices()[: n_img * n_cell]).reshape(n_img, n_cell)
    return Mesh(devs, axes)


def data_sharding(mesh: Mesh, ndim: int, axis: str = "data") -> NamedSharding:
    """Shard dim 0 over the data axis, replicate the rest."""
    return NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))


def shard_batch(mesh: Mesh, batch, axis: str = "data"):
    """Shard each array in the pytree along dim 0 over ``axis``.

    Arrays are the GLOBAL logical batch.  Single-process: one device_put.
    Multi-host (``jax.process_count() > 1`` after
    parallel.multihost.bootstrap_multihost): every process holds the same
    replicated global batch (deterministic input pipeline — see
    multihost.py) and contributes its own rows via
    ``jax.make_array_from_process_local_data``, yielding one global jax
    Array per leaf exactly as jit expects."""
    if jax.process_count() == 1:
        return jax.tree_util.tree_map(
            lambda a: jax.device_put(a, data_sharding(mesh, a.ndim, axis)),
            batch,
        )
    from .multihost import process_rows

    def put(a):
        sh = data_sharding(mesh, a.ndim, axis)
        local = np.asarray(a)[process_rows(a.shape[0])]
        return jax.make_array_from_process_local_data(sh, local, a.shape)

    return jax.tree_util.tree_map(put, batch)


def replicate(mesh: Mesh, tree):
    sh = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, sh), tree)
