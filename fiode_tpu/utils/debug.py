"""Debug & profiling toggles (SURVEY.md §5.1-5.2 aux subsystems).

The reference ships disabled torch anomaly/profiler hooks
(sl_pipeline.py:32-39).  The JAX-native equivalents:
  * ``set_debug(nans=True)``   — jax_debug_nans / jax_debug_infs;
  * ``set_debug(checks=True)`` — strict shard/rank checking
    (jax_numpy_rank_promotion='raise');
  * ``trace(dir)``             — jax.profiler trace context manager for
    TensorBoard-viewable device profiles;
  * ``step_timer``             — lightweight host-side section timer.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import jax

__all__ = ["set_debug", "trace", "step_timer", "env_flag"]


def env_flag(name: str) -> bool:
    """Shared truthy-env-var parser for feature gates (FIODE_QP_UNROLL,
    ...) so the accepted spellings cannot drift."""
    return os.environ.get(name, "").lower() in ("1", "true", "yes")


def set_debug(nans: bool = False, infs: bool = False, checks: bool = False):
    jax.config.update("jax_debug_nans", nans)
    jax.config.update("jax_debug_infs", infs)
    jax.config.update(
        "jax_numpy_rank_promotion", "raise" if checks else "allow"
    )


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Device profile trace: view with TensorBoard's profile plugin."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def step_timer(name: str, sink=None) -> Iterator[None]:
    t0 = time.time()
    try:
        yield
    finally:
        dt = time.time() - t0
        msg = f"[timer] {name}: {dt*1000:.1f}ms"
        if sink is None:
            print(msg, flush=True)
        else:
            sink(name, dt)
