"""Spectral-norm estimation by power iteration (dense and convolutional).

JAX rebuild of the reference's Lipschitz tracking
(FI-ODE utils.py:151-234): per-layer sigma_max estimates with warm-started
singular vectors, multiplied through the backbone to obtain L_{f,x} for
Lipschitz-aware kappa scheduling (pl_modules.py:437-445).

The singular vector is carried functionally (no buffers): each call returns
``(sigma, u_new)`` and the training state threads ``u`` between steps.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp

__all__ = ["power_iteration_dense", "power_iteration_conv", "conv_sigma_max"]

_EPS = 1e-12


def _normalize(v):
    return v / (jnp.linalg.norm(v) + _EPS)


def power_iteration_dense(
    A: jax.Array, u: jax.Array | None = None, num_iter: int = 1
) -> Tuple[jax.Array, jax.Array]:
    """Estimate sigma_max(A) for a (m, n) matrix.

    Args:
      A: (m, n) matrix.
      u: (m,) warm-start left singular vector (random normal if None).
      num_iter: fixed number of iterations (static, jit-friendly).

    Returns:
      (sigma_estimate, u_new)
    """
    if u is None:
        u = jax.random.normal(jax.random.PRNGKey(0), (A.shape[0],), A.dtype)

    def body(_, u):
        v = _normalize(A.T @ u)
        u = _normalize(A @ v)
        return u

    u = jax.lax.fori_loop(0, num_iter, body, _normalize(u))
    v = _normalize(A.T @ u)
    sigma = u @ (A @ v)
    return sigma, u


def power_iteration_conv(
    weight: jax.Array,
    input_shape: Sequence[int],
    u: jax.Array | None = None,
    num_iter: int = 1,
    stride: int = 1,
    padding: int = 0,
) -> Tuple[jax.Array, jax.Array]:
    """Estimate sigma_max of a conv2d layer as a linear operator.

    Args:
      weight: (co, ci, kh, kw) kernel (NCHW/OIHW convention).
      input_shape: (ci, h, w) of a single example.
      u: warm-start input-side singular vector of shape (1, ci, h, w).
      num_iter: fixed iteration count.
      stride/padding: conv hyperparameters.

    Returns:
      (sigma_estimate, u_new) — u lives on the *input* side, mirroring the
      reference's conv/conv-transpose ping-pong (utils.py:174-204).
    """
    ci, h, w = input_shape
    if u is None:
        u = jax.random.normal(jax.random.PRNGKey(0), (1, ci, h, w), weight.dtype)

    dn = jax.lax.conv_dimension_numbers(
        (1, ci, h, w), weight.shape, ("NCHW", "OIHW", "NCHW")
    )
    pads = [(padding, padding), (padding, padding)]

    def fwd(x):
        return jax.lax.conv_general_dilated(
            x, weight, (stride, stride), pads, dimension_numbers=dn
        )

    # transpose operator via VJP (exact adjoint incl. stride/padding)
    _, vjp = jax.vjp(fwd, u)

    def body(_, u):
        v = _normalize(fwd(u))
        (ut,) = vjp(v)
        return _normalize(ut)

    u = jax.lax.fori_loop(0, num_iter, body, _normalize(u))
    v = _normalize(fwd(u))
    sigma = jnp.vdot(v, fwd(u))
    return sigma, u


def conv_sigma_max(weight, input_shape, stride=1, padding=0, num_iter=50):
    """Convenience: converged sigma_max of a conv layer (testing/certification)."""
    sigma, _ = power_iteration_conv(
        weight, input_shape, num_iter=num_iter, stride=stride, padding=padding
    )
    return sigma
