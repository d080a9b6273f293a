"""Controllers: constant, linear (LQR), and neural-network (ReLU MLP).

Capability rebuild of core.controllers.{ConstantController, LinearController,
LQRController, NNController} used by the reference
(control/train_segway.py:4-8,43-49).  LQR design solves the continuous
algebraic Riccati equation on the host with scipy (train_segway.py:37) —
CPU-side, exactly as the reference does.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..models.layers import Module

__all__ = [
    "ConstantController",
    "LinearController",
    "lqr_gain",
    "NNControllerModule",
    "NNController",
]


@dataclasses.dataclass
class ConstantController:
    value: float = 0.0

    def __call__(self, x, t=0.0):
        return jnp.full(x.shape[:-1] + (1,), self.value, x.dtype)


@dataclasses.dataclass
class LinearController:
    """u = -K x (the LQR feedback convention)."""

    K: np.ndarray  # (1, n)

    def __call__(self, x, t=0.0):
        return -(x @ jnp.asarray(self.K).T)


def lqr_gain(system, goal, Q, R):
    """Continuous LQR about ``goal`` with scipy's CARE solver
    (train_segway.py:35-43).  Returns (K, P)."""
    from scipy.linalg import solve_continuous_are

    goal = jnp.asarray(goal).reshape(1, -1)
    u0 = jnp.zeros((1, 1))
    A, B = system.jacobian(goal, u0)
    A = np.asarray(A[0], np.float64)
    B = np.asarray(B[0], np.float64)
    P = solve_continuous_are(A, B, np.asarray(Q, np.float64),
                             np.asarray(R, np.float64))
    K = np.linalg.inv(np.asarray(R, np.float64)) @ B.T @ P
    return K.astype(np.float32), P.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class NNControllerModule(Module):
    """ReLU MLP controller n_in -> hidden -> n_out, layers ``Dense_0`` and
    ``Dense_1`` with (in, out) kernels.

    (The reference's NNController(system, 3, 1, 32); ReLU keeps the
    certification path inside the ReLU-CROWN relaxation.)"""

    n_out: int = 1
    hidden: int = 32

    def init_at(self, keys, x):
        init = jax.nn.initializers.lecun_normal()
        p = {}
        for name, (n_in, n_out) in (("Dense_0", (x.shape[-1], self.hidden)),
                                    ("Dense_1", (self.hidden, self.n_out))):
            k = keys.child(name)
            p[name] = {"kernel": init(k(1), (n_in, n_out)),
                       "bias": jnp.zeros((n_out,))}
        return p

    def apply(self, params, x):
        d0, d1 = params["Dense_0"], params["Dense_1"]
        x = jax.nn.relu(x @ d0["kernel"] + d0["bias"])
        return x @ d1["kernel"] + d1["bias"]


@dataclasses.dataclass
class NNController:
    module: NNControllerModule
    params: dict

    @classmethod
    def create(cls, rng, n_in=3, n_out=1, hidden=32):
        module = NNControllerModule(n_out=n_out, hidden=hidden)
        params = module.init(rng, jnp.zeros((1, n_in)))
        return cls(module, params)

    def __call__(self, x, t=0.0):
        return self.module.apply(self.params, x)

    def dense_weights(self):
        """[(W1,b1),(W2,b2)] row-major (out,in) for CROWN."""
        p = self.params
        return (
            [p["Dense_0"]["kernel"].T, p["Dense_1"]["kernel"].T],
            [p["Dense_0"]["bias"], p["Dense_1"]["bias"]],
        )
