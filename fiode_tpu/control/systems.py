"""Segway (wheeled inverted pendulum) dynamics — the control workload plant.

Capability rebuild of the `libs/core` submodule surface the reference uses
(SURVEY.md §2.3: core.systems.Segway, system.jacobian, system.simulate;
control/train_segway.py:29-43, certify_segway.py:103-139).  The submodule is
an empty stub in the reference checkout, so the plant here is a standard
3-state wheeled-inverted-pendulum derived from first principles with
representative parameters (documented below), exposing the same API:

  state x = (phi, v, phi_dot):  tilt angle, forward velocity, tilt rate
  input u: wheel torque
  dynamics: M(phi) [v_dot, phi_ddot]^T = rhs(x, u) with the 2x2 mass matrix
      M = [[m_t,        m l cos(phi)],
           [m l cos(phi), I + m l^2 ]]
      rhs = [u / r + m l phi_dot^2 sin(phi) - c_v v,
             m g l sin(phi) - u - c_p phi_dot]
  solved in closed form (2x2 inverse), fully differentiable; `jacobian` via
  jax.jacfwd; `simulate` integrates the closed loop with the fiode_tpu ODE
  stack; `dynamics_interval` propagates interval bounds for certification.
"""
from __future__ import annotations

import dataclasses
import jax
import jax.numpy as jnp

from ..ode.integrate import odeint
from ..verify.interval import IV

__all__ = ["Segway"]


@dataclasses.dataclass(frozen=True)
class Segway:
    m: float = 5.0  # pendulum (body) mass [kg]
    m_w: float = 2.0  # wheel + chassis translational mass [kg]
    l: float = 0.5  # COM height [m]
    r: float = 0.2  # wheel radius [m]
    g: float = 9.81
    I_p: float = 0.45  # body inertia about the wheel axis [kg m^2]
    c_v: float = 1.0  # translational damping
    c_p: float = 0.1  # rotational damping

    @property
    def m_t(self):
        return self.m + self.m_w

    # -- open-loop dynamics --------------------------------------------------

    def __call__(self, x, u, t=0.0):
        """f(x, u): batched (N,3), (N,1) -> (N,3)."""
        phi, v, phi_dot = x[..., 0], x[..., 1], x[..., 2]
        tau = u[..., 0]
        s, c = jnp.sin(phi), jnp.cos(phi)
        a = self.m_t
        b = self.m * self.l * c
        d = self.I_p + self.m * self.l**2
        det = a * d - b * b  # > 0 for all phi (a d > (m l)^2)
        r1 = tau / self.r + self.m * self.l * phi_dot**2 * s - self.c_v * v
        r2 = self.m * self.g * self.l * s - tau - self.c_p * phi_dot
        v_dot = (d * r1 - b * r2) / det
        phi_ddot = (-b * r1 + a * r2) / det
        return jnp.stack([phi_dot, v_dot, phi_ddot], axis=-1)

    def jacobian(self, x, u, t=0.0):
        """(A, B) batched linearisation at (x, u) — LQR design input
        (reference train_segway.py:35)."""
        A = jax.vmap(jax.jacfwd(lambda xx, uu: self(xx[None], uu[None])[0]))(
            x, u
        )
        B = jax.vmap(
            jax.jacfwd(
                lambda uu, xx: self(xx[None], uu[None])[0], argnums=0
            )
        )(u, x)
        return A, B

    # -- closed-loop simulation ----------------------------------------------

    def simulate(self, x0, controller, ts, method="dopri5", rtol=1e-6,
                 atol=1e-6, mode="while", max_steps=100_000):
        """Integrate the closed loop from a batch of starts.

        Returns (xs (T, N, 3), us (T, N, 1)) like the reference's
        system.simulate (certify_segway.py:109).  mode/max_steps are
        exposed because the right trade-off is platform-dependent: 'while'
        stops at the ~5k steps this solve actually needs but pays a
        device->host round trip per predicate; 'scan' (with a tight
        max_steps) runs a fixed trip count on-device."""
        def f(t, x, _):
            return self(x, controller(x, t))

        sol = odeint(
            f, jnp.asarray(x0), jnp.asarray(ts), method=method, rtol=rtol,
            atol=atol, max_steps=max_steps, mode=mode,
        )
        xs = sol.ys
        us = jax.vmap(lambda x: controller(x, 0.0))(xs)
        return xs, us

    # -- interval bounds for certification ------------------------------------

    def dynamics_interval(self, x_iv: IV, u_iv: IV) -> IV:
        """Sound interval enclosure of f over box states and torque bounds.

        x_iv: IV with arrays (..., 3); u_iv: IV with arrays (..., 1).
        Returns IV over (..., 3)."""
        phi = IV(x_iv.lo[..., 0], x_iv.hi[..., 0])
        v = IV(x_iv.lo[..., 1], x_iv.hi[..., 1])
        phi_dot = IV(x_iv.lo[..., 2], x_iv.hi[..., 2])
        tau = IV(u_iv.lo[..., 0], u_iv.hi[..., 0])
        s, c = phi.sin(), phi.cos()
        a = self.m_t
        b = c * (self.m * self.l)
        d = self.I_p + self.m * self.l**2
        det = (b * b) * (-1.0) + a * d  # a*d - b^2 > 0
        r1 = tau * (1.0 / self.r) + (phi_dot.square() * s) * (self.m * self.l) - v * self.c_v
        r2 = s * (self.m * self.g * self.l) - tau - phi_dot * self.c_p
        v_dot = (r1 * d - b * r2) / det
        phi_ddot = (r2 * a - b * r1) / det
        lo = jnp.stack([phi_dot.lo, v_dot.lo, phi_ddot.lo], axis=-1)
        hi = jnp.stack([phi_dot.hi, v_dot.hi, phi_ddot.hi], axis=-1)
        return IV(lo, hi)
