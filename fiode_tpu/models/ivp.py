"""Neural-ODE classifier: init coordinates -> integrate -> output coordinates.

Rebuild of the reference's IVP wrapper (models.py:181-243) plus the
init/output coordinate maps (dynamics/init_coordinates.py:5-44,
dynamics/output_coordinates.py:4-28):

  * init:    static features x_feat = backbone(x); h(0) = 1/n on the simplex
             (UniformInitFun) or zeros (DefaultInitFun).
  * solve:   dh/dt = dynamics.eval_dot(h, x_feat) with the adaptive solver;
             the "static state" is a closure argument, not a module buffer —
             no global state, vmap/pjit-safe by construction.
  * output:  h(t_max) is already the class-probability vector ("default"),
             or a slice ("first_n") / linear readout ("linear").

Gradient paths: mode='while' for inference, mode='scan' for discrete
backprop through solver steps (reference training default), or
use_adjoint=True for the continuous adjoint with input-only cotangents
(the reference's attack-time configuration, models.py:221-235).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from ..ode.adjoint import odeint_adjoint
from ..ode.integrate import OdeSolution, odeint
from ..ops.fused_rhs import (BLOCK, ambient_dot_precision, fused_rhs,
                             pack_rhs_params, pad_width)
from .dynamics import SimplexDynamics, densify_dynamics_params
from .layers import Module

__all__ = ["NeuralODEClassifier"]


@dataclasses.dataclass
class NeuralODEClassifier:
    backbone: Optional[Module]
    dynamics: SimplexDynamics
    n_classes: int
    t_max: float = 1.0
    h0_init: str = "uniform"  # 'uniform' | 'zeros'
    output: str = "default"  # 'default' | 'first_n'
    method: str = "dopri5"
    rtol: float = 1e-3
    atol: float = 1e-3
    max_steps: int = 512

    # -- parameter handling --------------------------------------------------

    def init(self, rng, sample_x) -> dict:
        kb, kd, ko = jax.random.split(rng, 3)
        params = {}
        if self.backbone is not None:
            params["backbone"] = self.backbone.init(kb, sample_x)
            feats = self.features(params, sample_x)
        else:
            feats = sample_x
        h0 = self.h0(sample_x.shape[0])
        params["dynamics"] = self.dynamics.init(kd, h0, feats)
        if self.output == "linear":
            # LinearLastOutput readout (output_coordinates.py:21-28),
            # xavier-uniform, no bias
            params["output"] = {
                "kernel": jax.nn.initializers.xavier_uniform()(
                    ko, (self.n_classes, self.dynamics.n_hidden)
                )
            }
        return params

    # -- coordinate maps -----------------------------------------------------

    def features(self, params, x):
        if self.backbone is None:
            return x
        return self.backbone.apply(params["backbone"], x)

    def h0(self, batch_size: int):
        n = self.dynamics.n_hidden
        if self.h0_init == "uniform":
            h = jnp.full((batch_size, n), 1.0 / n)
        else:
            h = jnp.zeros((batch_size, n))
        return h

    def output_fn(self, h, output_params=None):
        if self.output == "default":
            return h
        if self.output == "first_n":
            return h[..., : self.n_classes]
        if self.output == "linear":
            if output_params is None:
                raise ValueError("output='linear' needs params['output']")
            return h @ output_params["kernel"].T
        raise ValueError(self.output)

    # -- dynamics as a pure RHS ---------------------------------------------

    def eval_dot(self, params, h, x_feat, *, train=False, rng=None,
                 scale_nominal=None):
        return self.dynamics.eval_dot(
            params["dynamics"], h, x_feat, rng=rng if train else None,
            scale_nominal=scale_nominal,
        )

    def raw_dot(self, params, h, x_feat, *, train=False, rng=None):
        return self.dynamics.raw(
            params["dynamics"], h, x_feat, rng=rng if train else None
        )

    # -- fused fast path -----------------------------------------------------

    def _fused_setup(self, params, feats):
        """Packed weights + input injection for the fused RHS kernel.

        Densifies Cayley layers and precomputes xc = U feats + bU + b1 once
        per solve — both are loop-invariant (the reference recomputes
        U_x(x) on every RHS eval, dynamics/classification.py:97)."""
        dense = densify_dynamics_params(params["dynamics"])
        p = pack_rhs_params(
            dense["hidden_to_mlp"]["kernel"], dense["mlp_to_mlp"]["kernel"],
            dense["mlp_to_hidden"]["kernel"], dense["mlp_to_mlp"]["bias"],
            dense["mlp_to_hidden"]["bias"],
        )
        U = dense["U_x"]["kernel"]
        xc = feats @ U.T + dense["U_x"]["bias"] + dense["hidden_to_mlp"]["bias"]
        return p, jnp.pad(xc, ((0, 0), (0, p.W2t.shape[0] - xc.shape[1])))

    def _solve_fused(self, params, x, ts, *, mode, scale_nominal, method,
                     rtol, atol):
        """Solve on a padded state: lanes to ``pad_width(n)`` and rows to a
        multiple of the kernel's block, once per solve.  Padded lanes and
        rows carry zero weight in the step-size error norm, so step control
        sees exactly the unpadded state."""
        dyn = self.dynamics
        if dyn.activation != "ReLU":
            raise ValueError("the fused RHS kernel implements ReLU dynamics")
        n = dyn.n_hidden
        B = x.shape[0]
        feats = self.features(params, x)
        p, xc = self._fused_setup(params, feats)
        sn = dyn.scale_nominal if scale_nominal is None else scale_nominal
        rows = B + (-B % BLOCK)
        NP = pad_width(n)
        h0 = jnp.zeros((rows, NP)).at[:B, :n].set(self.h0(B))
        xc = jnp.pad(xc, ((0, rows - B), (0, 0)))
        weight = jnp.zeros((rows, NP)).at[:B, :n].set(1.0)

        def f(t, h, args):
            pp, xcc = args
            return fused_rhs(
                h, xcc, pp, n, dyn.alpha_1, dyn.sigma_1, dyn.alpha_2, sn,
                dyn.qp_iters, BLOCK,
            )

        sol = odeint(
            f, h0, ts, (p, xc),
            method=method or self.method,
            rtol=self.rtol if rtol is None else rtol,
            atol=self.atol if atol is None else atol,
            max_steps=self.max_steps, mode=mode, error_weight=weight,
        )
        return OdeSolution(sol.ys[..., :B, :n], sol.nfe, sol.n_accepted,
                           sol.n_rejected)

    # -- forward (integrate) -------------------------------------------------

    def solve(
        self,
        params,
        x,
        ts=None,
        *,
        mode: str = "while",
        use_adjoint: bool = False,
        scale_nominal=None,
        method=None,
        rtol=None,
        atol=None,
        fused: Optional[bool] = None,
    ):
        """Integrate and return OdeSolution over requested ts (trajectory of h).

        With use_adjoint=True, gradients flow to x (and params) through the
        continuous adjoint; ys only (no NFE stats) are returned in that case.
        ``fused=None`` picks the RHS per platform when the program is
        lowered: the fused Triton kernel (ops/fused_rhs.py) on CUDA, where
        it beat XLA's op-by-op RHS end to end on the flagship solve, and
        the plain jnp RHS on the CPU; other platforms fail to lower.  Under
        float32 matmul precision the plain RHS runs everywhere: the
        kernel's IEEE dots lose to XLA's there (PERF.md).
        ``fused=True/False`` forces one (tests, benchmarks).
        """
        if ts is None:
            ts = jnp.asarray([0.0, self.t_max])
        kw = dict(mode=mode, scale_nominal=scale_nominal, method=method,
                  rtol=rtol, atol=atol)
        if use_adjoint:
            return self._solve_adjoint(params, x, ts, **kw)
        if fused is None and (
            self.dynamics.activation != "ReLU"  # the kernel's dynamics
            or ambient_dot_precision() == jax.lax.Precision.HIGHEST
        ):
            fused = False
        if fused is None:
            return jax.lax.platform_dependent(
                params, x, ts,
                cpu=lambda p, x, ts: self._solve_plain(p, x, ts, **kw),
                cuda=lambda p, x, ts: self._solve_fused(p, x, ts, **kw),
            )
        if fused:
            return self._solve_fused(params, x, ts, **kw)
        return self._solve_plain(params, x, ts, **kw)

    def _solve_adjoint(self, params, x, ts, *, mode, scale_nominal, method,
                       rtol, atol):
        feats = self.features(params, x)
        h0 = self.h0(x.shape[0])

        def f(t, h, args):
            return self.eval_dot(args, h, args["__feats__"],
                                 scale_nominal=scale_nominal)

        args = {"dynamics": params["dynamics"], "__feats__": feats}
        ys = odeint_adjoint(
            f, h0, ts, args,
            method or self.method, self.rtol if rtol is None else rtol,
            self.atol if atol is None else atol, self.max_steps, True,
        )
        return OdeSolution(ys, jnp.zeros((), jnp.int32),
                           jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32))

    def _solve_plain(self, params, x, ts, *, mode, scale_nominal, method,
                     rtol, atol):
        feats = self.features(params, x)
        h0 = self.h0(x.shape[0])
        dyn_params = {"dynamics": params["dynamics"]}

        def f(t, h, args):
            return self.eval_dot(args, h, feats, scale_nominal=scale_nominal)

        return odeint(
            f, h0, ts, dyn_params,
            method=method or self.method,
            rtol=self.rtol if rtol is None else rtol,
            atol=self.atol if atol is None else atol,
            max_steps=self.max_steps,
            mode=mode,
        )

    def predict(self, params, x, **kw):
        """Class probabilities at t_max (the forward pass of the classifier)."""
        sol = self.solve(params, x, **kw)
        return self.output_fn(sol.ys[-1], params.get("output"))

    def trajectory(self, params, x, n_points: int = 100, **kw):
        ts = jnp.linspace(0.0, self.t_max, n_points)
        sol = self.solve(params, x, ts, **kw)
        return self.output_fn(sol.ys, params.get("output"))
