"""Simplex-projected Lipschitz ODE dynamics (the RHS f(h, x)).

Rebuild of the reference's OrthoClassDynProjectSimplexLips
(dynamics/classification.py:31-132):

  raw MLP:   f~ = W3 a(W2 a(W1 h + U x + b1) + b2) + b3        (:96-102)
  barrier:   lower = -alpha_1 (exp(sigma_1 h) - 1)             (:108)
             upper =  alpha_2 (1 - h)                          (:109)
  scaling:   f~ <- (upper - lower) sigmoid(f~) + lower  [opt]  (:110-112)
  project:   f  = QP-project f~ onto {sum v = 0, v >= lower}   (:114)

which renders the probability simplex forward-invariant: on the face h_i = 0
the lower barrier vanishes, and sum(f) = 0 keeps sum(h) = 1.

Layers are CayleyLinear (orthogonal, Lip 1) or LipsLinear; dropout is applied
inside the raw MLP at train time (:98-100) — the only stochasticity in the
RHS, threaded via an explicit PRNG key.

``densify`` bakes Cayley weights into plain dense matrices for certification
(the reference's convert_cayley, dynamics/classification.py:281-294); the
CROWN/IBP bound helpers over this graph live in fiode_tpu/verify.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import jax
import jax.numpy as jnp

from ..ops.cayley import cayley, groupsort2
from ..ops.simplex_qp import simplex_cone_project
from ..utils.debug import env_flag
from .layers import CayleyLinear, LipsLinear, Module, fold_path

__all__ = ["SimplexDynamics", "barrier_bounds", "densify_dynamics_params"]


def barrier_bounds(h, alpha_1, sigma_1, alpha_2):
    lower = -alpha_1 * (jnp.exp(sigma_1 * h) - 1.0)
    upper = alpha_2 * (1.0 - h)
    return lower, upper


def _dropout(x, rate, rng, name):
    """Inverted dropout with the mask keyed by the layer ``name``."""
    if rng is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = jax.random.bernoulli(fold_path(rng, (name, 1)), p=keep,
                                shape=x.shape)
    return jax.lax.select(mask, x / keep, jnp.zeros_like(x))


@dataclasses.dataclass(frozen=True)
class SimplexDynamics(Module):
    """f(h, x): simplex-cone-projected Lipschitz MLP dynamics.

    ``init(key, h, x)`` / ``eval_dot(params, h, x)``; ``rng`` (train-time
    dropout) is the only stochasticity."""

    n_hidden: int = 10
    mlp_size: int = 128
    x_dim: int = 10
    activation: str = "ReLU"
    dropout: float = 0.5
    alpha_1: float = 100.0
    alpha_2: float = 20.0
    sigma_1: float = 0.02
    scale_nominal: bool = False
    cayley: bool = True
    kappa: float = 2.0
    kappa_length: int = 0
    qp_iters: int = 30

    def _layers(self):
        lin = CayleyLinear if self.cayley else LipsLinear
        return {
            "hidden_to_mlp": lin(self.mlp_size),
            "U_x": lin(self.mlp_size),
            "mlp_to_mlp": lin(self.mlp_size),
            "mlp_to_hidden": lin(self.n_hidden),
        }

    def init_at(self, keys, h, x):
        layers = self._layers()
        p = {}

        def lin(name, v):
            p[name] = layers[name].init_at(keys.child(name), v)
            return layers[name].apply(p[name], v)

        z = self._act(lin("hidden_to_mlp", h) + lin("U_x", x))
        lin("mlp_to_hidden", self._act(lin("mlp_to_mlp", z)))
        return p

    def _act(self, x):
        if self.activation == "GroupSort":
            return groupsort2(x)
        return jax.nn.relu(x)

    def raw(self, params, h, x, *, rng=None):
        """The unprojected f~ (reference _h_dot_raw, :96-102); ``rng``
        turns train-time dropout on."""
        layers = self._layers()
        lin = lambda name, v: layers[name].apply(params[name], v)
        z = lin("hidden_to_mlp", h) + lin("U_x", x)
        z = self._act(_dropout(z, self.dropout, rng, "drop1"))
        z = lin("mlp_to_mlp", z)
        z = self._act(_dropout(z, self.dropout, rng, "drop2"))
        return lin("mlp_to_hidden", z)

    def eval_dot(self, params, h, x, *, rng=None, scale_nominal=None):
        """The projected dynamics f(h, x) (reference eval_dot, :104-115)."""
        f_tilde = self.raw(params, h, x, rng=rng)
        lower, upper = barrier_bounds(h, self.alpha_1, self.sigma_1, self.alpha_2)
        sn = self.scale_nominal if scale_nominal is None else scale_nominal
        if sn:
            f_tilde = (upper - lower) * jax.nn.sigmoid(f_tilde) + lower
        # FIODE_QP_UNROLL=1 flattens the 30-iteration bisection into the
        # surrounding graph (one fused elementwise kernel instead of a
        # rolled loop per RHS eval) — measured per-workload before enabling;
        # see ops/simplex_qp._bisect_mu.  FIODE_QP_METHOD=exact|sort
        # replaces the bisection entirely with the closed-form rank-rule
        # mu: one parallel pass, no 30-step serial value dependency —
        # measured per-workload like the other flags.
        from ..ops.simplex_qp import qp_method_from_env
        return simplex_cone_project(
            lower, f_tilde, self.qp_iters, env_flag("FIODE_QP_UNROLL"),
            qp_method_from_env(),
        )


def _dense_from_cayley(p: Dict[str, Any]) -> Dict[str, Any]:
    W = p["weight"]
    Q = cayley(p["alpha"] * W / jnp.linalg.norm(W))
    out = {"kernel": Q}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def densify_dynamics_params(dyn_params: Dict[str, Any]) -> Dict[str, Any]:
    """Bake Cayley layers to dense {kernel, bias} mats for bound propagation.

    Input: the SimplexDynamics params dict {'hidden_to_mlp': {...}, ...}.
    Output: same tree with every layer as {'kernel': (out,in), 'bias': (out,)}.
    (Reference convert_cayley, dynamics/classification.py:281-294.)
    """
    out = {}
    for name, p in dyn_params.items():
        if "weight" in p:  # CayleyLinear
            out[name] = _dense_from_cayley(p)
        else:  # LipsLinear already dense
            q = {"kernel": p["kernel"]}
            if "bias" in p:
                q["bias"] = p["bias"]
            out[name] = q
        if "bias" not in out[name]:
            out[name]["bias"] = jnp.zeros(out[name]["kernel"].shape[0])
    return out
