"""Layers: Normalize, Cayley orthogonal linear/conv, Lipschitz-tracked
conv/linear, GroupSort — plain functional modules.

Every module is a frozen dataclass of hyper-parameters with two methods:
``init(key, *inputs) -> params`` (a nested dict of arrays) and
``apply(params, *inputs)``.  Composite modules call ``init_at`` on their
children with ``ParamKeys.child(name)``, so parameter paths
(e.g. ``params["dynamics"]["hidden_to_mlp"]["kernel"]``) are the dict
paths the Certifier and ``densify_dynamics_params`` read.

Capability parity with the reference's layer zoo:
  * Normalize               — models.py:17-26 (mean/std inside the model so
                              attacks/certification act in [0,1] pixel space)
  * CayleyLinear            — libs/ortho_conv layer used by the dynamics
                              (dynamics/classification.py:69-75); learnable
                              alpha, weight mapped through
                              cayley(alpha * W / ||W||)
  * CayleyConv              — FFT-domain orthogonal convolution; stride-2 is
                              realised as invertible space-to-depth followed
                              by a stride-1 orthogonal conv (the standard
                              construction from "Orthogonalizing Convolutional
                              Layers with the Cayley Transform")
  * LipsConv / LipsLinear   — plain conv/linear whose sigma_max is tracked by
                              power iteration (dynamics/classification.py:19-28);
                              here the singular vectors are carried in a
                              separate functional state (see train/lips.py)
  * GroupSort               — MaxMin activation (gradient-norm preserving)
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Sequence

import jax
import jax.numpy as jnp

from ..ops.cayley import (
    apply_freq_matrices,
    cayley,
    cayley_conv_apply,
    cayley_conv_kernel,
    cayley_linear_kernel,
    groupsort2,
)

__all__ = [
    "Module",
    "ParamKeys",
    "Normalize",
    "CayleyLinear",
    "CayleyConv",
    "LipsLinear",
    "LipsConv",
    "GroupSort",
    "space_to_depth",
    "cache_cayley_params",
]

_trunc_normal_fan_out = jax.nn.initializers.variance_scaling(
    2.0, "fan_out", "truncated_normal"
)
_he_normal_fan_out = jax.nn.initializers.variance_scaling(2.0, "fan_out", "normal")
_zeros = jax.nn.initializers.zeros


def fold_path(key, path) -> jax.Array:
    """``key`` with a static path (strings and ints) folded in: the SHA-1 of
    the path's bytes, first 4 bytes big-endian, through ``fold_in``.

    Keys made this way depend only on the path, never on the order in
    which modules happen to be initialised, and match the layout that the
    committed checkpoints and golden fixtures were initialised with."""
    m = hashlib.sha1()
    for x in path:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    return jax.random.fold_in(
        key, jnp.uint32(int.from_bytes(m.digest()[:4], byteorder="big"))
    )


@dataclasses.dataclass(frozen=True)
class ParamKeys:
    """PRNG keys for the parameters of one module: the ``i``-th parameter a
    module creates (1-based) draws ``fold_path(key, path + (i,))``."""

    key: jax.Array
    path: tuple = ()

    def child(self, name: str) -> "ParamKeys":
        return ParamKeys(self.key, self.path + (name,))

    def __call__(self, index: int) -> jax.Array:
        return fold_path(self.key, self.path + (index,))


class Module:
    """Functional module: ``init(key, *inputs) -> params``,
    ``apply(params, *inputs)``.  Subclasses implement ``init_at(keys,
    *inputs)`` (parameters for inputs shaped like ``inputs``)."""

    def init(self, key, *inputs):
        return self.init_at(ParamKeys(key), *inputs)

    def init_at(self, keys: ParamKeys, *inputs):
        return {}


def cache_cayley_params(cached_module, train_params, example_x, rng=None):
    """Densify trained Cayley weights into the ``cached=True`` twin's params.

    Walks the cached module's param structure (obtained shape-only via
    ``jax.eval_shape``) alongside the trained params: every {"Q"} leaf-dict
    is filled with the orthogonalised weight — ``cayley_linear_kernel`` for
    2-D Q, per-frequency ``cayley_conv_kernel`` for 4-D (n, nf, co, ci) Q —
    and everything else (biases, plain layers) is copied through.  The
    equivalent of the ortho_conv fork's test-model weight caching (reference
    models.py:154-165: ortho_models_test.* share the train models'
    state_dicts).
    """
    rng = rng if rng is not None else jax.random.PRNGKey(0)
    shapes = jax.eval_shape(cached_module.init, rng, example_x)

    def fill(shape_tree, src_tree):
        if isinstance(shape_tree, dict):
            if "Q" in shape_tree:
                q = shape_tree["Q"]
                out = {}
                if q.ndim == 2:
                    out["Q"] = cayley_linear_kernel(
                        src_tree["weight"], src_tree["alpha"]
                    )
                else:
                    n, nf, co, ci = q.shape
                    out["Q"] = cayley_conv_kernel(
                        src_tree["weight"], src_tree["alpha"], n
                    ).reshape(n, nf, co, ci)
                if "bias" in shape_tree:
                    out["bias"] = src_tree["bias"]
                return out
            return {k: fill(v, src_tree[k]) for k, v in shape_tree.items()}
        return src_tree

    return fill(shapes, train_params)


@dataclasses.dataclass(frozen=True)
class Normalize(Module):
    """(x - mu) / std with fixed statistics baked into the graph."""

    mu: Sequence[float]
    std: Sequence[float]

    def apply(self, params, x):
        # NCHW: broadcast over (C, 1, 1)
        mu = jnp.asarray(self.mu, x.dtype).reshape(-1, 1, 1)
        std = jnp.asarray(self.std, x.dtype).reshape(-1, 1, 1)
        return (x - mu) / std


@dataclasses.dataclass(frozen=True)
class GroupSort(Module):
    """MaxMin over pairs of *channels*: axis 1 for NCHW, last axis otherwise."""

    def apply(self, params, x):
        axis = 1 if x.ndim == 4 else -1
        return groupsort2(x, axis)


def _alpha_init(W):
    return jnp.linalg.norm(W).astype(jnp.float32)


@dataclasses.dataclass(frozen=True)
class CayleyLinear(Module):
    """Orthogonal linear layer y = Q x + b, Q = cayley(alpha W / ||W||).

    ``cached=True`` is the test/inference variant (the ortho_conv fork's
    ``models_test`` twins, reference models.py:154-165): the orthogonal Q is
    a parameter computed ONCE from trained weights by
    ``cache_cayley_params`` instead of re-orthogonalising every forward.
    """

    features: int
    use_bias: bool = True
    cached: bool = False

    def init_at(self, keys, x):
        shape = (self.features, x.shape[-1])
        if self.cached:
            # NaN init: a cached twin used without cache_cayley_params is a
            # bug (it would otherwise silently emit zero features); NaN
            # surfaces the misuse at the first forward
            p = {"Q": jnp.full(shape, jnp.nan, jnp.float32)}
        else:
            W = _trunc_normal_fan_out(keys(1), shape)
            p = {"weight": W, "alpha": _alpha_init(W)}
        if self.use_bias:
            p["bias"] = _zeros(keys(len(p) + 1), (self.features,))
        return p

    def apply(self, params, x):
        if self.cached:
            Q = params["Q"]
        else:
            W = params["weight"]
            Q = cayley(params["alpha"] * W / jnp.linalg.norm(W))
        y = x @ Q.T
        if self.use_bias:
            y = y + params["bias"]
        return y


def space_to_depth(x, block: int = 2):
    """Invertible downsampling: (B, C, H, W) -> (B, C*block^2, H/b, W/b)."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // block, block, w // block, block)
    x = jnp.transpose(x, (0, 1, 3, 5, 2, 4))
    return x.reshape(b, c * block * block, h // block, w // block)


@dataclasses.dataclass(frozen=True)
class CayleyConv(Module):
    """Orthogonal circular convolution (FFT-domain Cayley), NCHW.

    stride=2 is emulated by space_to_depth(2) then a stride-1 orthogonal conv
    with kernel ceil(k/2) — the overall map remains norm-preserving because
    space_to_depth is an isometry.
    """

    features: int
    kernel_size: int = 3
    stride: int = 1
    use_bias: bool = True
    cached: bool = False

    def _prepare(self, x):
        if self.stride == 2:
            return space_to_depth(x, 2), max(1, (self.kernel_size + 1) // 2)
        if self.stride == 1:
            return x, self.kernel_size
        raise ValueError("CayleyConv supports stride 1 or 2")

    def init_at(self, keys, x):
        x, k = self._prepare(x)
        ci = x.shape[1]
        if self.cached:
            # per-frequency semi-orthogonal matrices, precomputed once from
            # trained weights (cache_cayley_params); stored (n, nf, co, ci)
            # so the spatial size is recoverable from the shape.  NaN init
            # for the same reason as CayleyLinear's cached Q
            n = x.shape[-1]
            shape = (n, n // 2 + 1, self.features, ci)
            p = {"Q": jnp.full(shape, jnp.nan, jnp.complex64)}
        else:
            W = _trunc_normal_fan_out(keys(1), (self.features, ci, k, k))
            p = {"weight": W, "alpha": _alpha_init(W)}
        if self.use_bias:
            p["bias"] = _zeros(keys(len(p) + 1), (self.features,))
        return p

    def apply(self, params, x):
        x, _ = self._prepare(x)
        if self.cached:
            Qf = params["Q"]
            n, nf = Qf.shape[:2]
            y = apply_freq_matrices(x, Qf.reshape(n * nf, *Qf.shape[2:]))
        else:
            y = cayley_conv_apply(x, params["weight"], params["alpha"])
        if self.use_bias:
            y = y + params["bias"][None, :, None, None]
        return y


@dataclasses.dataclass(frozen=True)
class LipsLinear(Module):
    """Plain linear layer whose spectral norm is tracked externally."""

    features: int
    use_bias: bool = True

    def init_at(self, keys, x):
        p = {"kernel": _he_normal_fan_out(keys(1), (self.features, x.shape[-1]))}
        if self.use_bias:
            p["bias"] = _zeros(keys(2), (self.features,))
        return p

    def apply(self, params, x):
        y = x @ params["kernel"].T
        if self.use_bias:
            y = y + params["bias"]
        return y


@dataclasses.dataclass(frozen=True)
class LipsConv(Module):
    """Plain NCHW conv (He-init, reference models.py:71-75) with tracked sigma."""

    features: int
    kernel_size: int
    stride: int = 1
    padding: int = 0
    use_bias: bool = True

    def init_at(self, keys, x):
        k = self.kernel_size
        shape = (self.features, x.shape[1], k, k)
        # He normal: std = sqrt(2 / (k*k*out))  (reference init,
        # dynamics/classification.py:87-91)
        std = jnp.sqrt(2.0 / (shape[2] * shape[3] * shape[0]))
        p = {"kernel": jax.random.normal(keys(1), shape) * std}
        if self.use_bias:
            p["bias"] = _zeros(keys(2), (self.features,))
        return p

    def apply(self, params, x):
        W = params["kernel"]
        y = jax.lax.conv_general_dilated(
            x,
            W,
            (self.stride, self.stride),
            [(self.padding, self.padding)] * 2,
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
        )
        if self.use_bias:
            y = y + params["bias"][None, :, None, None]
        return y
