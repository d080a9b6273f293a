"""Legacy conv-feature dynamics (the LyaNet-heritage model family).

Capability rebuild of the reference's legacy dynamics modules, which are not
referenced by any live config (SURVEY.md §2.2) but are part of the API
surface:
  * ResNetBlockDyn (dynamics/resnet_block.py:5-49) — conv-block RHS over an
    image-shaped hidden state, with the input image injected through a stem;
  * DynBasicBlock / DynBottleneck / ResNetOutput (dynamics/naiveResNet.py:20-147)
    — ResNet block shapes with the residual connections deliberately removed
    (:51,63-64), acting as the RHS of an ODE over conv features.

State is (B, C, H, W); `state_init` produces h(0) from the input image (the
DefaultInitFun path that defers to dyn.state_init,
dynamics/init_coordinates.py:26-27).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .layers import Module, ParamKeys

__all__ = ["ConvBlockDynamics", "DynBasicBlock", "DynBottleneck", "ResNetOutput"]

_lecun_normal = jax.nn.initializers.lecun_normal()


def _conv_init(key, c_in, c_out, k=3):
    """OIHW kernel, LeCun-normal over the fan-in c_in * k * k."""
    return _lecun_normal(key, (k, k, c_in, c_out)).transpose(3, 2, 0, 1)


def _conv(x, W):
    """'SAME'-padded stride-1 NCHW convolution without bias."""
    return jax.lax.conv_general_dilated(
        x, W, (1, 1), "SAME", dimension_numbers=("NCHW", "OIHW", "NCHW")
    )


def _groups(ch):
    return next(g for g in (8, 4, 2, 1) if ch % g == 0)


def _group_norm(x, p, groups, eps=1e-6):
    """GroupNorm over NCHW with a learned per-channel scale and bias."""
    b, c, h, w = x.shape
    g = x.reshape(b, groups, c // groups, h, w)
    mean = g.mean(axis=(2, 3, 4), keepdims=True)
    var = g.var(axis=(2, 3, 4), keepdims=True)
    g = (g - mean) * jax.lax.rsqrt(var + eps)
    return (g.reshape(b, c, h, w) * p["scale"][None, :, None, None]
            + p["bias"][None, :, None, None])


def _norm_params(c):
    return {"scale": jnp.ones((c,)), "bias": jnp.zeros((c,))}


@dataclasses.dataclass(frozen=True)
class DynBasicBlock(Module):
    """BasicBlock-shaped RHS: conv-norm-act-conv-norm (NO residual add)."""

    features: int

    def init_at(self, keys, h):  # h: (B, C, H, W)
        c = self.features
        return {
            "conv1": _conv_init(keys(1), h.shape[1], c),
            "norm1": _norm_params(c),
            "conv2": _conv_init(keys(2), c, c),
            "norm2": _norm_params(c),
        }

    def apply(self, p, h):
        x = jax.nn.relu(_group_norm(_conv(h, p["conv1"]), p["norm1"], 8))
        return _group_norm(_conv(x, p["conv2"]), p["norm2"], 8)


@dataclasses.dataclass(frozen=True)
class DynBottleneck(Module):
    """Bottleneck-shaped RHS: 1x1 squeeze -> 3x3 -> 1x1 expand (NO residual
    add).  As an ODE right-hand side dh/dt must match h's channel count, so
    the final 1x1 expands back to ``features`` and the squeeze width is
    ``features // expansion``."""

    features: int
    expansion: int = 4

    def init_at(self, keys, h):
        c = self.features
        w = max(c // self.expansion, 1)
        return {
            "conv1": _conv_init(keys(1), h.shape[1], w, k=1),
            "norm1": _norm_params(w),
            "conv2": _conv_init(keys(2), w, w),
            "norm2": _norm_params(w),
            "conv3": _conv_init(keys(3), w, c, k=1),
            "norm3": _norm_params(c),
        }

    def apply(self, p, h):
        w = p["conv1"].shape[0]
        x = jax.nn.relu(_group_norm(_conv(h, p["conv1"]), p["norm1"], _groups(w)))
        x = jax.nn.relu(_group_norm(_conv(x, p["conv2"]), p["norm2"], _groups(w)))
        return _group_norm(_conv(x, p["conv3"]), p["norm3"],
                           _groups(self.features))


@dataclasses.dataclass(frozen=True)
class ConvBlockDynamics(Module):
    """Conv dynamics over image-shaped hidden state with input injection.

    eval_dot(params, h, x): f = block(h) + stem(x);
    state_init(params, x) = stem(x) — the ResNetBlockDyn pattern
    (dynamics/resnet_block.py).
    """

    features: int = 32
    block: str = "basic"  # 'basic' | 'bottleneck'

    def _body(self):
        if self.block == "basic":
            return DynBasicBlock(self.features)
        return DynBottleneck(self.features)

    def init_at(self, keys: ParamKeys, h, x):
        return {
            "stem": _conv_init(keys(1), x.shape[1], self.features),
            "body": self._body().init_at(keys.child("body"), h),
        }

    def state_init(self, params, x):
        return jax.nn.relu(_conv(x, params["stem"]))

    def eval_dot(self, params, h, x, *, scale_nominal=None):
        return (self._body().apply(params["body"], h)
                + self.state_init(params, x))

    apply = eval_dot


@dataclasses.dataclass(frozen=True)
class ResNetOutput(Module):
    """Global-pool + linear readout from conv state to logits
    (naiveResNet.py ResNetOutput)."""

    n_classes: int = 10

    def init_at(self, keys, h):  # (B, C, H, W)
        return {
            "kernel": _lecun_normal(keys(1), (h.shape[1], self.n_classes)),
            "bias": jnp.zeros((self.n_classes,)),
        }

    def apply(self, p, h):
        return jnp.mean(h, axis=(2, 3)) @ p["kernel"] + p["bias"]
