"""Backbone feature extractors (the ODE's input injection `param_map`).

Parity targets (reference models.py:29-178):
  * make_ortho_KWLarge_Concat / make_ortho_KWLargeMNIST_Concat —
    Cayley orthogonal-conv KWLarge nets with GroupSort, ending in a linear
    head to ``out_dim`` features (the "Concat" family of the FI-ODE
    ortho_conv fork).  Overall Lipschitz constant 1/min(std) in pixel space.
  * make_4C3F / make_4C3F_nolips / make_6C2F — plain CNNs with
    power-iteration-tracked Lipschitz layers (4C3F == KWLarge shape).

All models take NCHW in [0,1] and normalise internally (Normalize is the
first layer) so attacks and certification operate in pixel space
(dataset_loaders.py keeps transforms un-normalised for the same reason).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import jax

from ..ops.cayley import groupsort2
from .layers import (
    CayleyConv,
    CayleyLinear,
    LipsConv,
    LipsLinear,
    Module,
    Normalize,
)

__all__ = ["KWLargeBackbone", "PlainCNNBackbone", "make_backbone"]


def _act(name: str):
    if name == "GroupSort":
        return lambda x: groupsort2(x, 1 if x.ndim == 4 else -1)
    if name == "ReLU":
        return jax.nn.relu
    raise ValueError(f"unknown activation {name!r}")


def _flatten(x):
    return x.reshape(x.shape[0], -1)


class _Sequential(Module):
    """A chain of layers.  Parametrised layers are named ``<Type>_<k>`` (the
    k-th layer of that type), which is the path of their parameters;
    plain functions (activations, flatten) hold none."""

    def layers(self):
        raise NotImplementedError

    def _named(self):
        counts = {}
        for layer in self.layers():
            name = None
            if isinstance(layer, Module):
                t = type(layer).__name__
                name = f"{t}_{counts.get(t, 0)}"
                counts[t] = counts.get(t, 0) + 1
            yield name, layer

    def init_at(self, keys, x):
        params = {}
        for name, layer in self._named():
            if name is None:
                x = layer(x)
                continue
            p = layer.init_at(keys.child(name), x)
            if p:
                params[name] = p
            x = layer.apply(p, x)
        return params

    def apply(self, params, x):
        for name, layer in self._named():
            x = layer(x) if name is None else layer.apply(params.get(name), x)
        return x


@dataclasses.dataclass(frozen=True)
class KWLargeBackbone(_Sequential):
    """Cayley orthogonal KWLarge: 4 conv + 3 linear, GroupSort activations.

    CIFAR shape: 3x32x32 -> 32c3 -> 32c4/s2 -> 64c3 -> 64c4/s2 -> flatten
                 -> 512 -> 512 -> out_dim.
    MNIST shape: 1x28x28 with the same channel progression (spatial 7x7).
    """

    out_dim: int = 128
    act: str = "GroupSort"
    mu: Sequence[float] = (0.0,)
    std: Sequence[float] = (1.0,)
    width: int = 1
    # test/inference twin (reference models.py:154-165 ortho_models_test.*):
    # Cayley transforms precomputed once via cache_cayley_params
    cached: bool = False
    # KWLarge_inter (reference models.py:172-178): expose the intermediate
    # 512-wide representation instead of the out_dim head (the submodule is
    # an empty stub; reconstructed from the factory name/shape)
    inter: bool = False

    def layers(self):
        a = _act(self.act)
        w = self.width
        c = self.cached
        out = [
            Normalize(self.mu, self.std),
            CayleyConv(32 * w, 3, cached=c), a,
            CayleyConv(32 * w, 4, stride=2, cached=c), a,
            CayleyConv(64 * w, 3, cached=c), a,
            CayleyConv(64 * w, 4, stride=2, cached=c), a,
            _flatten,
            CayleyLinear(512 * w, cached=c), a,
            CayleyLinear(512, cached=c), a,
        ]
        if not self.inter:
            out.append(CayleyLinear(self.out_dim, cached=c))
        return out


@dataclasses.dataclass(frozen=True)
class PlainCNNBackbone(_Sequential):
    """4C3F / 6C2F-style CNNs with Lipschitz-trackable layers.

    arch='4C3F':  conv 32c3, 32c4/s2, 64c3, 64c4/s2 -> 512 -> 512 -> out_dim
    arch='6C2F':  conv 32c3 x2, 32c4/s2, 64c3 x2, 64c4/s2 -> 512 -> out_dim
    """

    arch: str = "4C3F"
    out_dim: int = 10
    act: str = "ReLU"
    mu: Sequence[float] = (0.0,)
    std: Sequence[float] = (1.0,)

    def layers(self):
        a = _act(self.act)
        if self.arch == "4C3F":
            convs = [(32, 3, 1), (32, 4, 2), (64, 3, 1), (64, 4, 2)]
            hidden = [512, 512]
        elif self.arch == "6C2F":
            convs = [(32, 3, 1), (32, 3, 1), (32, 4, 2),
                     (64, 3, 1), (64, 3, 1), (64, 4, 2)]
            hidden = [512]
        else:
            raise ValueError(f"unknown arch {self.arch!r}")
        out = [Normalize(self.mu, self.std)]
        for f, k, s in convs:
            out += [LipsConv(f, k, stride=s, padding=1), a]
        out.append(_flatten)
        for f in hidden:
            out += [LipsLinear(f), a]
        out.append(LipsLinear(self.out_dim))
        return out


@dataclasses.dataclass(frozen=True)
class TinyMLPBackbone(_Sequential):
    """Small flatten->MLP feature map (tests / fast CPU experiments; not in
    the reference zoo)."""

    out_dim: int = 10
    hidden: int = 64
    mu: Sequence[float] = (0.0,)
    std: Sequence[float] = (1.0,)

    def layers(self):
        return [
            Normalize(self.mu, self.std), _flatten,
            LipsLinear(self.hidden), jax.nn.relu,
            LipsLinear(self.out_dim),
        ]


def make_backbone(name: str, *, out_dim: int, act: str, mu, std) -> Module:
    """Factory matching the reference's param_map registry
    (ExpConfig.py:107-162): ORTHO_KWLarge_Concat, ORTHO_KWLargeMNIST_Concat,
    CIFAR_4C3F, CIFAR_4C3F_nolips, CIFAR_6C2F, Identity."""
    if name in ("ORTHO_KWLarge_Concat", "ORTHO_KWLargeMNIST_Concat"):
        return KWLargeBackbone(out_dim=out_dim, act=act, mu=mu, std=std)
    if name in ("ORTHO_KWLarge_Concat_test", "ORTHO_KWLargeMNIST_Concat_test"):
        # test twins (reference models.py:154-165): same architecture with
        # the Cayley transforms precomputed once (fill params with
        # layers.cache_cayley_params from a trained checkpoint)
        return KWLargeBackbone(
            out_dim=out_dim, act=act, mu=mu, std=std, cached=True
        )
    if name == "ORTHO_KWLarge_inter":
        return KWLargeBackbone(
            out_dim=out_dim, act=act, mu=mu, std=std, inter=True
        )
    if name in ("CIFAR_4C3F", "CIFAR_4C3F_nolips"):
        return PlainCNNBackbone(arch="4C3F", out_dim=out_dim, act=act, mu=mu, std=std)
    if name == "CIFAR_6C2F":
        return PlainCNNBackbone(arch="6C2F", out_dim=out_dim, act=act, mu=mu, std=std)
    if name == "TinyMLP":
        return TinyMLPBackbone(out_dim=out_dim, mu=mu, std=std)
    if name == "Identity":
        # reference registry's Identity param_map: no feature extractor —
        # NeuralODEClassifier(backbone=None) feeds flattened pixels to the
        # dynamics input injection directly
        return None
    raise ValueError(f"unknown backbone {name!r}")
