"""State-space samplers for Lyapunov certified training.

Functional rebuild of the reference's sampler zoo (sampling/sampler.py:12-216):
each sampler draws points h in (or near) the probability simplex where the
Lyapunov decrease condition is enforced.  All samplers take an explicit PRNG
key and return (batch, sample_size, n) — batch-dependent samplers use the
labels, batch-independent ones broadcast.

``composite_sample`` mixes samplers with per-epoch coefficients.  Static-shape
design: instead of the reference's floor(S*coeff) dynamic slicing (which
would change shapes and retrigger compilation every epoch), every sampler
draws all S samples and a per-slot mask selects which sampler owns each slot
— static shapes, branch-free, coefficients are a traced argument.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import jax
import jax.numpy as jnp

__all__ = [
    "uniform_simplex",
    "band_simplex",
    "projected_biased_hypersphere",
    "projected_hypercube",
    "correct_cone",
    "decision_boundary",
    "trajectory_sampler",
    "composite_sample",
    "SAMPLERS",
]


def _exp_simplex(key, shape):
    """Uniform (Dirichlet(1)) samples on the simplex via Exp(1) + L1 norm."""
    e = jax.random.exponential(key, shape)
    return e / jnp.sum(e, axis=-1, keepdims=True)


def uniform_simplex(key, y, n, sample_size, **_):
    """(reference UniformSimplexSampling, :24-38)"""
    B = y.shape[0]
    return _exp_simplex(key, (B, sample_size, n))


def band_simplex(key, y, n, sample_size, **_):
    """Uniform simplex but the label coordinate resampled in U(0.1, 1)
    (reference BandSimplexSampling, :41-60)."""
    k1, k2 = jax.random.split(key)
    B = y.shape[0]
    h = _exp_simplex(k1, (B, sample_size, n))
    gt = jax.random.uniform(k2, (B, sample_size), minval=0.1, maxval=1.0)
    onehot = jax.nn.one_hot(y, n)[:, None, :]
    return h * (1 - onehot) + gt[..., None] * onehot


def projected_biased_hypersphere(key, y, n, sample_size, h_dist_lim=15.0, **_):
    """softmax(radius * unit_normal), radius ~ U(0, sqrt(n)·lim)
    (reference :63-83)."""
    k1, k2 = jax.random.split(key)
    B = y.shape[0]
    r = jax.random.uniform(
        k1, (B, sample_size, 1), maxval=jnp.sqrt(n * h_dist_lim**2)
    )
    v = jax.random.normal(k2, (B, sample_size, n))
    v = v / jnp.linalg.norm(v, axis=-1, keepdims=True)
    return jax.nn.softmax(v * r, axis=-1)


def projected_hypercube(key, y, n, sample_size, h_dist_lim=15.0, **_):
    """softmax(L2-normalised U(-lim, lim) logits) (reference :85-102)."""
    B = y.shape[0]
    v = jax.random.uniform(
        key, (B, sample_size, n), minval=-h_dist_lim, maxval=h_dist_lim
    )
    v = v / jnp.linalg.norm(v, axis=-1, keepdims=True)
    return jax.nn.softmax(v, axis=-1)


def correct_cone(key, y, n, sample_size, **_):
    """Uniform simplex samples with the label coordinate swapped to be the
    max — points inside the correct decision cone (reference :104-128)."""
    B = y.shape[0]
    h = _exp_simplex(key, (B, sample_size, n))
    max_idx = jnp.argmax(h, axis=-1)  # (B, S)
    max_val = jnp.max(h, axis=-1)
    lab = y[:, None]  # (B, 1)
    lab_val = jnp.take_along_axis(h, jnp.broadcast_to(lab[..., None], (B, sample_size, 1)), axis=-1)[..., 0]
    h = h.at[jnp.arange(B)[:, None], jnp.arange(sample_size)[None, :], max_idx].set(lab_val)
    h = h.at[jnp.arange(B)[:, None], jnp.arange(sample_size)[None, :],
             jnp.broadcast_to(lab, (B, sample_size))].set(max_val)
    return h


def decision_boundary(key, y, n, sample_size, **_):
    """Samples exactly on the decision boundary of the label: the label
    probability ties the max wrong probability (reference :130-153)."""
    B = y.shape[0]
    zs = jax.random.exponential(key, (B, sample_size, n - 1))
    z1 = jnp.max(zs, axis=-1, keepdims=True)
    raw = jnp.concatenate([z1, zs], axis=-1)
    raw = raw / jnp.sum(raw, axis=-1, keepdims=True)
    # scatter: coord y <- raw[...,0]; other coords <- raw[...,1:]
    onehot = jax.nn.one_hot(y, n, dtype=bool)[:, None, :]  # (B,1,n)
    # order the n-1 wrong slots by original coordinate order
    idx_wrong = jnp.cumsum(~onehot, axis=-1) - 1  # index into raw[...,1:]
    h = jnp.where(
        jnp.broadcast_to(onehot, (B, sample_size, n)),
        raw[..., 0:1],
        jnp.take_along_axis(
            raw[..., 1:],
            jnp.broadcast_to(idx_wrong, (B, sample_size, n)).clip(0, n - 2),
            axis=-1,
        ),
    )
    return h


def trajectory_sampler(key, y, n, sample_size, *, model=None, params=None,
                       x=None, **_):
    """States along the solved ODE trajectory (reference TrajectorySampler,
    :156-166).  Needs the model closure; not mixable statically with the
    stateless samplers unless provided."""
    if model is None:
        raise ValueError("trajectory_sampler needs model/params/x")
    # raw HIDDEN states, not model.trajectory(): that applies output_fn,
    # which leaves the n_hidden sampling space for first_n/linear outputs.
    # scan mode: h is stop_gradient'ed by the caller, and a fixed trip
    # count needs no per-iteration predicate round trip to the host.
    ts = jnp.linspace(0.0, model.t_max, sample_size)
    traj = model.solve(params, x, ts, mode="scan").ys
    # (S, B, n) -> (B, S, n)
    return jnp.swapaxes(traj, 0, 1)


SAMPLERS: Dict[str, Callable] = {
    "UniformSimplexSampling": uniform_simplex,
    "BandSimplexSampling": band_simplex,
    "ProjectedBiasedHyperSphereSampling": projected_biased_hypersphere,
    "ProjectedHyperCubeSampling": projected_hypercube,
    "CorrectConeSampling": correct_cone,
    "DecisionBoundarySampling": decision_boundary,
    "TrajectorySampler": trajectory_sampler,
}


def composite_sample(
    key,
    sampler_names: Sequence[str],
    coefficients,  # (k,) traced array summing to 1
    y,
    n: int,
    sample_size: int,
    h_dist_lim: float = 15.0,
    **extra,
):
    """Mix k samplers: slot s belongs to sampler i iff
    cum_counts[i-1] <= s < cum_counts[i], counts = round-robin floor split
    matching the reference's floor(S*coeff) + remainder-to-last rule
    (sampling/sampler.py:181-192) — computed on traced coefficients so the
    mixture can change every epoch without recompilation.

    Returns (B, S, n).
    """
    k = len(sampler_names)
    coefficients = jnp.asarray(coefficients)
    counts = jnp.floor(sample_size * coefficients).astype(jnp.int32)
    # last sampler absorbs the remainder
    counts = counts.at[-1].set(sample_size - jnp.sum(counts[:-1]))
    edges = jnp.cumsum(counts)
    slot = jnp.arange(sample_size)
    owner = jnp.sum(slot[:, None] >= edges[None, :], axis=-1)  # (S,) in [0,k)

    keys = jax.random.split(key, k)
    draws = []
    for i, name in enumerate(sampler_names):
        draws.append(
            SAMPLERS[name](
                keys[i], y, n, sample_size, h_dist_lim=h_dist_lim, **extra
            )
        )
    stacked = jnp.stack(draws)  # (k, B, S, n)
    sel = jax.nn.one_hot(owner, k, axis=0)  # (k, S)
    return jnp.einsum("kbsn,ks->bsn", stacked, sel)
