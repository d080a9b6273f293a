"""From-scratch CROWN / IBP linear bound propagation for ReLU MLPs.

Replaces the reference's auto_LiRPA dependency for the graphs it actually
bounds (SURVEY.md §2.3): the 3-linear / 2-ReLU two-input dynamics twin
f(eta, x) = W3 relu(W2 relu(W1 eta + U x + b1) + b2) + b3
(CrownOrthoClassDynProjectSimplexLips.forward, dynamics/classification.py:306-312)
under an Linf perturbation of eta with x fixed
(certify_crown.py:108-139, BoundedModule/BoundedTensor/PerturbationLpNorm).

Everything is batched over grid cells (leading axis) — the backward passes
are einsums that map straight onto the matmul units, replacing the reference's
image-outer/grid-inner Python loop with one vectorised sweep.

Algorithm (standard CROWN):
  * the first pre-activation is exact-affine in eta: interval = center ± eps|W1|1;
  * deeper pre-activation bounds come from a backward pass from that layer;
  * ReLU relaxation: unstable neurons get the chord upper line
    u/(u-l)(z - l) and an adaptive lower line alpha z with
    alpha = 1[u >= |l|]; stable neurons propagate exactly;
  * concretisation over the eta box adds eps * |Lambda W1| 1.

`ibp_forward` gives pure interval bounds (used as a soundness cross-check:
CROWN must be at least as tight, and both must contain sampled values).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

__all__ = [
    "crown_mlp_bounds",
    "ibp_mlp_bounds",
    "relu_relaxation",
    "optimize_crown_alphas",
]


def relu_relaxation(l, u):
    """Per-neuron linear relaxation of ReLU on [l, u].

    Returns (a_up, b_up, a_lo, b_lo):  a_up z + b_up >= relu(z) >= a_lo z + b_lo.
    """
    unstable = (l < 0) & (u > 0)
    denom = jnp.where(unstable, u - l, 1.0)
    a_up = jnp.where(unstable, u / denom, (l >= 0).astype(l.dtype))
    b_up = jnp.where(unstable, -u * l / denom, 0.0)
    a_lo = jnp.where(
        unstable, (u >= -l).astype(l.dtype), (l >= 0).astype(l.dtype)
    )
    b_lo = jnp.zeros_like(b_up)
    return a_up, b_up, a_lo, b_lo


def _backward_from(
    layer_idx: int,
    Ws: Sequence[jax.Array],
    bs: Sequence[jax.Array],
    relax: Sequence[Tuple[jax.Array, ...]],
    eta0: jax.Array,
    eps: float,
    x_bias: jax.Array,
):
    """CROWN backward pass bounding z_{layer_idx} (1-based pre-activation).

    relax[j] holds the relaxation of relu(z_{j+1}) (i.e. for pre-activation
    bounds already computed), each element (a_up, b_up, a_lo, b_lo) with
    batch leading axis.

    Returns elementwise (lb, ub) of z_{layer_idx}, batched over cells.
    """
    W = Ws[layer_idx - 1]
    b = bs[layer_idx - 1]
    N = eta0.shape[0]
    out_dim = W.shape[0]

    if layer_idx == 1:
        # z1 itself: exact affine in eta
        center = jnp.einsum("oi,ni->no", W, eta0) + b + x_bias
        if jnp.ndim(eps) == 0:
            radius = eps * jnp.sum(jnp.abs(W), axis=-1)
        else:
            # per-dim box half-widths (N, n) — the BaB refinement's
            # anisotropic sub-boxes (verify/refine.py)
            radius = jnp.einsum("oi,ni->no", jnp.abs(W), eps)
        return center - radius, center + radius

    if layer_idx == 2 and out_dim >= Ws[0].shape[1]:
        # Fast path for the hot second-layer bound (the only absorption is
        # j=1, whose linear forms are still the STATIC weight W): the
        # sign-split collapses via the sum/difference identity
        #     W_pos u + W_neg l = [W (u + l) + |W| (u - l)] / 2
        # into two contractions whose intermediates are (N, k, in) with the
        # 128-wide ``in`` axis minor — instead of materialising the
        # sign-split broadcast (N, out, in) form (a 128x128-per-cell
        # device-memory intermediate) or an (N, in, k) tensor with a k~10
        # minor axis.
        a_up, b_up, a_lo, b_lo = relax[0]
        W1, b1 = Ws[0], bs[0]
        b1_row = b1 + x_bias  # (N, in)
        W_abs = jnp.abs(W)
        # relu upper/lower lines evaluated on the affine bias point
        u_vec = a_up * b1_row + b_up
        l_vec = a_lo * b1_row + b_lo
        s = (u_vec + l_vec) @ W.T
        d = (u_vec - l_vec) @ W_abs.T
        cu = b + 0.5 * (s + d)
        cl = b + 0.5 * (s - d)
        # (N, k, in): k = eta dim (second-minor, small), in = 128 (minor)
        W1t = W1.T  # (k, in)
        Tsum = (a_up + a_lo)[:, None, :] * W1t[None]
        Tdiff = (a_up - a_lo)[:, None, :] * W1t[None]
        S = jnp.einsum("oi,nki->nko", W, Tsum)
        D = jnp.einsum("oi,nki->nko", W_abs, Tdiff)
        Lu_t = 0.5 * (S + D)  # (N, k, out)
        Ll_t = 0.5 * (S - D)
        if jnp.ndim(eps) == 0:
            r_u = eps * jnp.sum(jnp.abs(Lu_t), 1)
            r_l = eps * jnp.sum(jnp.abs(Ll_t), 1)
        else:
            r_u = jnp.einsum("nko,nk->no", jnp.abs(Lu_t), eps)
            r_l = jnp.einsum("nko,nk->no", jnp.abs(Ll_t), eps)
        ub = jnp.einsum("nko,nk->no", Lu_t, eta0) + cu + r_u
        lb = jnp.einsum("nko,nk->no", Ll_t, eta0) + cl - r_l
        return lb, ub

    # upper/lower linear forms: out <= Lu @ a_{j} + cu  (a_j = relu(z_j))
    Lu = jnp.broadcast_to(W, (N,) + W.shape)
    Ll = Lu
    cu = jnp.broadcast_to(b, (N, out_dim))
    cl = cu

    for j in range(layer_idx - 1, 0, -1):
        a_up, b_up, a_lo, b_lo = relax[j - 1]
        # absorb relu(z_j): upper form uses up-line on positive coeffs
        Lu_pos = jnp.maximum(Lu, 0.0)
        Lu_neg = jnp.minimum(Lu, 0.0)
        cu = (
            cu
            + jnp.einsum("noi,ni->no", Lu_pos, b_up)
            + jnp.einsum("noi,ni->no", Lu_neg, b_lo)
        )
        Lu = Lu_pos * a_up[:, None, :] + Lu_neg * a_lo[:, None, :]
        Ll_pos = jnp.maximum(Ll, 0.0)
        Ll_neg = jnp.minimum(Ll, 0.0)
        cl = (
            cl
            + jnp.einsum("noi,ni->no", Ll_pos, b_lo)
            + jnp.einsum("noi,ni->no", Ll_neg, b_up)
        )
        Ll = Ll_pos * a_lo[:, None, :] + Ll_neg * a_up[:, None, :]
        # absorb affine z_j = W_j a_{j-1} + b_j (+ x_bias at j == 1)
        Wj, bj = Ws[j - 1], bs[j - 1]
        if j == 1:
            bj = bj + x_bias
        cu = cu + jnp.einsum("noi,ni->no", Lu, jnp.broadcast_to(bj, (N, bj.shape[-1])) if bj.ndim == 1 else bj)
        cl = cl + jnp.einsum("noi,ni->no", Ll, jnp.broadcast_to(bj, (N, bj.shape[-1])) if bj.ndim == 1 else bj)
        Lu = jnp.einsum("noi,ik->nok", Lu, Wj)
        Ll = jnp.einsum("noi,ik->nok", Ll, Wj)

    # concretise:  out <= Lu eta + cu  over the Linf box around eta0
    if jnp.ndim(eps) == 0:
        r_u = eps * jnp.sum(jnp.abs(Lu), -1)
        r_l = eps * jnp.sum(jnp.abs(Ll), -1)
    else:
        r_u = jnp.einsum("nok,nk->no", jnp.abs(Lu), eps)
        r_l = jnp.einsum("nok,nk->no", jnp.abs(Ll), eps)
    ub = jnp.einsum("nok,nk->no", Lu, eta0) + cu + r_u
    lb = jnp.einsum("nok,nk->no", Ll, eta0) + cl - r_l
    return lb, ub


def crown_mlp_bounds(
    Ws: Sequence[jax.Array],
    bs: Sequence[jax.Array],
    eta0: jax.Array,
    eps: float,
    x_bias: jax.Array,
    alphas: Optional[Sequence[jax.Array]] = None,
):
    """Elementwise output bounds of the ReLU MLP over the eta Linf box.

    Args:
      Ws/bs: dense layer stack [(m1,n), (m2,m1), ..., (out,mk)] — for the
        FI-ODE dynamics: [W1, W2, W3] with the U x contribution passed as
        ``x_bias`` added to layer 1's bias.
      eta0: (N, n) box centers (grid cells).
      eps:  box half-widths — a scalar (the uniform 1/T grid cell) or a
        per-row per-dim (N, n) array (the BaB refinement's anisotropic
        sub-boxes, verify/refine.py).
      x_bias: (m1,) or (N, m1) static-input contribution U @ x_feat.
      alphas: optional alpha-CROWN lower-slope overrides, one (N, m_j)
        array in [0, 1] per hidden layer.  Sound for ANY such value —
        relu(z) >= alpha*z holds globally for alpha in [0,1] — so these
        can be optimized against any objective without a soundness proof
        obligation (auto_LiRPA's 'CROWN-Optimized'/alpha-CROWN method;
        capability beyond the reference, which uses plain CROWN).
        Stable neurons keep their exact slopes regardless of the override.

    Returns: (lb, ub), each (N, out).
    """
    L = len(Ws)
    if x_bias.ndim == 1:
        x_bias = jnp.broadcast_to(x_bias, (eta0.shape[0], x_bias.shape[0]))
    relax = []
    for j in range(1, L):
        lj, uj = _backward_from(j, Ws, bs, relax, eta0, eps, x_bias)
        r = relu_relaxation(lj, uj)
        if alphas is not None:
            a_up, b_up, a_lo, b_lo = r
            unstable = (lj < 0) & (uj > 0)
            a_lo = jnp.where(
                unstable, jnp.clip(alphas[j - 1], 0.0, 1.0), a_lo
            )
            r = (a_up, b_up, a_lo, b_lo)
        relax.append(r)
    return _backward_from(L, Ws, bs, relax, eta0, eps, x_bias)


def optimize_crown_alphas(
    Ws: Sequence[jax.Array],
    bs: Sequence[jax.Array],
    eta0: jax.Array,
    eps: float,
    x_bias: jax.Array,
    loss_fn: Callable,
    iters: int = 8,
    lr: float = 0.25,
    select_fn: Optional[Callable] = None,
):
    """Projected-gradient alpha-CROWN: pick lower slopes that minimize
    ``loss_fn(lb, ub) -> (N,)`` per cell.

    Each gradient step re-runs the FULL ``crown_mlp_bounds`` chain with the
    current alphas — intermediate pre-activation bounds are re-derived
    through the alpha-modified earlier layers on every iterate, not frozen
    (a costlier-but-tighter variant of the usual fix-intermediates
    alpha-CROWN scheme; the differentiated graph is the whole bound chain
    per iteration).  Soundness holds for every iterate because every
    alpha in [0, 1] yields a valid lower relaxation (see crown_mlp_bounds),
    so no certification logic changes.  Returns the optimized ``alphas``
    list; pass it back into ``crown_mlp_bounds``.

    ``select_fn(lb, ub) -> (N,)``, when given, scores iterates for the
    per-cell best-tracking while ``loss_fn`` still drives the gradient.
    Use it when the gradient objective is a surrogate (e.g. bound width):
    minimizing a per-cell width SUM does not imply elementwise [lb, ub]
    containment, so a width-optimal iterate may be worse under the real
    certified quantity — scoring selection by the real quantity keeps the
    result never worse than the heuristic start (iterate 0) under the
    metric that matters, at one cheap forward evaluation per iterate (no
    extra term in the differentiated graph).

    Gradient path through the QP: when ``loss_fn`` composes these bounds
    with the barrier projection (verify/ibp_qp.py), gradients do NOT
    differentiate the bisection iterations — ``simplex_{cone,box}_project``
    carry closed-form active-set custom VJPs (ops/simplex_qp.py), which
    are exactly the KKT implicit-function derivative of the projection.
    Each alpha iteration therefore pays the bisection only as a forward
    evaluation; the backward is O(n) per row.  The projection is
    piecewise-linear in its inputs, so these gradients are exact on each
    active-set piece (zero curvature, not zero gradient).
    """
    if x_bias.ndim == 1:
        x_bias = jnp.broadcast_to(x_bias, (eta0.shape[0], x_bias.shape[0]))
    # initial slopes = the standard heuristic
    L = len(Ws)
    relax = []
    alphas0 = []
    for j in range(1, L):
        lj, uj = _backward_from(j, Ws, bs, relax, eta0, eps, x_bias)
        r = relu_relaxation(lj, uj)
        relax.append(r)
        alphas0.append(r[2])

    def per_cell_loss(alphas):
        lb, ub = crown_mlp_bounds(Ws, bs, eta0, eps, x_bias, alphas)
        return loss_fn(lb, ub)  # (N,)

    def per_cell_score(alphas):
        if select_fn is None:
            return per_cell_loss(alphas)
        lb, ub = crown_mlp_bounds(Ws, bs, eta0, eps, x_bias, alphas)
        return select_fn(lb, ub)  # (N,)

    grad_fn = jax.grad(lambda a: jnp.sum(per_cell_loss(a)))

    # track the best iterate PER CELL so the result is never worse than
    # the heuristic start (signed GD on a nonconvex objective can
    # overshoot; every iterate is sound, so keeping the best is free)
    best = list(alphas0)
    best_loss = per_cell_score(alphas0)
    alphas = alphas0
    for i in range(iters):  # unrolled under jit; iters is small and static
        g = grad_fn(alphas)
        step = lr / (1.0 + 0.5 * i)  # decaying signed steps: bounded domain
        alphas = [
            jnp.clip(a - step * jnp.sign(gi), 0.0, 1.0)
            for a, gi in zip(alphas, g)
        ]
        cur = per_cell_score(alphas)
        better = cur < best_loss
        best = [
            jnp.where(better[:, None], a, b) for a, b in zip(alphas, best)
        ]
        best_loss = jnp.where(better, cur, best_loss)
    return best


def ibp_mlp_bounds(Ws, bs, eta0, eps, x_bias):
    """Pure interval propagation (looser; soundness cross-check)."""
    l = eta0 - eps
    u = eta0 + eps
    for i, (W, b) in enumerate(zip(Ws, bs)):
        c = 0.5 * (l + u)
        r = 0.5 * (u - l)
        cz = jnp.einsum("oi,ni->no", W, c) + b
        rz = jnp.einsum("oi,ni->no", jnp.abs(W), r)
        if i == 0:
            cz = cz + x_bias
        l, u = cz - rz, cz + rz
        if i < len(Ws) - 1:
            l, u = jax.nn.relu(l), jax.nn.relu(u)
    return l, u
