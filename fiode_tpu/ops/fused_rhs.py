"""Fused ODE right-hand side: one Pallas kernel (Triton route) per RHS
evaluation on the GPU.

The hot loop of every forward solve / attack / certification sweep is
f(h) = QP-project(W3 relu(W2 relu(W1 h + xc) + b2) + b3) evaluated NFE x
batch times (SURVEY.md §2.6).  Unfused, XLA issues each evaluation as
several launches (three small matmuls, the barrier, and the 30-iteration
bisection loop).  This kernel runs the whole evaluation in one launch: one
program per block of rows, the weights (W2 is 128 x 128 fp32, 64 KB) in
shared memory, the barrier and bisection in registers.

Layout: the simplex dimension n (10) is padded to ``pad_width(n)`` (16, the
smallest operand width a Triton dot takes) and the MLP width to a power of
two; padded lanes are masked out of the projection.  Weights are transposed
and padded once per solve (``pack_rhs_params``), and the input injection
xc = U x_feat + b1 + bU is h-independent and computed once per solve too
(the reference recomputes U_x(x) every RHS call,
dynamics/classification.py:97).  The row count must be a multiple of the
block; ``fused_rhs`` pads ragged batches, and solves pad once up front.

The kernel is compiled through Triton for CUDA and runs in the Pallas
interpreter on the CPU (the tests); the choice is made per platform when
the program is lowered (``lax.platform_dependent``), and any other
platform fails to lower.

Differentiation: ``fused_rhs`` carries a custom VJP whose backward is the
VJP of the plain-jnp ``rhs_reference`` — the same math, op by op, on every
backend.  Gradients flow through solves (training, attacks) only backward,
so one forward kernel serves every workload.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = [
    "FusedRhsParams", "pad_width", "pack_rhs_params", "fused_rhs",
    "rhs_reference", "masked_cone_project", "ambient_dot_precision",
]

BLOCK = 128  # rows per program


def pad_width(k: int) -> int:
    """Padded lane width for a dimension of size ``k``: a power of two, at
    least 16 (the smallest matmul operand dimension Triton accepts)."""
    return max(16, 1 << (k - 1).bit_length())


class FusedRhsParams(NamedTuple):
    W1t: jax.Array  # (NP, MP)  W1 transposed: rows n (padded), cols mlp
    W2t: jax.Array  # (MP, MP)
    W3t: jax.Array  # (MP, NP)
    b2: jax.Array  # (MP,)
    b3: jax.Array  # (NP,)


def pack_rhs_params(W1, W2, W3, b2, b3) -> FusedRhsParams:
    """Transpose and zero-pad dense dynamics weights ((out, in) layout)."""
    mlp, n = W1.shape
    NP, MP = pad_width(n), pad_width(mlp)

    def pad2(W, r, c):
        return jnp.zeros((r, c), W.dtype).at[: W.shape[0], : W.shape[1]].set(W)

    def pad1(b, r):
        return jnp.zeros((r,), b.dtype).at[: b.shape[0]].set(b)

    return FusedRhsParams(
        pad2(W1.T, NP, MP), pad2(W2.T, MP, MP), pad2(W3.T, MP, NP),
        pad1(b2, MP), pad1(b3, NP),
    )


def _masked_bisect(lower, nominal, mask, qp_iters):
    """Bisection for mu on masked lanes; padded lanes are ignored."""
    mu_hi = jnp.max(
        jnp.where(mask, nominal - lower, -1e30), axis=-1, keepdims=True
    )
    mu_lo = jnp.min(jnp.where(mask, nominal, 1e30), axis=-1, keepdims=True)

    def body(_, carry):
        lo, hi = carry
        mid = 0.5 * (lo + hi)
        v = jnp.maximum(nominal - mid, lower)
        s = jnp.sum(jnp.where(mask, v, 0.0), axis=-1, keepdims=True)
        lo = jnp.where(s > 0, mid, lo)
        hi = jnp.where(s < 0, mid, hi)
        return lo, hi

    lo, hi = jax.lax.fori_loop(0, qp_iters, body, (mu_lo, mu_hi))
    return 0.5 * (lo + hi)


@functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
def masked_cone_project(lower, nominal, mask, qp_iters=30):
    """simplex_cone_project restricted to masked lanes (padded tiles),
    with the same closed-form active-set VJP as ops/simplex_qp."""
    mu = _masked_bisect(lower, nominal, mask, qp_iters)
    return jnp.where(mask, jnp.maximum(nominal - mu, lower), 0.0)


def _mcp_fwd(lower, nominal, mask, qp_iters):
    mu = _masked_bisect(lower, nominal, mask, qp_iters)
    v = jnp.where(mask, jnp.maximum(nominal - mu, lower), 0.0)
    return v, (mu, lower, nominal, mask)


def _mcp_bwd(qp_iters, res, g):
    mu, lower, nominal, mask = res
    active = ((nominal - mu) < lower) & mask
    free = mask & ~active
    g = jnp.where(mask, g, 0.0)
    n_free = jnp.maximum(
        jnp.sum(free, axis=-1, keepdims=True).astype(g.dtype), 1.0
    )
    corr = jnp.sum(jnp.where(free, g, 0.0), axis=-1, keepdims=True) / n_free
    d_nominal = jnp.where(free, g - corr, 0.0)
    d_lower = jnp.where(active, g - corr, 0.0)
    return d_lower, d_nominal, None


masked_cone_project.defvjp(_mcp_fwd, _mcp_bwd)


def _barrier(h, f_tilde, alpha_1, sigma_1, alpha_2, scale_nominal):
    """Barrier lower bound, and the optional sigmoid rescaling of f~."""
    lower = -alpha_1 * (jnp.exp(sigma_1 * h) - 1.0)
    if scale_nominal:
        upper = alpha_2 * (1.0 - h)
        f_tilde = (upper - lower) / (1.0 + jnp.exp(-f_tilde)) + lower
    return lower, f_tilde


def ambient_dot_precision():
    """The ambient ``jax.default_matmul_precision`` as an explicit dot
    precision: the kernel's matmuls follow the same policy as XLA's (TF32
    at the default on the GPU, IEEE fp32 under 'highest'/'float32')."""
    prec = jax.config.jax_default_matmul_precision
    if prec in ("highest", "float32"):
        return jax.lax.Precision.HIGHEST
    return jax.lax.Precision.DEFAULT


def rhs_reference(h_pad, xc_pad, p: FusedRhsParams, n: int, alpha_1, sigma_1,
                  alpha_2, scale_nominal: bool, qp_iters: int = 30):
    """Plain-jnp RHS on padded tiles (the kernel's oracle and VJP source)."""
    mask = (jnp.arange(h_pad.shape[-1]) < n)[None, :]
    z1 = jax.nn.relu(jnp.dot(h_pad, p.W1t) + xc_pad)
    z2 = jax.nn.relu(jnp.dot(z1, p.W2t) + p.b2)
    f_tilde = jnp.dot(z2, p.W3t) + p.b3
    lower, f_tilde = _barrier(h_pad, f_tilde, alpha_1, sigma_1, alpha_2,
                              scale_nominal)
    return masked_cone_project(lower, f_tilde, mask, qp_iters)


def _kernel(h_ref, xc_ref, w1_ref, w2_ref, w3_ref, b2_ref, b3_ref, out_ref,
            *, n, alpha_1, sigma_1, alpha_2, scale_nominal, qp_iters,
            precision):
    h = h_ref[...]
    dot = functools.partial(jnp.dot, precision=precision,
                            preferred_element_type=jnp.float32)
    z1 = jnp.maximum(dot(h, w1_ref[...]) + xc_ref[...], 0.0)
    z2 = jnp.maximum(dot(z1, w2_ref[...]) + b2_ref[...][None, :], 0.0)
    f_tilde = dot(z2, w3_ref[...]) + b3_ref[...][None, :]
    lower, f_tilde = _barrier(h, f_tilde, alpha_1, sigma_1, alpha_2,
                              scale_nominal)
    mask = jax.lax.broadcasted_iota(jnp.int32, h.shape, 1) < n
    mu = _masked_bisect(lower, f_tilde, mask, qp_iters)
    out_ref[...] = jnp.where(mask, jnp.maximum(f_tilde - mu, lower), 0.0)


def _pallas_forward(h_pad, xc_pad, p: FusedRhsParams, n, alpha_1, sigma_1,
                    alpha_2, scale_nominal, qp_iters, block, *, interpret):
    import jax.experimental.pallas as pl
    from jax.experimental.pallas import triton as pl_triton

    N, NP = h_pad.shape
    MP = xc_pad.shape[1]
    kernel = functools.partial(
        _kernel, n=n, alpha_1=alpha_1, sigma_1=sigma_1, alpha_2=alpha_2,
        scale_nominal=scale_nominal, qp_iters=qp_iters,
        precision=ambient_dot_precision(),
    )
    rows = lambda i: (i, 0)
    whole = lambda i: (0, 0)
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((N, NP), h_pad.dtype),
        grid=(N // block,),
        in_specs=[
            pl.BlockSpec((block, NP), rows),
            pl.BlockSpec((block, MP), rows),
            pl.BlockSpec((NP, MP), whole),
            pl.BlockSpec((MP, MP), whole),
            pl.BlockSpec((MP, NP), whole),
            pl.BlockSpec((MP,), lambda i: (0,)),
            pl.BlockSpec((NP,), lambda i: (0,)),
        ],
        out_specs=pl.BlockSpec((block, NP), rows),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="fused_rhs",
    )(h_pad, xc_pad, p.W1t, p.W2t, p.W3t, p.b2, p.b3)


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4, 5, 6, 7, 8, 9))
def fused_rhs(h_pad, xc_pad, p: FusedRhsParams, n: int, alpha_1, sigma_1,
              alpha_2, scale_nominal: bool = False, qp_iters: int = 30,
              block: int = BLOCK):
    """Fused RHS on padded tiles: (N, NP) x (N, MP) x params -> (N, NP).

    Rows are padded to a multiple of ``block`` when they are not one."""
    N = h_pad.shape[0]
    pad = -N % block
    if pad:
        h_pad = jnp.pad(h_pad, ((0, pad), (0, 0)))
        xc_pad = jnp.pad(xc_pad, ((0, pad), (0, 0)))
    forward = functools.partial(
        _pallas_forward, n=n, alpha_1=alpha_1, sigma_1=sigma_1,
        alpha_2=alpha_2, scale_nominal=scale_nominal, qp_iters=qp_iters,
        block=block,
    )
    out = jax.lax.platform_dependent(
        h_pad, xc_pad, p,
        cpu=functools.partial(forward, interpret=True),
        cuda=functools.partial(forward, interpret=False),
    )
    return out[:N]


def _fused_fwd(h_pad, xc_pad, p, n, a1, s1, a2, scale_nominal, qp_iters,
               block):
    out = fused_rhs(h_pad, xc_pad, p, n, a1, s1, a2, scale_nominal, qp_iters,
                    block)
    return out, (h_pad, xc_pad, p)


def _fused_bwd(n, a1, s1, a2, scale_nominal, qp_iters, block, res, g):
    h_pad, xc_pad, p = res
    _, vjp = jax.vjp(
        lambda h, xc, pp: rhs_reference(
            h, xc, pp, n, a1, s1, a2, scale_nominal, qp_iters
        ),
        h_pad, xc_pad, p,
    )
    return vjp(g)


fused_rhs.defvjp(_fused_fwd, _fused_bwd)
