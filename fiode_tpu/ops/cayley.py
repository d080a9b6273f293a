"""Cayley-transform orthogonal parameterisations (dense + FFT convolution).

The reference's Lipschitz-1 layers come from its `libs/ortho_conv` submodule
(a fork of locuslab/orthogonal-convolutions; see FI-ODE README.md:69 and
dynamics/classification.py:69-75).  This module provides the same capability
surface, built for an accelerator:

  * ``cayley(W)``        — dense Cayley transform producing an orthogonal
                           (or semi-orthogonal) matrix from an unconstrained
                           weight, used both inside layers and to densify
                           trained weights for certification
                           (reference dynamics/classification.py:281-294).
  * ``cayley_linear_kernel`` — the full CayleyLinear weight map
                           W -> cayley(alpha * W / ||W||).
  * ``cayley_conv_kernel`` / ``cayley_conv_apply`` — orthogonal convolution in
                           the Fourier domain: per-frequency Cayley transform
                           of the FFT'd kernel, applied by batched complex
                           matmuls (real 2x2-block GEMMs via XLA's complex
                           lowering).

All functions are pure and differentiable; orthogonality is exact up to the
linear solve tolerance.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

__all__ = [
    "cayley",
    "cayley_linear_kernel",
    "cayley_conv_apply",
    "cayley_conv_kernel",
    "apply_freq_matrices",
    "groupsort2",
]


def cayley(W: jax.Array) -> jax.Array:
    """Cayley transform of a (co, ci) real or complex matrix.

    For square W: skew-symmetrise A = W - W^H and return
    (I - A)(I + A)^{-1} which is orthogonal/unitary.

    For rectangular W (co > ci, "tall"): follow the semi-orthogonal
    construction of orthogonal-convolutions — split W into a square block U
    (ci x ci) and remainder V ((co-ci) x ci), form A = U - U^H + V^H V, and
    return the stacked [ (I+A)^{-1}(I-A) ; -2 V (I+A)^{-1} ] whose columns are
    orthonormal.  For co < ci the transpose construction is used.
    """
    if W.ndim == 2:
        W = W[None]
        squeeze = True
    else:
        squeeze = False

    _, co, ci = W.shape
    transposed = co < ci
    if transposed:
        W = jnp.conjugate(jnp.swapaxes(W, -2, -1))
        co, ci = ci, co

    U = W[:, :ci, :]
    V = W[:, ci:, :]
    eye = jnp.eye(ci, dtype=W.dtype)
    UH = jnp.conjugate(jnp.swapaxes(U, -2, -1))
    VH = jnp.conjugate(jnp.swapaxes(V, -2, -1))
    A = U - UH + VH @ V
    # one factorization serves both blocks:
    #   (I+A)^{-1}(I-A) = 2(I+A)^{-1} - I
    iplusA = eye + A
    X = jnp.linalg.solve(iplusA, eye)  # (I + A)^{-1}
    top = 2.0 * X - eye
    bottom = -2.0 * V @ X
    Q = jnp.concatenate([top, bottom], axis=-2)

    if transposed:
        Q = jnp.conjugate(jnp.swapaxes(Q, -2, -1))
    if squeeze:
        Q = Q[0]
    return Q


def cayley_linear_kernel(W: jax.Array, alpha: jax.Array) -> jax.Array:
    """The CayleyLinear weight map: cayley(alpha * W / ||W||_F).

    Matches the densification used for certification in the reference
    (dynamics/classification.py:282-293).
    """
    return cayley(alpha * W / jnp.linalg.norm(W))


def _fft_kernel(weight: jax.Array, n: int) -> jax.Array:
    """2-D real FFT of a (co, ci, k, k) conv kernel zero-padded to (n, n).

    Returns shape (n * (n//2+1), co, ci) complex — one small matrix per
    retained frequency.
    """
    co, ci, k, _ = weight.shape
    # circular convolution kernel: place and shift so the center tap is at 0
    kernel = jnp.zeros((co, ci, n, n), dtype=weight.dtype)
    kernel = kernel.at[:, :, :k, :k].set(weight)
    shift = -(k // 2)
    kernel = jnp.roll(kernel, (shift, shift), axis=(-2, -1))
    wfft = jnp.fft.rfft2(kernel)  # (co, ci, n, n//2+1)
    wfft = jnp.transpose(wfft, (2, 3, 0, 1)).reshape(-1, co, ci)
    return jnp.conjugate(wfft)


@functools.lru_cache(maxsize=16)
def _dft2_mats(n: int):
    """Dense 2-D rDFT matrices for DFT-as-matmul (see cayley_conv_apply).

    Returns (D2, M2): ``D2`` (F, n*n) maps flattened spatial pixels to the
    F = n*(n//2+1) retained rfft2 frequencies; ``M2`` (n*n, F) maps them back,
    with the Hermitian column weights (2 on 0<g<n/2) folded in so that
    ``y = Re(M2 @ Y)`` equals ``irfft2``.  Built from the 1-D factors
    (_dft1_mats) so both paths share one source of truth for the weights.
    """
    import numpy as np

    nf = n // 2 + 1
    D, Dh, Dinv, Einv = _dft1_mats(n)
    D2 = np.einsum("fi,gj->fgij", D, Dh).reshape(n * nf, n * n)
    M2 = np.einsum("af,bg->abfg", Dinv, Einv).reshape(n * n, n * nf)
    return D2.astype(np.complex64), M2.astype(np.complex64)


@functools.lru_cache(maxsize=16)
def _dft1_mats(n: int):
    """1-D DFT matrices for the factorised (rows-then-columns) transform.

    Returns (D, Dh, Dinv, Einv):
      ``Dh``  (nf, n)  rfft along the last spatial axis,
      ``D``   (n, n)   full DFT along the other axis,
      ``Einv`` (n, nf) inverse along the rfft axis with the Hermitian
               doubling weights folded in (so only Re(.) is needed),
      ``Dinv`` (n, n)  inverse along the full axis.
    """
    import numpy as np

    k = np.arange(n)
    D = np.exp(-2j * np.pi * np.outer(k, k) / n)
    nf = n // 2 + 1
    Dh = D[:nf]
    w = np.ones(nf)
    w[1 : (n + 1) // 2] = 2.0
    Dinv = np.conj(D) / n
    Einv = (np.conj(Dh).T * w[None, :]) / n
    # complex128: _dft2_mats composes these into products, so precision is
    # cast away only at the jnp.asarray boundary of each consumer
    return D, Dh, Dinv, Einv


# Above this spatial size the dense DFT matrices (O(n^4) entries) stop paying
# for themselves and the FFT path is used instead.
_DFT_MATMUL_MAX_N = 64


def cayley_conv_apply(
    x: jax.Array,
    weight: jax.Array,
    alpha: jax.Array,
    *,
    impl: str = "auto",
    precision=None,
) -> jax.Array:
    """Orthogonal (circular) convolution via per-frequency Cayley transform.

    Args:
      x:      (batch, ci, n, n) input in NCHW (n must cover the kernel).
      weight: (co, ci, k, k) unconstrained kernel.
      alpha:  scalar learnable norm target.
      impl:   'dft' (dense 2-D DFT-as-matmul), 'dft1' (factorised
              rows-then-columns 1-D DFT matmuls — fewer FLOPs, see
              apply_freq_matrices), 'fft' (jnp.fft path), or 'auto' (dft
              for n <= 64).
      precision: lax.Precision for the dft matmuls (None = backend default,
              TF32 on the GPU; pass HIGHEST for certification-grade
              accuracy).

    Returns:
      (batch, co, n, n); the semi-orthogonal per-frequency matrix has
      orthonormal columns, so the map is an isometry (Lipschitz 1).

    The default path evaluates rfft2/irfft2 as ONE dense matmul each
    against precomputed (F, n*n) DFT matrices — three large GEMMs per
    layer.  That choice was measured on the earlier accelerator, whose FFT
    was slow and imprecise at these sizes; it has not been re-measured
    against cuFFT on the H100.
    """
    n = x.shape[-1]
    Q = cayley_conv_kernel(weight, alpha, n)
    return apply_freq_matrices(x, Q, impl=impl, precision=precision)


def cayley_conv_kernel(weight: jax.Array, alpha: jax.Array, n: int) -> jax.Array:
    """Per-frequency semi-orthogonal matrices of a CayleyConv at spatial
    size n: cayley(alpha * rfft2(kernel) / ||.||), shape (F, co, ci).

    Exposed separately so trained kernels can be densified ONCE for
    repeated inference (the ortho_conv fork's test-model variants cache
    exactly this; reference models.py:154-165)."""
    wfft = _fft_kernel(weight, n)  # (F, co, ci)
    scale = alpha / jnp.linalg.norm(wfft)
    return cayley(scale * wfft)


def apply_freq_matrices(
    x: jax.Array, Q: jax.Array, *, impl: str = "auto", precision=None
) -> jax.Array:
    """Apply per-frequency (F, co, ci) matrices to NCHW ``x`` (circular
    convolution in the Fourier domain)."""
    batch, ci, n, _ = x.shape
    co = Q.shape[-2]
    nf = n // 2 + 1
    F = n * nf
    if impl == "auto":
        impl = "dft" if n <= _DFT_MATMUL_MAX_N else "fft"
    if impl not in ("dft", "dft1", "fft"):
        raise ValueError(
            f"impl must be 'auto', 'dft', 'dft1' or 'fft', got {impl!r}"
        )

    if impl == "dft1":
        # Factorised rows-then-columns transform: the dense 2-D DFT matrix
        # costs O(n^2) MACs per output frequency; splitting it into two 1-D
        # passes costs O(n), a ~7x FLOP cut on 32x32 layers.  Every pass is
        # a dot_general whose natural output order feeds the next one, so no
        # large intermediate transposes are emitted.  Its extra memory
        # round trips and 32-deep contractions lost to the dense path's
        # large GEMMs on the earlier accelerator, so 'auto' keeps 'dft';
        # this path wins where n is large enough that O(n^4) DFT matrices
        # dominate.
        D, Dh, Dinv, Einv = map(jnp.asarray, _dft1_mats(n))

        def dg(a, b, contract, batch=((), ())):
            return jax.lax.dot_general(
                a, b, (contract, batch), precision=precision
            )

        # g-pass rfft: (nf, n) . (B, ci, n, n) contract last -> (nf, B, ci, n)
        t1r = dg(Dh.real, x, (((1,), (3,))))
        t1i = dg(Dh.imag, x, (((1,), (3,))))
        # f-pass full DFT: (n, n) . (nf, B, ci, n) contract last
        # -> (f, nf, B, ci); (f, g) flatten to the F axis with no transpose
        t2r = dg(D.real, t1r, (((1,), (3,)))) - dg(D.imag, t1i, (((1,), (3,))))
        t2i = dg(D.real, t1i, (((1,), (3,)))) + dg(D.imag, t1r, (((1,), (3,))))
        xf = jax.lax.complex(t2r, t2i).reshape(F, batch, ci)
        # per-frequency mixing: (F, co, ci) x (F, batch, ci) -> (F, co, batch)
        yf = dg(Q, xf, ((2,), (2,)), ((0,), (0,)))
        yf = yf.reshape(n, nf, co, batch)
        # inverse g-pass with Hermitian weights folded: (n, nf) . (f, nf, co,
        # B) contract nf -> (b_pix, f, co, B)
        s1r = dg(Einv.real, yf.real, (((1,), (1,)))) - dg(
            Einv.imag, yf.imag, (((1,), (1,)))
        )
        s1i = dg(Einv.real, yf.imag, (((1,), (1,)))) + dg(
            Einv.imag, yf.real, (((1,), (1,)))
        )
        # inverse f-pass, real part only: (n, n) . (p, n, co, B) contract f
        # -> (a, p, co, B)
        yr = dg(Dinv.real, s1r, (((1,), (1,)))) - dg(
            Dinv.imag, s1i, (((1,), (1,)))
        )
        return jnp.transpose(yr, (3, 2, 0, 1))

    if impl == "dft":
        D2, M2 = map(jnp.asarray, _dft2_mats(n))
        # all layout work is folded into dot_general operands (XLA picks the
        # layouts); the only explicit transpose is the final NCHW restore
        xp = x.reshape(batch, ci, n * n)
        # (F, p) . (batch, ci, p) -> (F, batch, ci)
        xfr = jax.lax.dot_general(
            D2.real, xp, (((1,), (2,)), ((), ())), precision=precision
        )
        xfi = jax.lax.dot_general(
            D2.imag, xp, (((1,), (2,)), ((), ())), precision=precision
        )
        xf = jax.lax.complex(xfr, xfi)
        # (F, co, ci) x (F, batch, ci): batch F, contract ci -> (F, co, batch)
        yf = jax.lax.dot_general(
            Q, xf, (((2,), (2,)), ((0,), (0,))), precision=precision
        )
        # y = Re(M2 @ Yf):  (p, F) . (F, co, batch) -> (p, co, batch)
        yr = jax.lax.dot_general(
            M2.real, yf.real, (((1,), (0,)), ((), ())), precision=precision
        ) - jax.lax.dot_general(
            M2.imag, yf.imag, (((1,), (0,)), ((), ())), precision=precision
        )
        return jnp.transpose(yr, (2, 1, 0)).reshape(batch, co, n, n)

    xfft = jnp.fft.rfft2(x)  # (batch, ci, n, n//2+1)
    xfft = jnp.transpose(xfft, (2, 3, 1, 0)).reshape(F, ci, batch)
    yfft = Q @ xfft  # (F, co, batch)
    yfft = yfft.reshape(n, nf, co, batch)
    yfft = jnp.transpose(yfft, (3, 2, 0, 1))  # (batch, co, n, n//2+1)
    y = jnp.fft.irfft2(yfft, s=(n, n))
    return y


def groupsort2(x: jax.Array, axis: int = -1) -> jax.Array:
    """GroupSort with group size 2 (MaxMin) along ``axis``.

    A gradient-norm-preserving activation (the reference's GroupSort from
    libs/ortho_conv, used in Cayley backbones; models.py:49-54).
    """
    n = x.shape[axis]
    assert n % 2 == 0, "groupsort2 needs an even dimension"
    x2 = jnp.moveaxis(x, axis, -1)
    shape = x2.shape
    x2 = x2.reshape(*shape[:-1], n // 2, 2)
    lo = jnp.min(x2, axis=-1)
    hi = jnp.max(x2, axis=-1)
    out = jnp.stack([lo, hi], axis=-1).reshape(shape)
    return jnp.moveaxis(out, -1, axis)
