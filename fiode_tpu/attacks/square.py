"""Square Attack — gradient-free random search (part of AutoAttack standard).

Implements Andriushchenko et al. 2020 for Linf and L2:
  * Linf: at each query, resample one random square window of the current
    perturbation to +/- eps per channel; accept iff the margin loss drops;
  * L2: resample a square window with the paper's "bump" (eta) construction
    and renormalise to the eps sphere; accept on improvement;
  * square side schedule: fraction p of pixels, halved at the standard
    iteration fractions [10, 50, 200, 500, 1000, 2000, 4000, 8000]/10000.

Stateless model queries only (no gradients) — the attack that catches
gradient-masking defenses in the standard suite (eval_autoattack.py:51).
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["square_attack", "square_attack_chunked", "make_square_segment"]


def _margin_loss(logits, y):
    """CW margin: z_y - max_{j!=y} z_j  (attack succeeds when < 0)."""
    B, n = logits.shape
    z_y = logits[jnp.arange(B), y]
    wrong = jnp.where(jax.nn.one_hot(y, n, dtype=bool), -jnp.inf, logits)
    return z_y - jnp.max(wrong, axis=-1)


def _p_schedule(i, n_iters, p_init):
    frac = i / n_iters
    thresholds = jnp.asarray(
        [0.001, 0.005, 0.02, 0.05, 0.1, 0.2, 0.4, 0.8], jnp.float32
    )
    halvings = jnp.sum(frac >= thresholds)
    return p_init * 0.5 ** halvings.astype(jnp.float32)


def _square_init(logits_fn, x, y, key, *, eps, norm):
    """Random init (stripes for Linf, eps-sphere gaussian for L2) and its
    margin loss."""
    B = x.shape[0]
    key, k0 = jax.random.split(key)
    if norm == "Linf":
        # vertical stripes init (paper): per-column random sign
        s = jax.random.choice(
            k0, jnp.asarray([-eps, eps]), (B, x.shape[1], 1, x.shape[3])
        )
        xa = jnp.clip(x + jnp.broadcast_to(s, x.shape), 0, 1)
    else:
        d = jax.random.normal(k0, x.shape)
        nrm = jnp.linalg.norm(d.reshape(B, -1), axis=-1).reshape(B, 1, 1, 1)
        xa = jnp.clip(x + d / jnp.maximum(nrm, 1e-12) * eps, 0, 1)
    return xa, _margin_loss(logits_fn(xa), y), key


def _square_body(logits_fn, x, y, *, eps, norm, n_queries, p_init):
    """One random-search query step (i = absolute query index)."""
    B, C, H, W = x.shape

    def body(i, carry):
        xa, loss, key = carry
        key, ks, kp, kv = jax.random.split(key, 4)
        p = _p_schedule(i, n_queries, p_init)
        s = jnp.maximum(
            jnp.round(jnp.sqrt(p * H * W)).astype(jnp.int32), 1
        )
        s = jnp.minimum(s, min(H, W))
        # uniform over {0..H-s} (paper r0 ~ U({0..h-s})): sampling [0, H)
        # then clamping would give the bottom/right edge position s times
        # the interior probability — nearly deterministic placement early
        # in the schedule when s ~ H
        u_r = jax.random.uniform(ks, (B,))
        u_c = jax.random.uniform(kp, (B,))
        r0 = jnp.floor(u_r * (H - s + 1).astype(u_r.dtype)).astype(jnp.int32)
        c0 = jnp.floor(u_c * (W - s + 1).astype(u_c.dtype)).astype(jnp.int32)
        r0 = jnp.minimum(r0, H - s)  # guard the u == 1.0 corner
        c0 = jnp.minimum(c0, W - s)
        rows = jnp.arange(H)[None, :]
        cols = jnp.arange(W)[None, :]
        rmask = (rows >= r0[:, None]) & (rows < (r0 + s)[:, None])  # (B,H)
        cmask = (cols >= c0[:, None]) & (cols < (c0 + s)[:, None])  # (B,W)
        win = (rmask[:, None, :, None] & cmask[:, None, None, :])  # (B,1,H,W)

        if norm == "Linf":
            v = jax.random.choice(kv, jnp.asarray([-eps, eps]), (B, C, 1, 1))
            cand = jnp.where(win, jnp.clip(x + v, 0, 1), xa)
            cand = jnp.clip(cand, x - eps, x + eps)
            cand = jnp.clip(cand, 0, 1)
        else:
            # L2: fresh gaussian bump in the window, renormalised so the
            # total perturbation stays on the eps-sphere
            d_cur = xa - x
            bump = jax.random.normal(kv, x.shape) * win
            d_new = jnp.where(win, bump, d_cur)
            nrm = jnp.linalg.norm(d_new.reshape(B, -1), axis=-1)
            d_new = d_new / jnp.maximum(nrm, 1e-12).reshape(B, 1, 1, 1) * eps
            cand = jnp.clip(x + d_new, 0, 1)

        cand_loss = _margin_loss(logits_fn(cand), y)
        better = cand_loss < loss
        xa = jnp.where(better.reshape(B, 1, 1, 1), cand, xa)
        loss = jnp.minimum(loss, cand_loss)
        return xa, loss, key

    return body


def make_square_segment(
    logits_fn: Callable,
    *,
    eps: float,
    norm: str = "L2",
    n_queries: int = 5000,
    p_init: float = 0.8,
    segment: int = 500,
):
    """Host-chunked square attack: (init_fn, seg_fn) to be jitted once and
    invoked ``ceil(n_queries/segment)`` times.

    One device program per ~500 queries instead of a single
    n_queries-iteration ``fori_loop`` (each query is a full ODE solve), so
    no single execution runs for thousands of solves.
    ``seg_fn(x, y, xa, loss, key, i0)`` resumes
    from absolute query index ``i0`` so the side-length schedule
    (fractions of n_queries) is unchanged; chaining segments carries
    exactly the fori_loop carry (xa, loss, key), so the paths are
    bit-identical under identical compilation (verified on CPU; see
    square_attack_chunked for the scheduling caveat).
    """

    def init_fn(x, y, key):
        return _square_init(logits_fn, x, y, key, eps=eps, norm=norm)

    def seg_fn(x, y, xa, loss, key, i0):
        body = _square_body(
            logits_fn, x, y, eps=eps, norm=norm, n_queries=n_queries,
            p_init=p_init,
        )
        xa, loss, key = jax.lax.fori_loop(
            0, segment,
            lambda j, c: body(i0 + j, c),
            (xa, loss, key),
        )
        return xa, loss, key

    return init_fn, seg_fn


def square_attack(
    logits_fn: Callable,
    x: jax.Array,
    y: jax.Array,
    key: jax.Array,
    *,
    eps: float,
    norm: str = "L2",
    n_queries: int = 5000,
    p_init: float = 0.8,
):
    """Returns (x_adv, success_mask) — single-program path (jit the whole
    call).  ``square_attack_chunked`` runs the same queries in segments."""
    xa, loss, key = _square_init(logits_fn, x, y, key, eps=eps, norm=norm)
    body = _square_body(
        logits_fn, x, y, eps=eps, norm=norm, n_queries=n_queries,
        p_init=p_init,
    )
    xa, loss, _ = jax.lax.fori_loop(0, n_queries, body, (xa, loss, key))
    return xa, loss < 0


def square_attack_chunked(
    logits_fn: Callable,
    *,
    eps: float,
    norm: str = "L2",
    n_queries: int = 5000,
    p_init: float = 0.8,
    segment: int = 500,
):
    """Segmented square attack: returns ``fn(x, y, key) -> (xa, success)``
    that chains jitted ~``segment``-query programs from the host, covering
    absolute query indices 0..n_queries-1 exactly — the chained carry IS
    the fori_loop carry, and tests/test_attacks.py verifies bit-identity
    with ``square_attack`` on CPU.  On an accelerator each partitioning is
    itself deterministic, but XLA may schedule ``logits_fn`` differently inside a
    segment program than inside the monolithic one, so a 1-ulp loss
    difference can flip an accept/reject on borderline candidates (the
    same layout sensitivity measured for fp32 certificates, see
    examples/README.md); the attack's query budget and distribution are
    unchanged either way."""
    if segment <= 0 and n_queries > 0:
        raise ValueError(
            f"segment must be positive (got {segment}) — a non-positive "
            f"segment would silently run 0 of the {n_queries} queries"
        )
    seg = min(segment, n_queries)
    init_fn, seg_fn = make_square_segment(
        logits_fn, eps=eps, norm=norm, n_queries=n_queries, p_init=p_init,
        segment=max(seg, 1),
    )
    init_j = jax.jit(init_fn)
    seg_j = jax.jit(seg_fn)
    n_full, rem = divmod(n_queries, seg) if seg > 0 else (0, 0)
    rem_j = None
    if rem:
        _, rem_fn = make_square_segment(
            logits_fn, eps=eps, norm=norm, n_queries=n_queries,
            p_init=p_init, segment=rem,
        )
        rem_j = jax.jit(rem_fn)

    def fn(x, y, key):
        xa, loss, key = init_j(x, y, key)  # n_queries=0: init only,
        for s in range(n_full):            # matching fori_loop(0, 0, ...)
            xa, loss, key = seg_j(x, y, xa, loss, key, s * seg)
        if rem_j is not None:
            xa, loss, key = rem_j(x, y, xa, loss, key, n_full * seg)
        return xa, loss < 0

    return fn
