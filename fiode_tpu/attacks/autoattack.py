"""AutoAttack suite driver.

Rebuild of the reference's attack evaluation surface:
  * test-time suite ['apgd-ce', 'apgd-t'] (pl_modules.py:222-244);
  * 'standard' = [apgd-ce, apgd-t, fab-t, square] full evaluation
    (eval_autoattack.py:51, AutoAttack version='standard').

Sequential composition: each attack only updates examples that are still
robust; the suite returns the union of successful adversarials plus the
final robust-accuracy mask.  Attacks run full-batch with masking (static
shapes, one compile) rather than re-slicing the still-robust subset.
"""
from __future__ import annotations

from typing import Callable, Sequence

import jax
import jax.numpy as jnp

from .apgd import apgd_ce, apgd_targeted
from .fab import fab_targeted
from .square import square_attack_chunked

__all__ = ["AutoAttackSuite"]


class AutoAttackSuite:
    """attacks_to_run subset of {'apgd-ce','apgd-t','fab-t','square'}."""

    def __init__(
        self,
        logits_fn: Callable,
        *,
        eps: float,
        norm: str = "L2",
        attacks_to_run: Sequence[str] = ("apgd-ce", "apgd-t", "fab-t", "square"),
        n_iter: int = 100,
        square_queries: int = 5000,
    ):
        self.logits_fn = logits_fn
        self.eps = eps
        self.norm = norm
        self.attacks = tuple(attacks_to_run)
        self.n_iter = n_iter
        self.square_queries = square_queries
        self._compiled = {}

    def _attack_fn(self, name):
        """Each attack is ONE jitted program (cached per suite) — except
        square, which is host-chained into ~500-query jitted segments (see
        square_attack_chunked).  Jitting avoids eager per-op dispatch around
        the inner loops, and recompilation is avoided across batches of the
        same shape."""
        if name not in self._compiled:
            if name == "apgd-ce":
                fn = lambda x, y, k: apgd_ce(
                    self.logits_fn, x, y, k, eps=self.eps, norm=self.norm,
                    n_iter=self.n_iter,
                )
            elif name == "apgd-t":
                fn = lambda x, y, k: apgd_targeted(
                    self.logits_fn, x, y, k, eps=self.eps, norm=self.norm,
                    n_iter=self.n_iter,
                )
            elif name == "fab-t":
                fn = lambda x, y, k: fab_targeted(
                    self.logits_fn, x, y, k, eps=self.eps, norm=self.norm,
                    n_iter=self.n_iter,
                )
            elif name == "square":
                # host-chunked ~500-query jitted segments instead of one
                # n_queries-long device loop (each query = one ODE solve);
                # same queries/carry as the single program (bit-identity
                # verified on CPU — see square_attack_chunked)
                fn = square_attack_chunked(
                    self.logits_fn, eps=self.eps, norm=self.norm,
                    n_queries=self.square_queries,
                )
                self._compiled[name] = fn
                return fn
            else:
                raise ValueError(name)
            self._compiled[name] = jax.jit(fn)
        return self._compiled[name]

    def _validate(self, x, y, xb, succ):
        """Accept an attack's claimed success only for a VALID adversarial:
        finite, inside [0,1]^d, inside the eps-ball, and actually
        misclassified by a fresh forward pass.  The autoattack package gets
        the same guarantee from its final `check` re-evaluation
        (autoattack.py run_standard_evaluation's acc recomputation); here it
        additionally guards the degenerate case where a NaN iterate makes
        `argmax(NaN logits) != y` read as success — a NaN input is not an
        adversarial example."""
        flat = (xb - x).reshape(x.shape[0], -1)
        if self.norm == "Linf":
            in_ball = jnp.max(jnp.abs(flat), -1) <= self.eps * (1 + 1e-5)
        else:
            in_ball = jnp.linalg.norm(flat, axis=-1) <= self.eps * (1 + 1e-5)
        finite = jnp.isfinite(xb).reshape(x.shape[0], -1).all(-1)
        in_range = ((xb >= 0.0) & (xb <= 1.0)).reshape(x.shape[0], -1).all(-1)
        lg = self.logits_fn(xb)
        mis = jnp.isfinite(lg).all(-1) & (jnp.argmax(lg, -1) != y)
        return succ & finite & in_ball & in_range & mis

    def run(self, x, y, key):
        """Returns (x_adv, robust_mask)."""
        bshape = (x.shape[0],) + (1,) * (x.ndim - 1)
        pred = jnp.argmax(self.logits_fn(x), -1)
        robust = pred == y  # misclassified are already "broken"
        x_adv = x

        if "_validate" not in self._compiled:
            self._compiled["_validate"] = jax.jit(self._validate)
        for name in self.attacks:
            key, k = jax.random.split(key)
            xb, succ = self._attack_fn(name)(x, y, k)
            succ = self._compiled["_validate"](x, y, xb, succ)
            newly_broken = succ & robust
            x_adv = jnp.where(newly_broken.reshape(bshape), xb, x_adv)
            robust = robust & ~succ
        return x_adv, robust
