"""Local grid refinement for the Lipschitz certificate.

Capability beyond the reference: ``robustness/certify_lipschitz.py``
evaluates Vdot at every T-lattice decision-boundary point and adds one
global grid-gap slack ``sqrt(2) * Lf_eta * sqrt(n)/T``
(certify_lipschitz.py:120-143) — an image with a single slack-violated
cell is abandoned.  But the slack scales with the lattice gap: a cell
whose exact grid value passes (``vdot + kappa < 0``) and only the slack
pushes it over can be closed by re-covering that cell's region at a finer
local resolution.  This module applies the branch-and-bound pattern of
``verify/refine.py`` to exactly that: the violated cell's covered region
is split into anisotropic sub-boxes, each re-certified with its own
(smaller) slack.

Soundness (self-contained per box, no lattice-rounding lemma needed):

* The base certificate accounts for the L-inf ball of radius ``1/T``
  around each lattice point: its slack radius is ``sqrt(n)/T`` (the L2
  radius of that ball) and its ``Lf_eta`` uses ``eta_ub = max(g) + 1/T``
  (the max coordinate over that ball) — certify_lipschitz.py:79-83 and
  Certifier._make_lips_chunk mirror this.  Refinement therefore covers
  ``B_inf(g, 1/T)`` for every violated ``g``: sub-boxes exactly cover the
  parent box (verify/refine._split_children, fp32-ulp padded).
* Per sub-box ``[c - e, c + e]`` the certified bound is
      Vdot(eta) <= -f_y(c) + max_{w in P} f_w(c)
                   + sqrt(2) * Lf_eta(box) * ||e||_2        for all
  boundary points eta in the box, where ``P`` is every wrong class that
  can be the max-wrong coordinate of SOME eta in the box (interval test
  ``hi_w >= max_w' lo_w'``) — a superset of the runner set of every
  covered point, so taking the max over ``P`` dominates the true
  ``f_{w*(eta)}(c)``; the sqrt(2) transfers the two f components from c
  to eta exactly as in the base certificate, and ``Lf_eta`` uses
  ``eta_ub = max_i(c_i + e_i)`` (the max coordinate over the box — same
  dependence the base formula uses, so the constant is valid on the box).
  Box centers drift off the simplex plane after splits; the bound above
  never assumes c is feasible, only that eta and c lie in the box.
* A sub-box provably containing NO decision-boundary point is vacuous:
  conservative interval tests (simplex sum reachable, all coordinates
  can be >= 0, the label coordinate can tie the max wrong) only discard
  boxes where one test is impossible for every point of the box.
* The base certificate is strict (``worst < 0`` certifies,
  certify_lipschitz.py:120-124): a box value of exactly 0.0 is kept open
  rather than certified.

Images with an EXACT grid violation (``vdot(g) + kappa >= 0`` at some
lattice point — the larger-T certificate fails) are provably unrefinable:
shrinking boxes around that point converge to the violated exact value.
They are skipped up front with ``gave_up="exact_violation"``.

Measured reach (round 4, flagship CIFAR checkpoint): the slack term is
isotropic-L2 — ``sqrt(2) * Lf_eta * ||e||_2`` over n=10 box dims — so one
single-dim split shrinks it by only ~4% (``sqrt(9.25/10)``), and a cell
whose center value misses the with-slack threshold by a factor f needs a
~f-times-finer lattice in ALL dims (~f^(n-1) sub-boxes).  On the flagship
checkpoint the slack-violated cells sit far inside that regime (base
slack ~0.82 vs margins needing ||e|| shrunk ~7x => ~7^9 boxes/cell):
image 3's 5.5M violated cells doubled the frontier every round to the
2^25 cap with ~0% closing (38M boxes, gave_up=frontier_cap), image 7
exceeded a 12M collect cap.  This refinement therefore helps only when
violated-cell margins are within one or two splits of closing (low n,
small kappa, or near-threshold slack); the committed full-set evidence
for THIS model keeps the with-slack certificate at 318/512 and the tail
is attacked through the CROWN BaB (verify/refine.py) instead, whose
per-dim linear-bound slack single-dim splits do reduce.
"""
from __future__ import annotations

import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .refine import RefineStats, _bab, _chunked, _row_placer

__all__ = ["refine_lips_uncertified"]


def _lips_kernels(cert):
    """Jitted kernels for one Certifier's Lipschitz refinement pass.

    ``sweep_fn`` reproduces the base sweep's per-cell value (exact-runner
    Vdot + global-gap slack + kappa_lips) so violated cells can be
    located — identical math to Certifier._make_lips_chunk's ``one``
    before its max reduction.  ``box_step_fn`` fuses the per-box bound
    from the module docstring with its half-width-gradient split dim
    (one dispatch per round — see refine._kernels).  The x_bias slot of
    the shared _bab driver carries the image's backbone features.
    """
    params = cert.params
    model = cert.model
    a1, s1 = cert.alpha_1, cert.sigma_1
    n = cert.n
    kappa = cert.kappa_lips
    eps0 = cert.eps
    dist0 = float(np.sqrt(n)) / cert.T
    sqrt_n = float(np.sqrt(n))
    place_rows = _row_placer(cert)

    def f_eval(eta_c, feats):
        x_in = jnp.broadcast_to(feats, (eta_c.shape[0], feats.shape[-1]))
        return model.eval_dot(
            params, eta_c, x_in, scale_nominal=cert.scale_nominal
        )

    def sweep_val(eta_l, feats, label):
        # the base certificate's per-cell quantity (strictly-negative
        # required): exact-tie runner max, global lattice slack
        f = f_eval(eta_l, feats)
        onehot = jax.nn.one_hot(label, n, dtype=bool)
        wrong = jnp.where(onehot, -jnp.inf, eta_l)
        max_wrong = jnp.max(wrong, axis=-1, keepdims=True)
        runner = (eta_l == max_wrong) & ~onehot
        f_y = jnp.sum(jnp.where(onehot, f, 0.0), -1)
        f_w = jnp.max(jnp.where(runner, f, -jnp.inf), -1)
        eta_ub = jnp.max(eta_l, -1) + eps0
        Lf_eta = sqrt_n * (s1 * a1 * jnp.exp(s1 * eta_ub)) + 1.0
        return -f_y + f_w + jnp.sqrt(2.0) * Lf_eta * dist0 + kappa

    def box_val(eta_c, eps, feats, label):
        # per-box certified bound (module docstring); eta_c (C, n) centers
        # possibly off-plane, eps (C, n) half-widths
        f = f_eval(eta_c, feats)
        onehot = jax.nn.one_hot(label, n, dtype=bool)
        lo = eta_c - eps
        hi = eta_c + eps
        wrong_lo = jnp.where(onehot, -jnp.inf, lo)
        wrong_hi = jnp.where(onehot, -jnp.inf, hi)
        max_wrong_lo = jnp.max(wrong_lo, -1, keepdims=True)
        # P: wrong classes that can be the box's max-wrong coordinate
        possible = (wrong_hi >= max_wrong_lo) & ~onehot
        f_y = jnp.sum(jnp.where(onehot, f, 0.0), -1)
        f_w = jnp.max(jnp.where(possible, f, -jnp.inf), -1)
        eta_ub = jnp.max(hi, -1)
        Lf_eta = sqrt_n * (s1 * a1 * jnp.exp(s1 * eta_ub)) + 1.0
        slack = jnp.sqrt(2.0) * Lf_eta * jnp.sqrt(
            jnp.sum(jnp.square(eps), -1)
        )
        v = -f_y + f_w + slack + kappa
        # vacuous boxes: no decision-boundary point can lie inside
        y_lo = jnp.sum(jnp.where(onehot, lo, 0.0), -1)
        y_hi = jnp.sum(jnp.where(onehot, hi, 0.0), -1)
        feasible = (
            (jnp.sum(jnp.maximum(lo, 0.0), -1) <= 1.0)
            & (jnp.sum(hi, -1) >= 1.0)
            & jnp.all(hi >= 0.0, -1)
            & (y_hi >= max_wrong_lo[:, 0])
            & (y_lo <= jnp.max(wrong_hi, -1))
        )
        v = jnp.where(feasible, v, -jnp.inf)
        # strict certificate: exactly-0 stays open (NaN too, via the
        # driver's fail-closed ~(v <= 0) mask)
        return jnp.where(v < 0.0, v, jnp.maximum(v, jnp.float32(1e-30)))

    @jax.jit
    def sweep_fn(etas_l, feats, label):  # (K, C, n) label-space cells
        def body(e):
            with jax.default_matmul_precision(cert.matmul_precision):
                return sweep_val(e, feats, label)

        return jax.lax.map(body, etas_l)

    def step_body(c, e, feats, label):
        # eps sensitivity only flows through slack / eta_ub / feasibility
        # masks (the center eval is eps-independent): cheap backward
        with jax.default_matmul_precision(cert.matmul_precision):
            v, vjp = jax.vjp(
                lambda ee: box_val(c, ee, feats, label), e
            )
            (g,) = vjp(jnp.ones_like(v))
            score = e * (jnp.abs(jnp.nan_to_num(g)) + 1e-30)
            return v, jnp.argmax(score, axis=-1).astype(jnp.int32)

    @jax.jit
    def box_step_fn(etas_c, epss, feats, label):  # (K, C, n) boxes
        return jax.lax.map(
            lambda ce: step_body(*ce, feats, label), (etas_c, epss)
        )

    from .refine import _device_round_factory

    device_factory = (
        None if cert.mesh is not None
        else _device_round_factory(step_body, cert.n, cert.eps)
    )

    return sweep_fn, box_step_fn, place_rows, device_factory


def refine_lips_uncertified(
    cert,
    images: np.ndarray,
    labels: np.ndarray,
    certified: np.ndarray,
    *,
    exact_ok: Optional[np.ndarray] = None,
    clean: Optional[np.ndarray] = None,
    chunk: int = 8192,
    superchunk: int = 16,
    collect_cap: int = 4_000_000,
    max_rounds: int = 40,
    frontier_cap: int = 1 << 20,
    box_budget: int = 64_000_000,
    progress_every: int = 0,
    skip: Optional[np.ndarray] = None,
    on_image=None,
    device_min: int = 1 << 21,
):
    """BaB-refine every clean-but-uncertified image of a Lipschitz sweep.

    ``certified`` is the with-slack verdict array (certify method
    "lipschitz"); ``exact_ok`` the larger-T (slack-free) one.  Images with
    ``exact_ok`` False carry an exact lattice violation and are recorded
    as ``gave_up="exact_violation"`` without work (see module docstring);
    when ``exact_ok`` is None it is computed here with a full sweep.

    Mechanics (resume hooks ``skip``/``on_image``, budget semantics,
    fail-closed NaN handling, covering splits) are shared with
    ``refine.refine_uncertified``.  Returns (new_certified, [RefineStats]).
    """
    certified = np.asarray(certified).copy()
    labels = np.asarray(labels)
    n = cert.n
    if len(labels) == 0:
        return certified, []
    if clean is None:
        clean = np.asarray(
            cert._predict(cert.params, jnp.asarray(images))
        ) == labels
    todo_mask = clean & ~certified
    if skip is not None:
        todo_mask &= ~np.asarray(skip, bool)
    todo = np.nonzero(todo_mask)[0]
    stats = []
    if not len(todo):
        return certified, stats

    if exact_ok is None:
        r = cert.certify(images, labels, method="lipschitz",
                         early_exit=False)
        exact_ok = r.larger_T_certified
    exact_ok = np.asarray(exact_ok, bool)

    sweep_fn, box_step_fn, place_rows, device_factory = _lips_kernels(cert)
    feats = np.asarray(
        cert._features(cert.params, jnp.asarray(images[todo]))
    )
    grid = cert.grid
    block_cells = chunk * superchunk

    for k, img in enumerate(todo):
        t0 = time.time()
        if not exact_ok[img]:
            stats.append(RefineStats(int(img), -1, 0, 0, False,
                                     "exact_violation", time.time() - t0))
            if on_image:
                on_image(stats[-1])
            continue
        label = int(labels[img])
        perm = np.arange(n)
        perm[0], perm[label] = label, 0
        ft = jnp.asarray(feats[k])
        viol = []
        gave = ""
        for i in range(0, len(grid), block_cells):
            block = grid[i : i + block_cells]
            nb = len(block)
            if nb < block_cells:
                block = np.concatenate(
                    [block, np.zeros((block_cells - nb, n), np.float32)]
                )
            pblock = block[:, perm]  # label space
            vals = np.asarray(
                sweep_fn(
                    place_rows(
                        jnp.asarray(pblock.reshape(superchunk, chunk, n)), 1
                    ),
                    ft,
                    label,
                )
            ).reshape(-1)[:nb]
            # strict certificate + fail CLOSED on NaN: only vals < 0 pass
            bad = np.nonzero(~(vals < 0.0))[0]
            if len(bad):
                viol.append(pblock[bad])
            if sum(len(v) for v in viol) > collect_cap:
                gave = "collect_cap"
                break
        if gave:
            stats.append(RefineStats(int(img), -1, 0, 0, False, gave,
                                     time.time() - t0))
            if on_image:
                on_image(stats[-1])
            continue
        centers = (np.concatenate(viol) if viol
                   else np.zeros((0, n), np.float32))
        if not len(centers):
            certified[img] = True
            stats.append(RefineStats(int(img), 0, 0, 0, True, "",
                                     time.time() - t0))
            if on_image:
                on_image(stats[-1])
            continue
        # seed frontier with the violated cells' covered L-inf balls (the
        # box evaluator's bound there is >= the sweep's — P-runner superset)
        ok, rounds, boxes, gave = _bab(
            box_step_fn, ft, label, centers, cert.eps, n,
            chunk=chunk, max_rounds=max_rounds, frontier_cap=frontier_cap,
            box_budget=box_budget, place_rows=place_rows,
            superchunk=superchunk, device_factory=device_factory,
            device_min=device_min,
        )
        if ok:
            certified[img] = True
        stats.append(RefineStats(int(img), len(centers), rounds, boxes, ok,
                                 gave, time.time() - t0))
        if on_image:
            on_image(stats[-1])
        if progress_every and (k + 1) % progress_every == 0:
            done = sum(1 for s in stats if s.certified)
            print(
                f"[refine-lips] {k + 1}/{len(todo)} images, recovered "
                f"{done} (last: img {img} viol={len(centers)} "
                f"rounds={rounds} boxes={boxes} ok={ok}"
                f"{' ' + gave if gave else ''})",
                flush=True,
            )
    return certified, stats
