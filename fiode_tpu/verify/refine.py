"""Branch-and-bound cell refinement for the CROWN certificate.

Capability beyond the reference: ``robustness/certify_crown.py`` sweeps the
T-lattice with one-shot CROWN bounds and gives up on any image with a
positive cell (certify_crown.py:149-153).  But a positive CROWN bound is
not a counterexample — the bound's looseness scales with the cell box
half-width, and on borderline models most "violations" are bound slack
(measured on the flagship checkpoint: violated cells sit at +0.01..0.05
against a kappa margin of 0.886, and halving the box flips almost all of
them negative).  Refinement splits such a cell into sub-boxes that exactly
cover it and re-bounds each: soundness is preserved (the children's union
IS the parent box; every child bound is a valid CROWN certificate over its
sub-box), only completeness improves.

Batched shape: instead of the per-box recursive branch-and-bound of
GPU/CPU verifiers, the frontier of open boxes is one fixed-shape batched
kernel call per round — centers ``(C, n)`` plus per-dim half-widths
``(C, n)`` — with children enqueued host-side between rounds.  The
anisotropic boxes ride the vector-eps path of ``crown_mlp_bounds`` /
``worst_case_vdot``; the QP interval step (``ibp_cbf_qp``) broadcasts
per-dim widths natively through its band form.

Split heuristic: ``d* = argmax_d eps_d * |dval/deps_d|`` — the marginal
bound sensitivity to each half-width, from ONE extra backward pass of the
same program (``jax.vjp`` wrt the eps vector).  Soundness does not depend
on the choice (any split is sound); only convergence speed does.  Where
the gradient vanishes (it flows through the QP bisection, which is nearly
piecewise-constant) the tie-break degrades to splitting the widest dim.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["refine_uncertified", "RefineStats", "hybrid_base_sweep",
           "SweepStats"]


@dataclasses.dataclass
class RefineStats:
    image: int
    base_violated: int  # violated cells entering BaB (post alpha filter)
    rounds: int  # BaB rounds run
    boxes_evaluated: int  # BaB sub-boxes bounded (excl. the base sweep)
    certified: bool
    gave_up: str  # "" | "collect_cap" | "frontier_cap" | "rounds" |
    #               "budget" | "time_budget"
    seconds: float
    # violated cells in the plain-CROWN sweep BEFORE the alpha-CROWN
    # filter (== base_violated when alpha_iters == 0); -1 when collection
    # aborted at collect_cap.  Defaulted so pre-alpha-era stream records
    # still parse as RefineStats(**rec).
    pre_alpha_violated: int = -2


def _row_placer(cert):
    """SPMD: rows (cells / frontier boxes) are embarrassingly parallel, so
    a Certifier mesh shards them over its cell axis; GSPMD propagates the
    operand placement through the jitted kernels, no kernel changes.
    Mirrors certify._mesh_placers' cell-axis rule exactly: a 1-D mesh of
    any name shards rows; a multi-axis mesh shards over "cell" when
    present and otherwise replicates (diverging from that rule here
    would shard refine differently from the main sweep on custom meshes).
    """
    names = cert.mesh.axis_names if cert.mesh is not None else ()
    cell_ax = names[0] if len(names) == 1 else (
        "cell" if "cell" in names else None
    )
    if cell_ax is None:
        return lambda a, dim: a
    from jax.sharding import NamedSharding, PartitionSpec as P

    def place_rows(a, dim):
        spec = [None] * a.ndim
        spec[dim] = cell_ax
        return jax.device_put(a, NamedSharding(cert.mesh, P(*spec)))

    return place_rows


def _kernels(cert, alpha_iters: int = 0, lips_box: bool = False):
    """Build the jitted kernels for one Certifier's refinement pass.

    ``sweep_fn`` re-evaluates base cells at the uniform scalar eps — the
    exact per-cell quantity whose running max the main sweep reduces —
    returning per-cell values so violated cells can be located.
    ``box_step_fn`` bounds a frontier of anisotropic boxes AND returns
    each box's split dim in the same fused program (see its body for why).
    All take the image's x_bias as a traced argument so one compile
    serves every image.

    ``lips_box`` adds a SECOND, independent sound bound to every box (and
    base cell) and takes the elementwise minimum: the exact Vdot at the box
    center plus the local-Lipschitz slack ``sqrt(2) * Lf_eta * ||e||_2``
    (the lipschitz certificate's argument, certify_lipschitz.py:120-124,
    generalized to anisotropic boxes).  Soundness: for any h in the box
    with argmax-wrong class w*, w* is in the box-wide runner-up candidate
    set (eta_w^ub >= max_lo — the same candidate rule as worst_case_vdot,
    which covers argmax switching inside the box), and each
    f_w - f_y is sqrt(2)*Lf_eta-Lipschitz, so
    Vdot(h) <= max_{w in cand} [f_w(c) - f_y(c)] + sqrt(2)*Lf_eta*||h-c||_2.
    The min of two sound upper bounds is sound; NaN in either propagates
    through jnp.minimum and stays fail-closed.  The exact center value is
    the same fixed-iteration QP evaluation the shipped lipschitz
    certificate uses (PARITY.md numerics policy).  Unlike pure-Lipschitz
    refinement (refine_lips.py, whose isotropic L2 slack needs ~f^(n-1)
    boxes per factor-f shrink), here the CROWN gradient drives the splits
    and the lips bound is a free second chance to close each box — on
    deep sub-boxes whose CROWN slack is dominated by the QP interval step
    it closes boxes CROWN alone cannot.

    ``alpha_iters > 0`` swaps the box bound inside ``box_step_fn`` for an
    alpha-CROWN one: ReLU lower slopes are optimized per box against the
    smooth bound-width surrogate, with the best iterate selected by the
    certified quantity itself — never looser than plain CROWN (iterate 0
    IS the plain-CROWN heuristic slope; see optimize_crown_alphas).  Every
    iterate is sound (any alpha in [0,1] lower-bounds ReLU), so soundness
    needs no new argument.  ``sweep_fn`` stays plain CROWN: because the
    alpha bound is pointwise <= the plain bound, the plain sweep's violated
    set is a superset of alpha's — the caller filters it through
    ``box_step_fn`` instead of paying alpha on all cells.  The split-dim
    gradient stays plain-CROWN either way (only the split CHOICE uses it;
    any choice is sound).

    MEASURED VERDICT (round 4, run_data/certified_full/ALPHA_CROWN.json):
    alpha_iters does NOT pay on this workload — 0 images recovered, at a
    several-fold cost per box (the H100 cost is not measured).  The
    mechanism is kept because it is sound, tested, and the measurement is
    model-specific; production passes should run alpha_iters=0
    (+ lips_box, which does pay).
    """
    from ..models.dynamics import barrier_bounds
    from ..ops.simplex_qp import simplex_cone_project
    from .crown import crown_mlp_bounds, optimize_crown_alphas
    from .ibp_qp import ibp_cbf_qp, ibp_sigmoid, worst_case_vdot

    Ws = [jnp.asarray(W) for W in cert.Ws]
    bs = [jnp.asarray(b) for b in cert.bs]
    a1, a2, s1 = cert.alpha_1, cert.alpha_2, cert.sigma_1
    kappa, eps0 = cert.kappa, cert.eps
    n_dim = cert.n
    sqrt_n = float(np.sqrt(n_dim))
    qp_iters = getattr(getattr(cert.model, "dynamics", None), "qp_iters", 30)

    place_rows = _row_placer(cert)

    def exact_f(eta_l, x_rows):
        # the dense twin's EXACT projected dynamics at a point — the same
        # function the lipschitz certificate evaluates (eval_dot through
        # the densified Cayley stack; classification.py:104-115 semantics)
        a = jax.nn.relu(
            jnp.einsum("oi,ni->no", Ws[0], eta_l) + bs[0] + x_rows
        )
        a = jax.nn.relu(jnp.einsum("oi,ni->no", Ws[1], a) + bs[1])
        f_t = jnp.einsum("oi,ni->no", Ws[2], a) + bs[2]
        lower, upper = barrier_bounds(eta_l, a1, s1, a2)
        if cert.scale_nominal:
            f_t = (upper - lower) * jax.nn.sigmoid(f_t) + lower
        # FIODE_QP_METHOD / FIODE_QP_EXACT swap the 30-iter dual bisection
        # for a closed-form rank-rule mu (ops/simplex_qp) — same flag as
        # the ODE RHS; exact-to-rounding, so never less sound than the
        # bisection it replaces
        from ..ops.simplex_qp import qp_method_from_env
        return simplex_cone_project(
            lower, f_t, qp_iters, False, qp_method_from_env()
        )

    def lips_val(eta_l, eps, x_bias, label):
        # exact-center + local-Lipschitz box bound (see _kernels docstring)
        e = jnp.broadcast_to(eps, eta_l.shape)
        x_rows = jnp.broadcast_to(x_bias, (eta_l.shape[0], x_bias.shape[-1]))
        f = exact_f(eta_l, x_rows)
        onehot = jax.nn.one_hot(label, n_dim, dtype=bool)
        wrong_lo = jnp.where(onehot, -jnp.inf, eta_l - e)
        max_lo = jnp.max(wrong_lo, axis=-1, keepdims=True)
        runner = (eta_l + e >= max_lo) & ~onehot
        f_y = jnp.sum(jnp.where(onehot, f, 0.0), -1)
        f_w = jnp.max(jnp.where(runner, f, -jnp.inf), -1)
        eta_ub = jnp.max(eta_l + e, -1)
        lf_eta = sqrt_n * (s1 * a1 * jnp.exp(s1 * eta_ub)) + 1.0
        dist = jnp.linalg.norm(e, axis=-1)
        return (-f_y + f_w) + jnp.sqrt(2.0) * lf_eta * dist + kappa

    def post(eta_l, eps, label, lb, ub):
        # the certificate chain after the MLP bounds (shared with alpha's
        # best-iterate selection): sigmoid rescale -> QP interval -> Vdot
        if cert.scale_nominal:
            lb, ub = ibp_sigmoid(
                lb, ub, eta_l - eps, eta_l + eps, a1, s1, a2
            )
        f_lb, f_ub = ibp_cbf_qp(
            eta_l, eps, lb, ub, a1, s1, a2, with_upper=cert.with_upper
        )
        return worst_case_vdot(eta_l, eps, f_lb, f_ub, label) + kappa

    def val(eta_l, eps, x_bias, label):
        # eta_l is in label space (columns 0 <-> label swapped by the
        # caller, grid_for_label semantics): the true class sits at column
        # ``label``, exactly as in Certifier._make_crown_chunk's ``one``
        x_rows = jnp.broadcast_to(x_bias, (eta_l.shape[0], x_bias.shape[-1]))
        lb, ub = crown_mlp_bounds(Ws, bs, eta_l, eps, x_rows)
        return post(eta_l, eps, label, lb, ub)

    def alpha_val(eta_l, eps, x_bias, label):
        # alpha-CROWN box bound: width-surrogate gradient, best iterate
        # selected by the certified quantity (never looser than plain)
        x_rows = jnp.broadcast_to(x_bias, (eta_l.shape[0], x_bias.shape[-1]))
        alphas = optimize_crown_alphas(
            Ws, bs, eta_l, eps, x_rows,
            loss_fn=lambda lb, ub: jnp.sum(ub - lb, axis=-1),
            iters=alpha_iters,
            select_fn=lambda lb, ub: post(eta_l, eps, label, lb, ub),
        )
        lb, ub = crown_mlp_bounds(Ws, bs, eta_l, eps, x_rows, alphas)
        return post(eta_l, eps, label, lb, ub)

    @jax.jit
    def sweep_fn(etas_l, x_bias, label):  # (K, C, n) label-space cells
        def body(e):
            with jax.default_matmul_precision(cert.matmul_precision):
                v = val(e, eps0, x_bias, label)
                if lips_box:
                    v = jnp.minimum(v, lips_val(e, eps0, x_bias, label))
                return v

        return jax.lax.map(body, etas_l)

    box_val = alpha_val if alpha_iters > 0 else val

    def step_body(c, e, x_bias, label):
        # fused bound + split-dim for one (C, n) chunk (see box_step_fn)
        with jax.default_matmul_precision(cert.matmul_precision):
            v = box_val(c, e, x_bias, label)
            if lips_box:
                v = jnp.minimum(v, lips_val(c, e, x_bias, label))
            _, vjp = jax.vjp(lambda ee: val(c, ee, x_bias, label), e)
            (g,) = vjp(jnp.ones_like(v))
            # +tiny: a vanished gradient degrades to widest-dim split
            score = e * (jnp.abs(jnp.nan_to_num(g)) + 1e-30)
            return v, jnp.argmax(score, axis=-1).astype(jnp.int32)

    # ONE fused kernel returns (value, split dim) per box.  The split dim
    # is argmax_d eps_d * |dval/deps_d| from a vjp of the PLAIN bound
    # (sound for any choice; the alpha bound's gradient would multiply the
    # cost for a heuristic).  Computing it device-side for every box —
    # including ones that turn out closed — trades ~2x kernel flops for
    # eliminating a second dispatch round and shrinking the device->host
    # traffic from the (N, n) gradient plus a re-upload of open boxes to
    # two (N,) vectors.
    @jax.jit
    def box_step_fn(etas_l, epss, x_bias, label):  # (K, C, n) boxes
        return jax.lax.map(
            lambda ce: step_body(*ce, x_bias, label), (etas_l, epss)
        )

    # device-resident BaB rounds (used by _device_bab for large frontiers;
    # unavailable under a mesh — the host path places rows explicitly)
    device_factory = (
        None if cert.mesh is not None
        else _device_round_factory(step_body, cert.n, cert.eps)
    )

    return sweep_fn, box_step_fn, place_rows, device_factory


def _device_round_factory(step_body, n, eps0, eval_chunk=131072):
    """Jitted device-resident BaB rounds, one program per frontier
    capacity ``M``.

    Host-side frontier management (``_bab``) pays an 80-bytes/row upload
    per round plus per-call dispatch, which dominates once frontiers reach
    millions of rows.  Here the frontier LIVES on device: one program
    evaluates every live box, compacts the open ones to the front (stable
    argsort of the open flag), and writes both covering
    children in place; the host reads back two scalars per round (live
    count + overflow flag) to enforce budgets.  Capacities are powers of
    two (a handful of compiles); ``_device_bab`` grows/shrinks M as the
    frontier evolves via trivial pad/slice programs.

    Split arithmetic matches ``_split_children`` exactly (fp32 2-ulp
    covering pad via nextafter — np.spacing(x) == nextafter(x, inf) - x
    for the positive finite values here), so the device path certifies
    the same boxes the host path would.

    Returns ``make(M) -> round_fn(fc, fe, count, x_bias, label) ->
    (fc', fe', count', overflow)``; rows past ``count`` are padding
    (benign boxes) and never split.  On overflow (2 * open > M) the state
    is the COMPACTED PARENTS, unsplit, so the caller can re-enter at a
    larger capacity without losing work.
    """
    import functools

    @functools.lru_cache(maxsize=None)
    def make(M):
        K = max(M // eval_chunk, 1)
        C = M // K

        # donate the frontier buffers: at M = 2^25 the (M, n) fp32 pair is
        # ~2.7 GB, aliased into the outputs instead of copied alongside the
        # round's gather temporaries
        @functools.partial(jax.jit, donate_argnums=(0, 1))
        def round_fn(fc, fe, count, x_bias, label):
            vals, dims = jax.lax.map(
                lambda ce: step_body(*ce, x_bias, label),
                (fc.reshape(K, C, n), fe.reshape(K, C, n)),
            )
            vals = vals.reshape(M)
            dims = dims.reshape(M)
            rows = jnp.arange(M, dtype=jnp.int32)
            # fail CLOSED on NaN: only vals <= 0 closes a live box
            open_ = (rows < count) & ~(vals <= 0.0)
            n_open = jnp.sum(open_, dtype=jnp.int32)
            order = jnp.argsort(jnp.where(open_, 0, 1).astype(jnp.int8),
                                stable=True)
            sc = jnp.take(fc, order, axis=0)
            se = jnp.take(fe, order, axis=0)
            sd = jnp.take(dims, order, axis=0)
            overflow = (2 * n_open) > M
            # children of the compacted parents (rows < n_open are real)
            half = 0.5 * jnp.take_along_axis(se, sd[:, None], 1)[:, 0]
            base = jnp.take_along_axis(sc, sd[:, None], 1)[:, 0]
            lo_c = base - half
            hi_c = base + half
            pad_lo = 2.0 * (
                jnp.nextafter(jnp.abs(lo_c) + half, jnp.inf)
                - (jnp.abs(lo_c) + half)
            )
            pad_hi = 2.0 * (
                jnp.nextafter(jnp.abs(hi_c) + half, jnp.inf)
                - (jnp.abs(hi_c) + half)
            )
            # layout: rows [0, n_open) = lo children, [n_open, 2 n_open) = hi
            src = jnp.where(rows < n_open, rows, rows - n_open)
            is_lo = rows < n_open
            csel = jnp.take(sc, src, axis=0)
            esel = jnp.take(se, src, axis=0)
            dsel = jnp.take(sd, src, axis=0)
            cval = jnp.where(is_lo, jnp.take(lo_c, src), jnp.take(hi_c, src))
            eval_ = jnp.take(half, src) + jnp.where(
                is_lo, jnp.take(pad_lo, src), jnp.take(pad_hi, src)
            )
            new_fc = csel.at[rows, dsel].set(cval)
            new_fe = esel.at[rows, dsel].set(eval_)
            out_fc = jnp.where(overflow, sc, new_fc)
            out_fe = jnp.where(overflow, se, new_fe)
            new_count = jnp.where(overflow, n_open, 2 * n_open)
            return out_fc, out_fe, new_count, overflow

        return round_fn

    @functools.lru_cache(maxsize=None)
    def resize(M_from, M_to):
        @functools.partial(jax.jit, donate_argnums=(0, 1))
        def fn(fc, fe):
            if M_to > M_from:
                zc = jnp.zeros((M_to, n), fc.dtype)
                ze = jnp.full((M_to, n), jnp.float32(eps0))
                return zc.at[:M_from].set(fc), ze.at[:M_from].set(fe)
            return fc[:M_to], fe[:M_to]

        return fn

    return make, resize


def _device_bab(factory, x_bias, label, centers, eps0, n, *, max_rounds,
                frontier_cap, box_budget, fe=None,
                m_min=None, m_cap=1 << 25, deadline=None):
    """Run BaB with the frontier resident on device (see
    _device_round_factory).  ``fe`` carries per-dim half-widths when the
    caller hands over a partially-split frontier (uniform ``eps0``
    otherwise).

    Returns ``(closed, rounds, boxes, gave_up, leftover)`` — the first
    four as in ``_bab``.  When the frontier outgrows ``m_cap`` the give-up
    is ``"m_cap"`` and ``leftover`` carries the compacted OPEN parents
    (centers, half-widths) as host arrays: every open box roots an
    independent sub-tree, so the caller can partition the leftover into
    sub-frontiers and run each to closure separately (``_bab`` does) —
    capacity overflow is a scheduling event, not a verdict.  ``leftover``
    is None for every other outcome."""
    make, resize = factory
    count = len(centers)

    def p2(x):
        m = 8
        while m < x:
            m *= 2
        return m

    # default floor: small hand-offs use small capacities (tests,
    # nearly-closed images) — an explicit m_min overrides
    if m_min is None:
        m_min = min(1 << 21, p2(4 * count))
    m_min = min(m_min, m_cap)
    M = m_min
    while M < min(4 * count, m_cap):
        M *= 2
    if fe is None:
        fe = np.full((count, n), eps0, np.float32)
    # upload at the smallest capacity covering the live rows and grow to M
    # device-side: the padding rows are synthesized by `resize` on device,
    # so a 12M-row hand-off uploads ~1 GB instead of the 2.7 GB of a
    # host-padded 2^25 frontier
    M0 = min(max(m_min, p2(count)), M)
    pad = np.zeros((M0 - count, n), np.float32)
    fc = jnp.asarray(np.concatenate([centers.astype(np.float32), pad]))
    fe = jnp.asarray(np.concatenate(
        [fe.astype(np.float32),
         np.full((M0 - count, n), eps0, np.float32)]
    ))
    if M0 < M:
        fc, fe = resize(M0, M)(fc, fe)
    rounds = 0
    boxes = 0
    while count:
        if rounds >= max_rounds:
            return False, rounds, boxes, "rounds", None
        if count > frontier_cap:
            return False, rounds, boxes, "frontier_cap", None
        if boxes + count > box_budget:
            return False, rounds, boxes, "budget", None
        if deadline is not None and time.time() > deadline:
            return False, rounds, boxes, "time_budget", None
        fc, fe, count_d, ovf_d = make(M)(
            fc, fe, jnp.int32(count), x_bias, label
        )
        boxes += count
        rounds += 1
        count = int(count_d)  # scalar readback = the round's only sync
        if bool(ovf_d):
            # parents compacted but unsplit: grow capacity and retry
            # (the re-entry re-evaluates them — rare, counted in boxes)
            if M >= m_cap:
                # hand the open parents back for host partitioning
                left = (np.asarray(fc[:count]), np.asarray(fe[:count]))
                return False, rounds, boxes, "m_cap", left
            M2 = M
            while M2 < min(4 * count, m_cap):
                M2 *= 2
            fc, fe = resize(M, M2)(fc, fe)
            M = M2
            continue
        # shrink when the frontier collapses so late rounds stop paying
        # full-capacity evals over padding
        while M > m_min and count * 8 <= M:
            fc, fe = resize(M, M // 2)(fc, fe)
            M //= 2
    return True, rounds, boxes, "", None


def _chunked(fn, cs, es, out_specs, *, chunk, n, eps0, x_bias, label,
             place_rows, superchunk=16):
    """Host-chunked evaluation of a jitted (K, C, n)-box kernel over any
    number of rows, padding the tail to a static kernel shape.

    Each jitted call covers ``superchunk * chunk`` rows (a lax.map over K
    chunks inside ONE program), so per-call dispatch is paid once per
    superchunk rather than once per ``chunk``.
    Tails use the smallest power-of-two K that covers them, so a
    nearly-closed image doesn't pad every round to the full block and at
    most log2(superchunk)+1 block shapes ever compile per kernel.

    ``out_specs`` is a list of (trailing_dims, dtype) — one per output of
    ``fn`` (which may return a single array or a tuple).  Returns a list
    of stacked outputs (or the single array when one spec is given).
    """
    outs = [np.empty((len(cs),) + d, t) for d, t in out_specs]
    i = 0
    while i < len(cs):
        need = -(-(len(cs) - i) // chunk)  # ceil chunks remaining
        K = 1
        while K < need and K < superchunk:
            K *= 2
        block = K * chunk
        c = cs[i : i + block]
        e = es[i : i + block]
        npad = len(c)
        if npad < block:  # pad to the static kernel shape
            c = np.concatenate([c, np.zeros((block - npad, n), c.dtype)])
            e = np.concatenate(
                [e, np.full((block - npad, n), eps0, e.dtype)]
            )
        r = fn(
            place_rows(jnp.asarray(c.reshape(K, chunk, n)), 1),
            place_rows(jnp.asarray(e.reshape(K, chunk, n)), 1),
            x_bias, label,
        )
        if not isinstance(r, (tuple, list)):
            r = (r,)
        for out, (dims, _), ri in zip(outs, out_specs, r):
            out[i : i + npad] = (
                np.asarray(ri).reshape((block,) + dims)[:npad]
            )
        i += npad
    return outs if len(outs) > 1 else outs[0]


def _bab(box_step_fn, x_bias, label, centers, eps0, n, *, chunk,
         max_rounds, frontier_cap, box_budget,
         place_rows=lambda a, dim: a, superchunk=16,
         device_factory=None, device_min=1 << 21, device_cap=1 << 25,
         deadline=None):
    """Frontier BaB over one image's violated cells.

    ``box_step_fn(etas, epss, x_bias, label) -> (vals, split_dims)`` —
    the fused bound + split-dim kernel (see _kernels).  When the frontier
    reaches ``device_min`` rows and a ``device_factory`` is available, the
    remaining rounds run device-resident (_device_bab) — the host path's
    per-round frontier upload dominates at that scale.

    Frontiers larger than the device capacity ``device_cap`` are handled
    by PARTITIONING, not give-up: every open box roots an independent
    sub-tree, so when a device run overflows its capacity the compacted
    open parents come back to the host, are split in half, and each half
    runs to closure separately (a LIFO work-stack, depth-first — peak
    host memory is one overflow readback, ~40 bytes/row).  The image is
    certified iff every partition closes.  ``frontier_cap`` bounds the
    TOTAL live rows (stack + active partition) — the blow-up guard —
    while ``max_rounds`` bounds each partition's split depth from its
    hand-off (any box then carries at most host_rounds + max_rounds
    splits).  ``rounds`` in the returned stats accumulates across
    partitions (a work metric, not a depth).

    Returns (closed, rounds, boxes_evaluated, gave_up)."""

    def chunked(cs, es):
        return _chunked(
            box_step_fn, cs, es, [((), np.float32), ((), np.int32)],
            chunk=chunk, n=n, eps0=eps0, x_bias=x_bias, label=label,
            place_rows=place_rows, superchunk=superchunk,
        )

    fc = centers.astype(np.float32)
    fe = np.full_like(fc, eps0)
    rounds = 0
    boxes = 0
    while len(fc):
        if device_factory is not None and len(fc) >= device_min:
            stack = [(fc, fe, max_rounds - rounds)]
            while stack:
                pfc, pfe, depth = stack.pop()
                live = len(pfc) + sum(len(a) for a, _, _ in stack)
                if live > frontier_cap:
                    return False, rounds, boxes, "frontier_cap"
                if boxes + len(pfc) > box_budget:
                    return False, rounds, boxes, "budget"
                if deadline is not None and time.time() > deadline:
                    return False, rounds, boxes, "time_budget"
                ok, r2, b2, gave, left = _device_bab(
                    device_factory, x_bias, label, pfc, eps0, n,
                    max_rounds=depth,
                    frontier_cap=frontier_cap,
                    box_budget=box_budget - boxes, fe=pfe,
                    m_cap=device_cap, deadline=deadline,
                )
                rounds += r2
                boxes += b2
                if gave == "m_cap":
                    # capacity overflow: split the open parents into two
                    # independent sub-frontiers and run each to closure;
                    # the depth budget follows the partition (its boxes
                    # already carry the rounds consumed so far)
                    if depth - r2 <= 0:
                        return False, rounds, boxes, "rounds"
                    lfc, lfe = left
                    mid = len(lfc) // 2
                    stack.append((lfc[:mid], lfe[:mid], depth - r2))
                    stack.append((lfc[mid:], lfe[mid:], depth - r2))
                    continue
                if not ok:
                    return False, rounds, boxes, gave
            return True, rounds, boxes, ""
        if rounds >= max_rounds:
            return False, rounds, boxes, "rounds"
        if len(fc) > frontier_cap:
            return False, rounds, boxes, "frontier_cap"
        if boxes + len(fc) > box_budget:
            return False, rounds, boxes, "budget"
        if deadline is not None and time.time() > deadline:
            return False, rounds, boxes, "time_budget"
        vals, dims = chunked(fc, fe)
        boxes += len(fc)
        rounds += 1
        # fail CLOSED on NaN: a non-finite bound is an open box, never
        # a pass (vals > 0 would silently certify through a NaN)
        open_mask = ~(vals <= 0.0)
        if not open_mask.any():
            return True, rounds, boxes, ""
        oc, oe, od = fc[open_mask], fe[open_mask], dims[open_mask]
        lo, hi, ce_lo, ce_hi = _split_children(oc, oe, od)
        fc = np.concatenate([lo, hi])
        fe = np.concatenate([ce_lo, ce_hi])
    return True, rounds, boxes, ""


def _split_children(oc, oe, d):
    """Halve each box along its chosen dim ``d`` into two covering children.

    fp32 rounding of the child centers could otherwise open a sub-ulp
    sliver at the split plane or the parent's outer edges (fl(c -+ h) can
    land strictly inside the parent), so each child's split half-width is
    padded by 2 ulps at the child-center magnitude: the children's union
    provably covers the parent box [c - e, c + e].
    """
    rows = np.arange(len(oc))
    half = (oe[rows, d] * 0.5).astype(np.float32)
    lo = oc.copy()
    hi = oc.copy()
    lo[rows, d] -= half
    hi[rows, d] += half
    ce_lo = oe.copy()
    ce_hi = oe.copy()
    ce_lo[rows, d] = half + 2 * np.spacing(
        (np.abs(lo[rows, d]) + half).astype(np.float32)
    )
    ce_hi[rows, d] = half + 2 * np.spacing(
        (np.abs(hi[rows, d]) + half).astype(np.float32)
    )
    return lo, hi, ce_lo, ce_hi


def refine_uncertified(
    cert,
    images: np.ndarray,
    labels: np.ndarray,
    certified: np.ndarray,
    *,
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
    alpha_iters: int = 0,
    lips_box: bool = False,
    device_min: int = 1 << 21,
    device_cap: int = 1 << 25,
    image_seconds: Optional[float] = None,
    order: Optional[np.ndarray] = None,
):
    """BaB-refine every clean-but-uncertified image of a CROWN sweep.

    Per image: re-sweep all grid cells at the uniform scalar eps (locating
    the violated ones — the refined certificate is self-contained, it does
    not trust the caller's running-max verdicts), then branch-and-bound
    each violated cell until the frontier closes or a budget trips.
    ``certified`` is not mutated; an updated copy is returned with images
    flipped True only when every violated cell's refinement closed.
    ``RefineStats.image`` indexes into THIS call's ``images`` array — the
    caller owns any global-offset translation.

    ``skip`` (bool mask over images) excludes images from the todo set
    without treating them as certified — the resume hook for a driver that
    already holds a streamed verdict for them.  ``on_image`` is called as
    ``on_image(stats[-1])`` after every processed image (the stats entry
    carries the image index and its certified verdict), so drivers can
    persist progress across interruptions.

    ``alpha_iters = 0`` (default) bounds boxes with plain CROWN — cheap,
    and splitting alone closes most borderline cells.  ``alpha_iters > 0``
    switches the BaB box evaluator to alpha-CROWN (see ``_kernels``):
    the base sweep stays plain CROWN, its violated cells are then
    re-bounded once under alpha before entering the frontier (the alpha
    bound is pointwise <= plain, so this filter is exact, not heuristic),
    and ``collect_cap`` applies to the POST-filter count — images whose
    plain-CROWN violated set is intractably large (>collect_cap) become
    refinable when alpha kills most of the slack.  Each alpha evaluation
    costs ~(2*iters+2)x a plain one; use for the tail the plain evaluator
    gave up on.  (Measured on the flagship checkpoint the filter closes
    <=0.25% of violated cells — run_data/certified_full/alpha_probe.json —
    so the passes ship with alpha off.)

    ``lips_box = True`` evaluates every base cell and BaB box under the
    elementwise MIN of the CROWN bound and the exact-center +
    local-Lipschitz bound (see ``_kernels``): never looser, sound by the
    min-of-sound-bounds argument, ~+1 exact forward per box.  Because the
    base sweep also takes the min, the violated set this pass collects can
    be strictly smaller than the plain-CROWN one — collect_cap-tier images
    can become collectable.

    ``device_cap`` bounds the device-resident frontier capacity (rows).
    At 2^25 one fused bound+split round program takes 2.68 GB of
    (donated) frontier arguments and 7.87 GB of temporaries on an H100
    (``compiled.memory_analysis()``, chip_smoke.py phase 3), a seventh of
    the card's 80 GB; the default was set where the earlier 16 GB chip
    ran out, and a larger cap is untested.  Frontiers that outgrow it are
    host-PARTITIONED into independent sub-frontiers and run to closure
    separately (see _bab) — capacity is a scheduling bound, only
    ``frontier_cap`` (total live rows), ``box_budget`` and
    ``image_seconds`` abandon an image.

    ``image_seconds`` caps one image's wall clock (checked between BaB
    rounds; the verdict is ``gave_up="time_budget"``): a multi-image pass
    over a tail with unknown per-image difficulty stays schedulable —
    quick wins land first, the time-capped images are retried under a
    bigger cap via the budget-stamped resume (drivers skip a gave-up
    verdict only when its recorded budgets match the current run's).

    Returns (new_certified, [RefineStats...]).
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
    if order is not None:
        # schedule in the caller's order (e.g. exact-witness margin,
        # easiest first) so quick wins land before budget-hungry images;
        # unlisted todo images run after the listed ones, index order;
        # repeats keep their first occurrence, non-todo entries are ignored
        listed = []
        for i in np.asarray(order, int):
            if todo_mask[i] and i not in listed:
                listed.append(int(i))
        todo = np.asarray(
            listed + [int(i) for i in todo if i not in set(listed)], int)
    stats = []
    if not len(todo):
        return certified, stats

    sweep_fn, box_step_fn, place_rows, device_factory = _kernels(
        cert, alpha_iters=alpha_iters, lips_box=lips_box
    )
    feats = np.asarray(cert._features(cert.params, jnp.asarray(images[todo])))
    x_biases = feats @ np.asarray(cert.U).T + np.asarray(cert.bU)
    grid = cert.grid
    block_cells = chunk * superchunk

    for k, img in enumerate(todo):
        t0 = time.time()
        label = int(labels[img])
        perm = np.arange(n)
        perm[0], perm[label] = label, 0
        xb = jnp.asarray(x_biases[k])
        viol = []
        gave = ""
        pre_alpha = 0
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
                    xb,
                    label,
                )
            ).reshape(-1)[:nb]
            # fail CLOSED on NaN (see _bab): a non-finite per-cell bound is
            # collected for refinement, never treated as passing
            bad = np.nonzero(~(vals <= 0.0))[0]
            pre_alpha += len(bad)
            if len(bad) and alpha_iters > 0:
                # exact filter: the alpha bound is pointwise <= plain (best
                # iterate selected by the certified quantity, starting from
                # plain's slopes), so cells it closes need no refinement
                cells = pblock[bad]
                avals, _ = _chunked(
                    box_step_fn, cells,
                    np.full_like(cells, cert.eps),
                    [((), np.float32), ((), np.int32)],
                    chunk=chunk, n=n, eps0=cert.eps, x_bias=xb,
                    label=label, place_rows=place_rows,
                    superchunk=superchunk,
                )
                bad = bad[~(avals <= 0.0)]
            if len(bad):
                viol.append(pblock[bad])
            if sum(len(v) for v in viol) > collect_cap:
                gave = "collect_cap"
                break
        if gave:
            stats.append(RefineStats(int(img), -1, 0, 0, False, gave,
                                     time.time() - t0, pre_alpha))
            if on_image:
                on_image(stats[-1])
            continue
        centers = (np.concatenate(viol) if viol
                   else np.zeros((0, n), np.float32))
        if not len(centers):
            # every cell already passes under this pass's evaluation
            certified[img] = True
            stats.append(RefineStats(int(img), 0, 0, 0, True, "",
                                     time.time() - t0, pre_alpha))
            if on_image:
                on_image(stats[-1])
            continue
        ok, rounds, boxes, gave = _bab(
            box_step_fn, xb, label, centers, cert.eps, n,
            chunk=chunk, max_rounds=max_rounds, frontier_cap=frontier_cap,
            box_budget=box_budget, place_rows=place_rows,
            superchunk=superchunk, device_factory=device_factory,
            device_min=device_min, device_cap=device_cap,
            deadline=None if image_seconds is None else t0 + image_seconds,
        )
        if ok:
            certified[img] = True
        stats.append(RefineStats(int(img), len(centers), rounds, boxes, ok,
                                 gave, time.time() - t0, pre_alpha))
        if on_image:
            on_image(stats[-1])
        if progress_every and (k + 1) % progress_every == 0:
            done = sum(1 for s in stats if s.certified)
            print(
                f"[refine] {k + 1}/{len(todo)} images, recovered {done} "
                f"(last: img {img} viol={len(centers)}"
                f"{f'/pre-alpha {pre_alpha}' if alpha_iters else ''} "
                f"rounds={rounds} boxes={boxes} ok={ok}"
                f"{' ' + gave if gave else ''})",
                flush=True,
            )
    return certified, stats


@dataclasses.dataclass
class SweepStats:
    image: int
    worst: float  # max hybrid bound over all grid cells (NaN -> +inf)
    n_violated: int  # cells whose hybrid bound is not <= 0 (NaN counted)
    clean: bool
    certified: bool  # clean and n_violated == 0
    seconds: float


def hybrid_base_sweep(cert, images, labels, *, lips_box: bool = True,
                      chunk: int = 8192, superchunk: int = 16,
                      skip: Optional[np.ndarray] = None, on_image=None):
    """One full-grid sweep per image under the HYBRID cell bound
    ``min(CROWN, exact-center + local-Lipschitz)`` — the package's
    strongest single-pass (no branch-and-bound) certificate.

    Each of the two bounds is individually sound over the cell box
    (``_kernels`` docstring: the CROWN chain is the shipping certificate's,
    the Lipschitz term is certify_lipschitz.py:120-124 generalized to the
    box with box-wide runner-up candidates), so their pointwise min is
    sound and the sweep dominates BOTH base certificates: every image the
    plain-CROWN sweep or the slack-Lipschitz sweep certifies is certified
    here a fortiori, and cells where the two bounds' slacks differ can
    close images NEITHER single bound does.  Cost is ~2.7x the plain CROWN
    sweep (one extra exact forward + QP per cell).

    NaN fails closed: a non-finite cell bound counts as violated and
    poisons ``worst`` to +inf.  ``certified`` additionally requires a
    clean prediction, matching ``Certifier.certify`` semantics
    (certify_crown.py:141-147).

    ``skip`` masks images out of the sweep (resume hook); ``on_image`` is
    called with each image's ``SweepStats`` as it completes.  Returns the
    list of SweepStats for the swept images (indices into ``images``).
    """
    labels = np.asarray(labels)
    n = cert.n
    sweep_fn, _, place_rows, _ = _kernels(cert, lips_box=lips_box)
    clean = np.asarray(
        cert._predict(cert.params, jnp.asarray(images))
    ) == labels
    todo = np.arange(len(labels))
    if skip is not None:
        todo = todo[~np.asarray(skip, bool)[: len(labels)]]
    if not len(todo):
        return []
    feats = np.asarray(cert._features(cert.params, jnp.asarray(images[todo])))
    x_biases = feats @ np.asarray(cert.U).T + np.asarray(cert.bU)
    grid = cert.grid
    block_cells = chunk * superchunk
    stats = []
    for k, img in enumerate(todo):
        t0 = time.time()
        label = int(labels[img])
        perm = np.arange(n)
        perm[0], perm[label] = label, 0
        xb = jnp.asarray(x_biases[k])
        worst = -np.inf
        n_viol = 0
        for i in range(0, len(grid), block_cells):
            block = grid[i : i + block_cells]
            nb = len(block)
            if nb < block_cells:
                block = np.concatenate(
                    [block, np.zeros((block_cells - nb, n), np.float32)]
                )
            vals = np.asarray(
                sweep_fn(
                    place_rows(
                        jnp.asarray(
                            block[:, perm].reshape(superchunk, chunk, n)
                        ), 1
                    ),
                    xb,
                    label,
                )
            ).reshape(-1)[:nb]
            bad = ~(vals <= 0.0)  # NaN fails closed
            n_viol += int(bad.sum())
            blk_worst = float(np.where(np.isnan(vals), np.inf, vals).max())
            worst = max(worst, blk_worst)
        stats.append(SweepStats(
            int(img), worst, n_viol, bool(clean[img]),
            bool(clean[img]) and n_viol == 0, time.time() - t0,
        ))
        if on_image:
            on_image(stats[-1])
    return stats
