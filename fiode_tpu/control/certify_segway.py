"""Segway safe-controller certification + closed-loop simulation.

Rebuild of control/certify_segway.py:25-146:
  * level-band inflation from the grid resolution:
    level_{ub,lb} = (sqrt(level) ± sqrt(3)/2 · r · sigma_max(P))^2   (:35-42)
  * sound bound of Vdot over every grid cell in the band: CROWN bounds of
    the ReLU MLP controller over the cell box (verify/crown.py) feed an
    interval enclosure of the analytic closed-loop dynamics
    (Segway.dynamics_interval), then an interval quadratic form for
    Vdot = <PᵀP x, f>; certificate iff max upper bound <= 0          (:52-67)
    — cells are covered by their Linf box (half-width r/2 per axis), which
    covers every state the union of cells covers (the reference instead
    bounds an L2 ball of radius sqrt(3)/2 r around each grid point);
  * closed-loop trajectory simulation from rejection-sampled starts near
    the level set, via the fiode_tpu ODE stack                        (:103-139).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.checkpoint import load_pytree
from ..verify.crown import crown_mlp_bounds
from ..verify.interval import IV, iv_dot
from .controllers import NNController, NNControllerModule
from .lyapunov_ctrl import LyaQuadratic
from .samplers import grid_uniform_3d, random_uniform, reject_sampling
from .systems import Segway

__all__ = ["certify_segway", "SegwayCertifyResult"]


@dataclasses.dataclass
class SegwayCertifyResult:
    ub_max: float
    certified: bool
    n_cells: int
    level_lb: float
    level_ub: float
    exact_vdot_max: float = float("nan")
    traj_max_level_drift: Optional[float] = None


def vdot_cell_bounds(system, ctrl_Ws, ctrl_bs, P, cells, half_width):
    """Upper bound of Vdot over Linf boxes around ``cells`` (N, 3)."""
    # 1. controller output bounds via CROWN over the cell box
    u_lb, u_ub = crown_mlp_bounds(
        ctrl_Ws, ctrl_bs, cells, half_width, jnp.zeros(ctrl_bs[0].shape[-1])
    )
    # 2. closed-loop dynamics interval
    x_iv = IV(cells - half_width, cells + half_width)
    f_iv = system.dynamics_interval(x_iv, IV(u_lb, u_ub))
    # 3. Vdot = <PᵀP x, f> interval dot product.  g = PᵀP x needs the
    # sign-split interval matvec: evaluating the two box corners
    # under-covers whenever PᵀP has mixed-sign rows (trained P always
    # does), which previously let a violated cell pass — see iv_dot.
    PtP = P.T @ P
    g_iv = iv_dot(x_iv, PtP)
    prod = g_iv * f_iv
    return jnp.sum(prod.lo, -1), jnp.sum(prod.hi, -1)


def certify_segway(
    model_path: Optional[str] = None,
    model: Optional[dict] = None,
    *,
    level: float = 0.15,
    r: float = 0.01,
    region: float = 1.5,
    phi_region: float = float(np.pi / 12),
    chunk: int = 65536,
    simulate_trajectories: bool = True,
    verbose: bool = True,
    plot_dir: Optional[str] = None,
) -> SegwayCertifyResult:
    if model is None:
        model = load_pytree(model_path)
    system = Segway()
    P = jnp.asarray(model["P"])
    goal = jnp.zeros((1, 3))
    lya = LyaQuadratic(P, goal)
    # rebuild the controller at its TRAINED width (a default-width module
    # against non-default checkpointed kernels fails restore)
    hidden = int(model.get("config", {}).get("hidden", 32))
    ctrl = NNController(NNControllerModule(hidden=hidden), model["ctrl"])
    Ws, bs = ctrl.dense_weights()
    Ws = [jnp.asarray(W) for W in Ws]
    bs = [jnp.asarray(b) for b in bs]

    sigma = lya.sigma_max()
    level_ub = (np.sqrt(level) + np.sqrt(3) / 2 * r * sigma) ** 2
    level_lb = max((np.sqrt(level) - np.sqrt(3) / 2 * r * sigma) ** 2, 0.0)

    grid, *_ = grid_uniform_3d(
        np.asarray([phi_region, region, region]), np.full(3, r)
    )
    eta = reject_sampling(grid, lya, level_lb, level_ub)
    n_cells = len(eta)
    if n_cells == 0:
        # a certificate over zero states is vacuous, not a pass
        raise ValueError(
            f"no grid cell lands in the level band [{level_lb:.4f}, "
            f"{level_ub:.4f}] at r={r}; refine the grid or widen the band"
        )

    @jax.jit
    def chunk_ub(cells, valid):
        # certification-grade numerics: float32 matmuls (PARITY.md
        # "Numerics policy" — the backend's reduced-precision default
        # passes are screening-only)
        with jax.default_matmul_precision("float32"):
            _, ub = vdot_cell_bounds(system, Ws, bs, P, cells, r / 2)
            # exact Vdot at the cell centers: separates "training failed"
            # (exact > 0) from "bound too loose" (exact <= 0 < ub)
            exact = lya.h_dot(cells, system(cells, ctrl(cells)))[:, 0]
        return (
            jnp.max(jnp.where(valid, ub, -jnp.inf)),
            jnp.max(jnp.where(valid, exact, -jnp.inf)),
        )

    ub_max = -np.inf
    exact_max = -np.inf
    for i in range(0, n_cells, chunk):
        blk = eta[i : i + chunk]
        valid = np.ones(len(blk), bool)
        if len(blk) < chunk:
            pad = chunk - len(blk)
            blk = np.concatenate([blk, np.zeros((pad, 3), np.float32)])
            valid = np.concatenate([valid, np.zeros(pad, bool)])
        u, e = chunk_ub(jnp.asarray(blk), jnp.asarray(valid))
        ub_max = max(ub_max, float(u))
        exact_max = max(exact_max, float(e))
    certified = ub_max <= 0.0
    if verbose:
        print(
            f"[certify_segway] cells={n_cells} ub.max={ub_max:.5f} "
            f"exact.max={exact_max:.5f} certified={certified}"
        )

    drift = None
    traj = None
    if simulate_trajectories:
        key = jax.random.PRNGKey(0)
        x0 = random_uniform(
            key, jnp.asarray([phi_region, region, region]), 1000
        )
        x0_in = reject_sampling(np.asarray(x0), lya, level - 0.02, level)
        if len(x0_in) > 0:
            x0_in = x0_in[:5]
            ts = np.linspace(0.0, 50.0, 200)
            xs, _ = system.simulate(jnp.asarray(x0_in), ctrl, ts)
            traj = np.asarray(xs)
            levels = np.asarray(
                jax.vmap(lambda x: lya(x)[:, 0])(xs)
            )  # (T, N)
            drift = float(np.max(levels) - level)
            if verbose:
                print(
                    f"[certify_segway] {len(x0_in)} trajectories, "
                    f"max level drift above start: {drift:.4f}"
                )

    if plot_dir is not None:
        # certify-time visual verification (reference
        # certify_segway.py:69-139: Vdot contours + streamlines + 3-D
        # closed-loop trajectories)
        from pathlib import Path

        from ..utils.plotting import plot_segway_phase, plot_segway_traj3d

        pdir = Path(plot_dir)
        pdir.mkdir(parents=True, exist_ok=True)
        vdot_fn = jax.jit(
            lambda pts: lya.h_dot(pts, system(pts, ctrl(pts)))[:, 0]
        )
        f_fn = jax.jit(lambda pts: system(pts, ctrl(pts)))
        plot_segway_phase(
            jax.jit(lambda pts: lya(pts)), vdot_fn,
            phi_region=phi_region, region=region, level=level,
            level_lb=level_lb, level_ub=level_ub, f_fn=f_fn,
            save=str(pdir / "segway_vdot_phase.png"),
        )
        if traj is not None:
            plot_segway_traj3d(
                traj, level_band_pts=eta,
                save=str(pdir / "segway_traj3d.png"),
            )
        if verbose:
            print(f"[certify_segway] plots written under {pdir}")
    return SegwayCertifyResult(
        ub_max=ub_max,
        certified=certified,
        exact_vdot_max=exact_max,
        n_cells=n_cells,
        level_lb=level_lb,
        level_ub=level_ub,
        traj_max_level_drift=drift,
    )
