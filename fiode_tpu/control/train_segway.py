"""Segway safe-controller training: LQR fit + barrier adversarial training.

Rebuild of control/train_segway.py:23-216, accelerator-first:

  Phase 1 (:53-67):  fit the MLP controller to the LQR law by MSE on states
    in the Lyapunov band 0.1 <= V <= 0.2 — the reference rejection-samples
    (dynamic shapes); here the rejection is a soft mask inside a jitted step
    (identical objective, static shapes).
  Phase 2 (:96-157): minimise sum relu(Vdot + 0.01) over the banded grid,
    optionally after a 7-step Linf PGD (eps 0.02) on the states; joint Adam
    over controller (lr 0.01) and the Lyapunov matrix P (lr 0.02);
    best-loss checkpointing.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..attacks.pgd import pgd_attack
from ..utils.checkpoint import load_pytree, save_pytree
from .controllers import LinearController, NNController, lqr_gain
from .lyapunov_ctrl import LyaQuadratic
from .samplers import grid_uniform_3d, random_uniform
from .systems import Segway

__all__ = ["SegwayTrainConfig", "train_segway"]


@dataclasses.dataclass
class SegwayTrainConfig:
    adv_train: bool = True
    eps: float = 0.02
    level_lb: float = 0.1
    level_ub: float = 0.2
    region: float = 1.5
    phi_region: float = float(np.pi / 12)
    batch_size: int = 512
    fit_lqr_iters: int = 300
    barrier_iters: int = 300
    grid_r: float = 0.02
    lr_ctrl: float = 0.01
    lr_P: float = 0.02
    margin: float = 0.01
    seed: int = 0
    hidden: int = 32


def train_segway(cfg: SegwayTrainConfig = SegwayTrainConfig(),
                 save_path: Optional[str] = None, verbose: bool = True,
                 resume: bool = False, checkpoint_every: int = 50):
    """``resume=True`` continues from ``save_path + '.resume.pkl'`` (full
    phase/iter/optimizer/PRNG state, written every ``checkpoint_every``
    iterations) — both host-chained loops survive a killed client the way
    the classifier trainer's ``fit(resume=True)`` does."""
    import pathlib

    resume_path = (save_path + ".resume.pkl") if save_path else None
    st = None
    if resume and resume_path and pathlib.Path(resume_path).exists():
        st = load_pytree(resume_path)
    system = Segway()
    goal = jnp.zeros((1, 3))
    Q = 10.0 * np.eye(3)
    R = np.eye(1)
    K, _ = lqr_gain(system, goal, Q, R)
    lqr = LinearController(K)
    key = jax.random.PRNGKey(cfg.seed)
    key, k_init = jax.random.split(key)
    ctrl = NNController.create(k_init, 3, 1, cfg.hidden)
    lya_P0 = jnp.eye(3)
    sizes = jnp.asarray([cfg.phi_region, cfg.region, cfg.region])

    # ---- phase 1: fit LQR inside the band (masked MSE) ----------------------

    tx1 = optax.adam(cfg.lr_ctrl)
    opt1 = tx1.init(ctrl.params)

    @jax.jit
    def fit_step(params, opt_state, key):
        eta = random_uniform(key, sizes, cfg.batch_size)
        v = LyaQuadratic(lya_P0, goal)(eta)[:, 0]
        mask = ((v >= cfg.level_lb) & (v <= cfg.level_ub)).astype(jnp.float32)

        def loss_fn(p):
            out = ctrl.module.apply(p, eta)
            tgt = lqr(eta)
            per = jnp.sum((out - tgt) ** 2, axis=-1)
            return jnp.sum(per * mask) / jnp.maximum(jnp.sum(mask), 1.0)

        loss, g = jax.value_and_grad(loss_fn)(params)
        up, opt_state = tx1.update(g, opt_state, params)
        return optax.apply_updates(params, up), opt_state, loss

    p1_start, l1 = 0, None
    if st is not None and st["phase"] == 1:
        ctrl.params, opt1 = st["ctrl_params"], st["opt1"]
        key = jnp.asarray(st["key"])
        p1_start = int(st["i"])
        if verbose:
            print(f"[segway] resumed phase 1 at iter {p1_start}")
    if st is None or st["phase"] == 1:
        for i in range(p1_start, cfg.fit_lqr_iters):
            key, k = jax.random.split(key)
            ctrl.params, opt1, l1 = fit_step(ctrl.params, opt1, k)
            if (resume_path and checkpoint_every
                    and (i + 1) % checkpoint_every == 0):
                save_pytree(resume_path, {
                    "phase": 1, "i": i + 1, "key": np.asarray(key),
                    "ctrl_params": ctrl.params, "opt1": opt1,
                })
        if verbose and l1 is not None:
            print(f"[segway] LQR fit loss: {float(l1):.5f}")

    # ---- phase 2: barrier training over the banded grid ---------------------

    grid, *_ = grid_uniform_3d(np.asarray(sizes), np.full(3, cfg.grid_r))
    grid = jnp.asarray(grid)

    train_params = {"ctrl": ctrl.params, "P": lya_P0}
    tx2 = optax.multi_transform(
        {"ctrl": optax.adam(cfg.lr_ctrl), "P": optax.adam(cfg.lr_P)},
        {"ctrl": "ctrl", "P": "P"},
    )
    opt2 = tx2.init(train_params)

    def vdot_model(params, eta):
        lya = LyaQuadratic(params["P"], goal)
        u = ctrl.module.apply(params["ctrl"], eta)
        f = system(eta, u)
        return lya.h_dot(eta, f)[:, 0]

    def band_mask(params, eta):
        v = LyaQuadratic(params["P"], goal)(eta)[:, 0]
        return ((v >= cfg.level_lb) & (v <= cfg.level_ub)).astype(jnp.float32)

    @jax.jit
    def barrier_step(params, opt_state, key):
        mask = jax.lax.stop_gradient(band_mask(params, grid))

        if cfg.adv_train:
            def adv_obj(eta):
                return jax.nn.relu(vdot_model(params, eta) + cfg.margin) * mask

            eta_in = pgd_attack(
                adv_obj, grid, key, eps=cfg.eps, norm="Linf", steps=7,
                step_size=2.5 * cfg.eps / 7,
                clip_min=-2 * np.pi, clip_max=2 * np.pi,
            )
            eta_in = jax.lax.stop_gradient(eta_in)
        else:
            eta_in = grid

        def loss_fn(p):
            vd = vdot_model(p, eta_in)
            return jnp.sum(jax.nn.relu(vd + cfg.margin) * mask)

        loss, g = jax.value_and_grad(loss_fn)(params)
        up, opt_state = tx2.update(g, opt_state, params)
        params = optax.apply_updates(params, up)
        return params, opt_state, loss

    @jax.jit
    def worst_vdot(params):
        # diagnostic only — a full extra grid forward, so computed at the
        # logging cadence rather than inside every training step
        mask = band_mask(params, grid)
        return jnp.max(jnp.where(mask > 0, vdot_model(params, grid), -jnp.inf))

    best_loss, best_params = np.inf, train_params
    p2_start = 0
    if st is not None and st["phase"] == 2:
        train_params, opt2 = st["train_params"], st["opt2"]
        best_loss, best_params = float(st["best_loss"]), st["best_params"]
        key = jnp.asarray(st["key"])
        p2_start = int(st["i"])
        if verbose:
            print(f"[segway] resumed phase 2 at iter {p2_start}")
    for i in range(p2_start, cfg.barrier_iters):
        key, k = jax.random.split(key)
        train_params, opt2, loss = barrier_step(train_params, opt2, k)
        l = float(loss)
        if l < best_loss:
            best_loss = l
            best_params = jax.tree_util.tree_map(lambda a: a, train_params)
        if verbose and i % 50 == 0:
            print(f"[segway] iter {i}: loss={l:.5f} "
                  f"worst_vdot={float(worst_vdot(train_params)):.5f}")
        if (resume_path and checkpoint_every
                and (i + 1) % checkpoint_every == 0):
            save_pytree(resume_path, {
                "phase": 2, "i": i + 1, "key": np.asarray(key),
                "train_params": train_params, "opt2": opt2,
                "best_loss": best_loss, "best_params": best_params,
            })

    result = {
        "ctrl": best_params["ctrl"],
        "P": best_params["P"],
        "config": dataclasses.asdict(cfg),
        "K_lqr": np.asarray(K),
        "best_loss": best_loss,
    }
    if save_path:
        save_pytree(save_path, result)
    if verbose:
        print(f"[segway] best barrier loss: {best_loss:.5f}")
    return result
