"""Checkpointing: host pytree save/restore with a best-metric policy.

Rebuild of the reference's Lightning ModelCheckpoint behaviour
(sl_pipeline.py:143-154): keep the single best checkpoint monitored on
validation (adv) error, plus a 'last' for resume; the same raw pytree
save/load serves the non-Lightning paths (grids, control models —
reference th.save usage).  One format everywhere: the pytree with every
leaf converted to a numpy array, pickled (``<name>.pkl``).  Only files
this program wrote are loaded.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import pickle

import jax
import numpy as np

__all__ = ["CheckpointManager", "save_pytree", "load_pytree"]


def _to_host(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)


def save_pytree(path, tree):
    """Simple host-side pytree save (grids, control models, results)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as fh:
        pickle.dump(_to_host(tree), fh)


def load_pytree(path):
    with open(path, "rb") as fh:
        return pickle.load(fh)


class CheckpointManager:
    """Best + last checkpoints under ``run_dir/ckpt``.

    mode='min' keeps the checkpoint with the smallest monitored value
    (validation_error / validation_adv_error in the reference protocol).
    """

    def __init__(self, run_dir: str, monitor: str = "validation_error",
                 mode: str = "min"):
        self.dir = Path(run_dir) / "ckpt"
        self.dir.mkdir(parents=True, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.best: Optional[float] = None
        # re-runs in an existing dir (training resume) must not let a worse
        # epoch steal the 'best' slot: reload the watermark
        best_json = self.dir / "best.json"
        if best_json.exists():
            try:
                self.best = float(json.loads(best_json.read_text())[monitor])
            except (KeyError, ValueError):
                pass

    def _save(self, name: str, tree):
        save_pytree(self.dir / (name + ".pkl"), tree)

    def _load(self, name: str, like=None):
        tree = load_pytree(self.dir / (name + ".pkl"))
        if like is not None:
            # the stored tree must be the one the caller expects: same
            # paths, same leaf shapes
            want = jax.tree_util.tree_structure(like)
            got = jax.tree_util.tree_structure(tree)
            if want != got:
                raise ValueError(f"checkpoint {name}: tree {got} != {want}")
            for a, b in zip(jax.tree_util.tree_leaves(tree),
                            jax.tree_util.tree_leaves(like)):
                if np.shape(a) != np.shape(b):
                    raise ValueError(
                        f"checkpoint {name}: leaf shape {np.shape(a)} != "
                        f"{np.shape(b)}"
                    )
        return tree

    def save_last(self, tree, metrics: dict, step: int):
        self._save("last", tree)
        (self.dir / "last.json").write_text(
            json.dumps({"step": step, **{k: float(v) for k, v in metrics.items()}})
        )

    def maybe_save_best(self, tree, metrics: dict, step: int) -> bool:
        val = float(metrics[self.monitor])
        better = (
            self.best is None
            or (self.mode == "min" and val < self.best)
            or (self.mode == "max" and val > self.best)
        )
        if better:
            self.best = val
            self._save("best", tree)
            (self.dir / "best.json").write_text(
                json.dumps({"step": step, self.monitor: val})
            )
        return better

    def restore(self, name: str = "best", like=None):
        return self._load(name, like)

    # -- mid-run training resume (Lightning resume_from_checkpoint,
    #    sl_pipeline.py ModelCheckpoint 'last' semantics) -----------------
    # Kept as a SEPARATE checkpoint so 'best'/'last' stay {params, step}
    # and every previously written run directory remains restorable.

    def save_resume(self, tree, epoch: int, step: int):
        """Full training state (params + opt_state + PRNG key + counters)."""
        self._save("resume", tree)
        (self.dir / "resume.json").write_text(
            json.dumps({"epoch": int(epoch), "step": int(step)})
        )

    @property
    def has_resume(self) -> bool:
        return (self.dir / "resume.json").exists()

    def resume_meta(self) -> dict:
        return json.loads((self.dir / "resume.json").read_text())

    def restore_resume(self, like=None):
        return self._load("resume", like)
