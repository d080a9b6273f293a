"""Objective modes (ode / classical), Lipschitz-aware kappa training, and the
linear output readout."""
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fiode_tpu.models.backbones import PlainCNNBackbone, TinyMLPBackbone
from fiode_tpu.models.dynamics import SimplexDynamics
from fiode_tpu.models.ivp import NeuralODEClassifier
from fiode_tpu.train.data import load_dataset
from fiode_tpu.train.lips import compute_lfx, lfx_init
from fiode_tpu.train.trainer import LyapunovTrainer, TrainConfig


def make_trainer(tmp_path, **cfg_kw):
    ds = load_dataset("MNIST", data_root=str(tmp_path / "nope"), synthetic_size=512)
    dyn = SimplexDynamics(
        n_hidden=10, mlp_size=32, x_dim=10, dropout=0.1,
        alpha_1=100.0, alpha_2=20.0, sigma_1=0.02, kappa=2.0,
        kappa_length=0, cayley=False, scale_nominal=False,
    )
    model = NeuralODEClassifier(
        backbone=TinyMLPBackbone(out_dim=10, hidden=32,
                                 mu=(0.1307,), std=(0.3081,)),
        dynamics=dyn, n_classes=10, t_max=1.0, max_steps=64,
    )
    cfg = TrainConfig(
        batch_size=64, val_batch_size=128, h_sample_size=8,
        max_epochs=1, lr=5e-3, log_every=2, **cfg_kw,
    )
    return LyapunovTrainer(model, cfg, ds, run_dir=str(tmp_path / "run"))


class TestObjectives:
    def test_ode_objective_trains(self, tmp_path):
        tr = make_trainer(tmp_path, objective="ode")
        tr.fit(epochs=1)
        recs = [json.loads(l) for l in open(tmp_path / "run" / "metrics.jsonl")]
        losses = [r["training_loss"] for r in recs if "training_loss" in r]
        assert losses and all(np.isfinite(losses))

    def test_classical_objective_trains(self, tmp_path):
        tr = make_trainer(tmp_path, objective="classical")
        tr.fit(epochs=1)
        recs = [json.loads(l) for l in open(tmp_path / "run" / "metrics.jsonl")]
        losses = [r["training_loss"] for r in recs if "training_loss" in r]
        assert losses[-1] < losses[0]
        # validation must score the BACKBONE (the trained model), not the
        # untrained ODE: nfe 0 marks the no-solve eval path
        vals = [r for r in recs if "val_nfe" in r]
        assert vals and vals[-1]["val_nfe"] == 0.0


class TestLipsTrain:
    def test_lfx_product_sound(self):
        # Lfx estimate must upper-approximate the empirical Lipschitz ratio
        bb = PlainCNNBackbone(arch="4C3F", out_dim=10, act="ReLU",
                              mu=(0.5,) * 3, std=(0.25,) * 3)
        x = jax.random.uniform(jax.random.PRNGKey(0), (4, 3, 32, 32))
        params = bb.init(jax.random.PRNGKey(1), x)
        us = lfx_init(bb, params, (3, 32, 32), jax.random.PRNGKey(2))
        Lfx, us = jax.jit(
            lambda p, u: compute_lfx(bb, p, u, (3, 32, 32), n_iter=30)
        )(params, us)
        Lfx = float(Lfx)
        assert Lfx > 0
        # empirical check: |f(x+d)-f(x)| <= (Lfx / min std) |d|
        f = lambda x: bb.apply(params, x)
        d = 1e-3 * jax.random.normal(jax.random.PRNGKey(3), x.shape)
        num = float(jnp.linalg.norm(f(x + d) - f(x)))
        den = float(jnp.linalg.norm(d))
        assert num / den <= (Lfx / 0.25) * 1.05

    def test_lips_train_step_runs(self, tmp_path):
        tr = make_trainer(tmp_path, lips_train=True, lips_warmup=0)
        tr.fit(epochs=1)
        recs = [json.loads(l) for l in open(tmp_path / "run" / "metrics.jsonl")]
        lips = [r["Lips"] for r in recs if "Lips" in r]
        kappas = [r["kappa"] for r in recs if "kappa" in r]
        assert lips and all(l > 0 for l in lips)
        # Lipschitz-aware kappa = max(...) + 1 > plain kappa path
        assert all(k >= 1.0 for k in kappas if k == k)


class TestLinearOutput:
    def test_linear_readout(self):
        dyn = SimplexDynamics(n_hidden=6, mlp_size=16, x_dim=4, dropout=0.0)
        model = NeuralODEClassifier(
            backbone=None, dynamics=dyn, n_classes=3, output="linear",
        )
        x = jax.random.uniform(jax.random.PRNGKey(0), (5, 4))
        params = model.init(jax.random.PRNGKey(1), x)
        assert "output" in params
        probs = jax.jit(lambda p, x: model.predict(p, x))(params, x)
        assert probs.shape == (5, 3)
