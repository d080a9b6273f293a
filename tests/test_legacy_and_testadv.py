"""Legacy conv-dynamics family integrates under the ODE stack, and the
test-time AutoAttack evaluation path runs."""
import numpy as np
import jax
import jax.numpy as jnp

from fiode_tpu.models.legacy_dynamics import (
    ConvBlockDynamics,
    DynBasicBlock,
    ResNetOutput,
)
from fiode_tpu.ode.integrate import odeint


class TestLegacyConvDynamics:
    def test_conv_dynamics_ode(self):
        dyn = ConvBlockDynamics(features=8)
        x = jax.random.uniform(jax.random.PRNGKey(0), (2, 3, 8, 8))
        h0_shape = (2, 8, 8, 8)
        params = dyn.init(
            jax.random.PRNGKey(1), jnp.zeros(h0_shape), x,
        )

        def f(t, h, args):
            return dyn.apply(params, h, x)

        h0 = dyn.state_init(params, x)
        assert h0.shape == h0_shape
        sol = jax.jit(
            lambda h0: odeint(
                f, h0, jnp.asarray([0.0, 0.5]), method="rk4", step_size=0.1
            )
        )(h0)
        assert sol.ys.shape == (2,) + h0_shape
        assert np.isfinite(np.asarray(sol.ys)).all()

    def test_resnet_output(self):
        out = ResNetOutput(n_classes=10)
        h = jax.random.normal(jax.random.PRNGKey(0), (2, 8, 4, 4))
        p = out.init(jax.random.PRNGKey(1), h)
        logits = out.apply(p, h)
        assert logits.shape == (2, 10)


class TestTestAutoattack:
    def test_trainer_test_autoattack(self, tmp_path):
        from fiode_tpu.models.backbones import TinyMLPBackbone
        from fiode_tpu.models.dynamics import SimplexDynamics
        from fiode_tpu.models.ivp import NeuralODEClassifier
        from fiode_tpu.train.data import load_dataset
        from fiode_tpu.train.trainer import LyapunovTrainer, TrainConfig

        ds = load_dataset("MNIST", data_root=str(tmp_path / "none"), synthetic_size=512)
        dyn = SimplexDynamics(n_hidden=10, mlp_size=16, x_dim=10,
                              dropout=0.0, cayley=False)
        model = NeuralODEClassifier(
            backbone=TinyMLPBackbone(out_dim=10, hidden=16,
                                     mu=(0.1307,), std=(0.3081,)),
            dynamics=dyn, n_classes=10, max_steps=64,
        )
        cfg = TrainConfig(batch_size=32, val_batch_size=64,
                          h_sample_size=4, max_epochs=1)
        tr = LyapunovTrainer(model, cfg, ds, run_dir=str(tmp_path / "run"))
        params = model.init(jax.random.PRNGKey(0),
                            jnp.asarray(ds.train_x[:32]))
        res = tr.test_autoattack(
            params, jax.random.PRNGKey(1), attacks=("apgd-ce",),
            max_batches=1, n_iter=5,
        )
        assert 0.0 <= res["test_error_clean"] <= 1.0
        assert res["test_error_adv"] >= res["test_error_clean"] - 1e-6
