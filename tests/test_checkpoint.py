"""Checkpoints need only numpy: a save/restore round trip, shape and
structure checks against the caller's template, and the committed
checkpoint restored through the path ``certify-crown --run-dir`` uses —
whose parameter paths are the ones the functional modules create and the
Certifier reads."""
from pathlib import Path

import jax
import numpy as np
import pytest

from fiode_tpu.utils.checkpoint import CheckpointManager

REPO = Path(__file__).resolve().parents[1]


def _paths(tree):
    return [jax.tree_util.keystr(k)
            for k, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


class TestRoundTrip:
    def test_save_restore(self, tmp_path):
        tree = {"params": {"a": {"kernel": np.arange(6.0).reshape(2, 3)},
                           "b": np.float32(2.0)}, "step": 7}
        m = CheckpointManager(str(tmp_path))
        m.save_last(tree, {"validation_error": 0.5}, step=7)
        got = m.restore("last", like=tree)
        assert _paths(got) == _paths(tree)
        np.testing.assert_array_equal(got["params"]["a"]["kernel"],
                                      tree["params"]["a"]["kernel"])
        assert int(got["step"]) == 7

    def test_template_mismatch_raises(self, tmp_path):
        m = CheckpointManager(str(tmp_path))
        m.save_last({"w": np.ones((2, 3))}, {"validation_error": 0.5}, 0)
        with pytest.raises(ValueError, match="shape"):
            m.restore("last", like={"w": np.ones((3, 2))})
        with pytest.raises(ValueError, match="tree"):
            m.restore("last", like={"v": np.ones((2, 3))})


class TestCommittedCheckpoint:
    @pytest.fixture(scope="class")
    def restored(self):
        from fiode_tpu.experiment import _restore_params, build_model
        from fiode_tpu.utils.config import compose

        cfg = compose("cifar_certify.yaml", [],
                      str(REPO / "configs/certify"))
        model = build_model(cfg)
        params = _restore_params(cfg, model,
                                 str(REPO / "run_data/certified_full"))
        return model, params

    def test_restores_with_the_models_parameter_paths(self, restored):
        model, params = restored
        like = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                              jax.ShapeDtypeStruct((1, 3, 32, 32),
                                                   np.float32))
        assert _paths(params) == _paths(like)
        for a, b in zip(jax.tree_util.tree_leaves(params),
                        jax.tree_util.tree_leaves(like)):
            assert np.shape(a) == b.shape
        assert all(np.all(np.isfinite(a))
                   for a in jax.tree_util.tree_leaves(params))

    def test_certifier_reads_the_dynamics_layers(self, restored):
        from fiode_tpu.models.dynamics import densify_dynamics_params

        _, params = restored
        dyn = params["dynamics"]
        assert sorted(dyn) == ["U_x", "hidden_to_mlp", "mlp_to_hidden",
                               "mlp_to_mlp"]
        dense = densify_dynamics_params(dyn)
        assert dense["hidden_to_mlp"]["kernel"].shape == (128, 10)
        assert dense["mlp_to_mlp"]["kernel"].shape == (128, 128)
        assert dense["mlp_to_hidden"]["kernel"].shape == (10, 128)


class TestModuleParameterPaths:
    @pytest.mark.parametrize("cayley,leaves", [
        (True, ["alpha", "bias", "weight"]),
        (False, ["bias", "kernel"]),
    ])
    def test_dynamics_paths(self, cayley, leaves):
        from fiode_tpu.models.dynamics import SimplexDynamics

        dyn = SimplexDynamics(n_hidden=10, mlp_size=16, x_dim=6,
                              cayley=cayley)
        p = dyn.init(jax.random.PRNGKey(0), np.zeros((2, 10), np.float32),
                     np.zeros((2, 6), np.float32))
        assert sorted(p) == ["U_x", "hidden_to_mlp", "mlp_to_hidden",
                             "mlp_to_mlp"]
        assert all(sorted(v) == leaves for v in p.values())
