"""Model-layer oracles: orthogonality of Cayley layers, backbone shapes,
simplex forward invariance of the projected dynamics (SURVEY.md §4)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fiode_tpu.models.backbones import KWLargeBackbone, PlainCNNBackbone
from fiode_tpu.models.dynamics import SimplexDynamics, densify_dynamics_params
from fiode_tpu.models.ivp import NeuralODEClassifier
from fiode_tpu.models.layers import CayleyConv, CayleyLinear
from fiode_tpu.ops.cayley import cayley


class TestCayley:
    def test_dense_square_orthogonal(self):
        W = jax.random.normal(jax.random.PRNGKey(0), (16, 16))
        Q = np.asarray(jax.jit(cayley)(W))
        np.testing.assert_allclose(Q @ Q.T, np.eye(16), atol=1e-5)

    def test_dense_tall_semi_orthogonal(self):
        W = jax.random.normal(jax.random.PRNGKey(1), (24, 8))
        Q = np.asarray(jax.jit(cayley)(W))
        np.testing.assert_allclose(Q.T @ Q, np.eye(8), atol=1e-5)

    def test_cayley_linear_norm_preserving(self):
        layer = CayleyLinear(32, use_bias=False)
        x = jax.random.normal(jax.random.PRNGKey(2), (4, 32))
        p = layer.init(jax.random.PRNGKey(3), x)
        y = jax.jit(layer.apply)(p, x)
        np.testing.assert_allclose(
            np.linalg.norm(np.asarray(y), axis=-1),
            np.linalg.norm(np.asarray(x), axis=-1),
            rtol=1e-4,
        )

    def test_cayley_conv_norm_preserving(self):
        layer = CayleyConv(8, 3, use_bias=False)
        x = jax.random.normal(jax.random.PRNGKey(4), (2, 8, 16, 16))
        p = layer.init(jax.random.PRNGKey(5), x)
        y = jax.jit(layer.apply)(p, x)
        nx = np.linalg.norm(np.asarray(x).reshape(2, -1), axis=-1)
        ny = np.linalg.norm(np.asarray(y).reshape(2, -1), axis=-1)
        np.testing.assert_allclose(ny, nx, rtol=1e-4)

    def test_cayley_conv_dft_matches_fft(self):
        # the DFT-matmul path must agree with the fft reference path in
        # value and gradient, including odd spatial sizes and both channel
        # orientations (libs/ortho_conv semi-orthogonal construction)
        from fiode_tpu.ops.cayley import cayley_conv_apply

        rng = np.random.default_rng(0)
        for co, ci, k, n in ((5, 3, 3, 8), (4, 6, 2, 8), (4, 3, 3, 7)):
            W = jnp.asarray(rng.normal(0, 0.1, (co, ci, k, k)).astype(np.float32))
            x = jnp.asarray(rng.normal(0, 1, (4, ci, n, n)).astype(np.float32))
            a = jax.jit(
                lambda x, W: cayley_conv_apply(x, W, jnp.float32(1.2), impl="fft")
            )(x, W)
            b = jax.jit(
                lambda x, W: cayley_conv_apply(x, W, jnp.float32(1.2), impl="dft")
            )(x, W)
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)
            c = jax.jit(
                lambda x, W: cayley_conv_apply(x, W, jnp.float32(1.2), impl="dft1")
            )(x, W)
            np.testing.assert_allclose(np.asarray(a), np.asarray(c), atol=1e-5)
            ga = jax.grad(
                lambda W: cayley_conv_apply(x, W, jnp.float32(1.2), impl="fft").sum()
            )(W)
            gb = jax.grad(
                lambda W: cayley_conv_apply(x, W, jnp.float32(1.2), impl="dft").sum()
            )(W)
            np.testing.assert_allclose(np.asarray(ga), np.asarray(gb), atol=1e-4)
            gc = jax.grad(
                lambda W: cayley_conv_apply(x, W, jnp.float32(1.2), impl="dft1").sum()
            )(W)
            np.testing.assert_allclose(np.asarray(ga), np.asarray(gc), atol=1e-4)
        with pytest.raises(ValueError):
            cayley_conv_apply(x, W, jnp.float32(1.0), impl="nope")

    def test_cayley_conv_stride2_nonexpansive(self):
        layer = CayleyConv(32, 4, stride=2, use_bias=False)
        x = jax.random.normal(jax.random.PRNGKey(6), (2, 8, 16, 16))
        p = layer.init(jax.random.PRNGKey(7), x)
        y = jax.jit(layer.apply)(p, x)
        assert y.shape == (2, 32, 8, 8)
        nx = np.linalg.norm(np.asarray(x).reshape(2, -1), axis=-1)
        ny = np.linalg.norm(np.asarray(y).reshape(2, -1), axis=-1)
        assert np.all(ny <= nx * (1 + 1e-4))


class TestBackbones:
    def test_kwlarge_cifar_shape(self):
        m = KWLargeBackbone(out_dim=10, mu=(0.5, 0.5, 0.5), std=(0.2, 0.2, 0.2))
        x = jnp.zeros((2, 3, 32, 32))
        p = m.init(jax.random.PRNGKey(0), x)
        y = jax.jit(m.apply)(p, x)
        assert y.shape == (2, 10)

    def test_kwlarge_mnist_shape(self):
        m = KWLargeBackbone(out_dim=10, mu=(0.1307,), std=(0.3081,))
        x = jnp.zeros((2, 1, 28, 28))
        p = m.init(jax.random.PRNGKey(0), x)
        y = jax.jit(m.apply)(p, x)
        assert y.shape == (2, 10)

    def test_plain_cnn_shapes(self):
        for arch in ("4C3F", "6C2F"):
            m = PlainCNNBackbone(arch=arch, out_dim=10,
                                 mu=(0.5,) * 3, std=(0.2,) * 3)
            x = jnp.zeros((2, 3, 32, 32))
            p = m.init(jax.random.PRNGKey(0), x)
            y = jax.jit(m.apply)(p, x)
            assert y.shape == (2, 10)


def make_tiny_model(n=3, x_dim=4):
    dyn = SimplexDynamics(
        n_hidden=n, mlp_size=16, x_dim=x_dim, alpha_1=100.0, alpha_2=20.0,
        sigma_1=0.02, dropout=0.0, cayley=True,
    )
    model = NeuralODEClassifier(
        backbone=None, dynamics=dyn, n_classes=n, t_max=1.0,
    )
    x = jax.random.uniform(jax.random.PRNGKey(0), (5, x_dim))
    params = model.init(jax.random.PRNGKey(1), x)
    return model, params, x


class TestDynamics:
    def test_projected_dot_is_tangent(self):
        model, params, x = make_tiny_model()
        h = model.h0(x.shape[0])
        f = jax.jit(lambda p, h, x: model.eval_dot(p, h, x))(params, h, x)
        # tangent to the simplex: components sum to zero
        np.testing.assert_allclose(np.asarray(f).sum(-1), 0.0, atol=1e-4)

    def test_forward_invariance(self):
        model, params, x = make_tiny_model()
        traj = jax.jit(lambda p, x: model.trajectory(p, x, n_points=20))(
            params, x
        )
        t = np.asarray(traj)
        np.testing.assert_allclose(t.sum(-1), 1.0, atol=5e-3)
        assert t.min() >= -5e-3, f"left the simplex: min={t.min()}"

    def test_predict_shape_and_simplex(self):
        model, params, x = make_tiny_model()
        probs = jax.jit(lambda p, x: model.predict(p, x))(params, x)
        assert probs.shape == (5, 3)
        np.testing.assert_allclose(np.asarray(probs).sum(-1), 1.0, atol=1e-3)

    def test_densify_matches_cayley_raw(self):
        model, params, x = make_tiny_model()
        h = model.h0(x.shape[0])
        raw = jax.jit(lambda p, h, x: model.raw_dot(p, h, x))(params, h, x)
        dense = densify_dynamics_params(params["dynamics"])

        def dense_raw(h, x):
            z = h @ dense["hidden_to_mlp"]["kernel"].T + dense["hidden_to_mlp"]["bias"]
            z = z + x @ dense["U_x"]["kernel"].T + dense["U_x"]["bias"]
            z = jax.nn.relu(z)
            z = z @ dense["mlp_to_mlp"]["kernel"].T + dense["mlp_to_mlp"]["bias"]
            z = jax.nn.relu(z)
            z = z @ dense["mlp_to_hidden"]["kernel"].T + dense["mlp_to_hidden"]["bias"]
            return z

        np.testing.assert_allclose(
            np.asarray(raw), np.asarray(jax.jit(dense_raw)(h, x)), atol=1e-5
        )

    def test_scan_mode_training_gradient(self):
        model, params, x = make_tiny_model()
        y = jnp.asarray([0, 1, 2, 0, 1])

        @jax.jit
        def loss(params):
            sol = model.solve(params, x, mode="scan")
            probs = sol.ys[-1]
            return -jnp.mean(
                jnp.log(jnp.clip(probs[jnp.arange(5), y], 1e-12))
            )

        g = jax.grad(loss)(params)
        leaves = jax.tree_util.tree_leaves(g)
        assert all(np.all(np.isfinite(np.asarray(l))) for l in leaves)
        assert any(float(jnp.abs(l).max()) > 0 for l in leaves)


class TestCachedBackboneTwins:
    def test_cached_twin_matches_train_backbone(self):
        """_test variants (reference models.py:154-165): precomputed-Cayley
        twin must reproduce the train backbone's outputs exactly."""
        from fiode_tpu.models.backbones import make_backbone
        from fiode_tpu.models.layers import cache_cayley_params

        kw = dict(out_dim=8, act="GroupSort", mu=(0.5,), std=(0.25,))
        train_bb = make_backbone("ORTHO_KWLarge_Concat", **kw)
        test_bb = make_backbone("ORTHO_KWLarge_Concat_test", **kw)
        x = jax.random.uniform(jax.random.PRNGKey(0), (2, 3, 8, 8))
        params = jax.jit(train_bb.init)(jax.random.PRNGKey(1), x)
        cached = jax.jit(
            lambda p: cache_cayley_params(test_bb, p, x)
        )(params)
        y_train = jax.jit(train_bb.apply)(params, x)
        y_test = jax.jit(test_bb.apply)(cached, x)
        np.testing.assert_allclose(
            np.asarray(y_train), np.asarray(y_test), atol=1e-4
        )

    def test_uncached_twin_fails_loudly(self):
        """A cached twin used WITHOUT cache_cayley_params must produce NaN
        (not silent zeros) so the misuse surfaces at the first forward."""
        from fiode_tpu.models.backbones import make_backbone

        bb = make_backbone(
            "ORTHO_KWLarge_Concat_test", out_dim=8, act="GroupSort",
            mu=(0.5,), std=(0.25,),
        )
        x = jax.random.uniform(jax.random.PRNGKey(0), (2, 3, 8, 8))
        params = jax.jit(bb.init)(jax.random.PRNGKey(1), x)
        y = jax.jit(bb.apply)(params, x)
        assert np.isnan(np.asarray(y)).any()

    def test_inter_variant_exposes_intermediate_features(self):
        from fiode_tpu.models.backbones import make_backbone

        bb = make_backbone(
            "ORTHO_KWLarge_inter", out_dim=8, act="GroupSort",
            mu=(0.5,), std=(0.25,),
        )
        x = jax.random.uniform(jax.random.PRNGKey(0), (2, 3, 8, 8))
        params = jax.jit(bb.init)(jax.random.PRNGKey(1), x)
        y = jax.jit(bb.apply)(params, x)
        assert y.shape == (2, 512)  # penultimate width, not out_dim
