"""Fused-RHS oracles: the Triton kernel (Pallas interpreter on the CPU,
compiled on the card) matches the plain-jnp reference and the dynamics
module, its gradient is the reference's VJP, and a fused solve reproduces
the plain solve, its NFE and its gradients."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fiode_tpu.models.dynamics import SimplexDynamics
from fiode_tpu.models.ivp import NeuralODEClassifier
from fiode_tpu.models.backbones import TinyMLPBackbone
from fiode_tpu.ops.fused_rhs import (
    BLOCK,
    fused_rhs,
    masked_cone_project,
    pack_rhs_params,
    pad_width,
    rhs_reference,
)
from fiode_tpu.ops.simplex_qp import simplex_cone_project

NP = pad_width(10)


def make_model(n=10, x_dim=10, mlp=32, scale_nominal=False):
    dyn = SimplexDynamics(
        n_hidden=n, mlp_size=mlp, x_dim=x_dim, dropout=0.0,
        alpha_1=100.0, alpha_2=20.0, sigma_1=0.02,
        scale_nominal=scale_nominal, cayley=True,
    )
    model = NeuralODEClassifier(
        backbone=TinyMLPBackbone(out_dim=x_dim, hidden=16,
                                 mu=(0.5,), std=(0.25,)),
        dynamics=dyn, n_classes=n,
    )
    x = jax.random.uniform(jax.random.PRNGKey(0), (6, 1, 8, 8))
    params = model.init(jax.random.PRNGKey(1), x)
    return model, params, x


def packed(n=10, mlp=128, B=37, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 7)
    W1 = 0.3 * jax.random.normal(ks[0], (mlp, n))
    W2 = 0.1 * jax.random.normal(ks[1], (mlp, mlp))
    W3 = 0.1 * jax.random.normal(ks[2], (n, mlp))
    b2 = 0.1 * jax.random.normal(ks[3], (mlp,))
    b3 = 0.1 * jax.random.normal(ks[4], (n,))
    p = pack_rhs_params(W1, W2, W3, b2, b3)
    h = jax.random.uniform(ks[5], (B, n))
    h = h / h.sum(-1, keepdims=True)
    h_pad = jnp.zeros((B, pad_width(n))).at[:, :n].set(h)
    xc = 0.5 * jax.random.normal(ks[6], (B, pad_width(mlp)))
    return h_pad, xc, p, n


class TestMaskedProjection:
    def test_matches_unmasked(self):
        key = jax.random.PRNGKey(0)
        n = 10
        h = jax.random.uniform(key, (8, n))
        h = h / h.sum(-1, keepdims=True)
        lower = -100.0 * (jnp.exp(0.02 * h) - 1.0)
        nominal = jax.random.normal(jax.random.PRNGKey(1), (8, n))
        v_ref = simplex_cone_project(lower, nominal, 40)

        low_p = jnp.zeros((8, NP)).at[:, :n].set(lower)
        nom_p = jnp.zeros((8, NP)).at[:, :n].set(nominal)
        mask = (jnp.arange(NP) < n)[None, :] & jnp.ones((8, 1), bool)
        v_pad = masked_cone_project(low_p, nom_p, mask, 40)
        np.testing.assert_allclose(
            np.asarray(v_pad[:, :n]), np.asarray(v_ref), atol=1e-4
        )
        assert np.abs(np.asarray(v_pad[:, n:])).max() == 0.0

    def test_masked_gradients_match(self):
        key = jax.random.PRNGKey(2)
        n = 6
        h = jax.random.uniform(key, (4, n))
        h = h / h.sum(-1, keepdims=True)
        lower = -100.0 * (jnp.exp(0.02 * h) - 1.0)
        nominal = jax.random.normal(jax.random.PRNGKey(3), (4, n))
        w = jnp.arange(1.0, n + 1.0)

        g_ref = jax.grad(
            lambda nom: jnp.sum(
                jnp.sin(simplex_cone_project(lower, nom, 40)) * w
            )
        )(nominal)

        low_p = jnp.zeros((4, NP)).at[:, :n].set(lower)
        mask = jnp.broadcast_to((jnp.arange(NP) < n)[None, :], (4, NP))

        def loss_pad(nom):
            nom_p = jnp.zeros((4, NP)).at[:, :n].set(nom)
            v = masked_cone_project(low_p, nom_p, mask, 40)
            return jnp.sum(jnp.sin(v[:, :n]) * w)

        g_pad = jax.grad(loss_pad)(nominal)
        np.testing.assert_allclose(np.asarray(g_pad), np.asarray(g_ref),
                                   atol=1e-4)


class TestKernel:
    """The Triton kernel through the Pallas interpreter."""

    @pytest.mark.parametrize("B", [37, 2 * BLOCK + 5])
    @pytest.mark.parametrize("scale_nominal", [False, True])
    def test_interpret_matches_reference(self, B, scale_nominal):
        # B is not a multiple of the block: fused_rhs pads the rows
        h_pad, xc, p, n = packed(B=B)
        got = jax.jit(
            lambda h, xc, p: fused_rhs(h, xc, p, n, 100.0, 0.02, 20.0,
                                       scale_nominal, 30, BLOCK)
        )(h_pad, xc, p)
        want = rhs_reference(h_pad, xc, p, n, 100.0, 0.02, 20.0,
                             scale_nominal)
        assert got.shape == (B, NP)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-5)
        assert np.abs(np.asarray(got[:, n:])).max() == 0.0

    def test_vjp_is_reference_vjp(self):
        h_pad, xc, p, n = packed(B=37)
        g = jax.random.normal(jax.random.PRNGKey(3), h_pad.shape)
        g = g * (jnp.arange(NP) < n)[None, :]
        _, vjp_k = jax.vjp(
            lambda h, xc, pp: fused_rhs(h, xc, pp, n, 100.0, 0.02, 20.0,
                                        False, 30, BLOCK),
            h_pad, xc, p,
        )
        _, vjp_r = jax.vjp(
            lambda h, xc, pp: rhs_reference(h, xc, pp, n, 100.0, 0.02, 20.0,
                                            False, 30),
            h_pad, xc, p,
        )
        for a, b in zip(jax.tree_util.tree_leaves(vjp_k(g)),
                        jax.tree_util.tree_leaves(vjp_r(g))):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       atol=1e-6)

    def test_pack_layout(self):
        W1 = jnp.ones((32, 10))
        W2 = 2 * jnp.ones((32, 32))
        W3 = 3 * jnp.ones((10, 32))
        p = pack_rhs_params(W1, W2, W3, jnp.ones(32), jnp.ones(10))
        assert p.W1t.shape == (16, 32) and p.W2t.shape == (32, 32)
        assert p.W3t.shape == (32, 16) and p.b3.shape == (16,)
        assert float(p.W1t[:10].min()) == 1.0 and float(p.W1t[10:].max()) == 0.0
        assert float(p.W3t[:, 10:].max()) == 0.0
        assert [pad_width(k) for k in (3, 10, 16, 17, 128)] == [16, 16, 16, 32, 128]


class TestFusedVsPlain:
    @pytest.mark.parametrize("scale_nominal", [False, True])
    def test_rhs_matches_dynamics(self, scale_nominal):
        model, params, x = make_model(scale_nominal=scale_nominal)
        n = model.dynamics.n_hidden
        feats = model.features(params, x)
        h = model.h0(x.shape[0]) + 0.01 * jax.random.normal(
            jax.random.PRNGKey(5), (x.shape[0], n)
        )
        h = jnp.abs(h) / jnp.abs(h).sum(-1, keepdims=True)
        f_dyn = model.eval_dot(params, h, feats, scale_nominal=scale_nominal)

        p, xc = model._fused_setup(params, feats)
        h_pad = jnp.zeros((x.shape[0], NP)).at[:, :n].set(h)
        f_pad = fused_rhs(h_pad, xc, p, n, 100.0, 0.02, 20.0, scale_nominal,
                          30, BLOCK)
        np.testing.assert_allclose(
            np.asarray(f_pad[:, :n]), np.asarray(f_dyn), atol=2e-4
        )

    def test_fused_solve_matches_unfused(self):
        model, params, x = make_model()
        s1 = jax.jit(
            lambda p, x: model.solve(p, x, mode="while", fused=False)
        )(params, x)
        s2 = jax.jit(
            lambda p, x: model.solve(p, x, mode="while", fused=True)
        )(params, x)
        np.testing.assert_allclose(
            np.asarray(s1.ys[-1]), np.asarray(s2.ys[-1]), atol=1e-3
        )
        # padded rows and lanes carry no error weight: identical step
        # control decisions => identical NFE
        assert int(s1.nfe) == int(s2.nfe)

    def test_fused_scan_gradients(self):
        model, params, x = make_model()
        y = jnp.asarray([0, 1, 2, 3, 4, 5])

        def loss(params, fused):
            sol = model.solve(params, x, mode="scan", fused=fused)
            probs = sol.ys[-1]
            p_y = jnp.take_along_axis(
                jnp.clip(probs, 1e-12), y[:, None], axis=-1
            )
            return -jnp.mean(jnp.log(p_y))

        g1 = jax.jit(jax.grad(lambda p: loss(p, False)))(params)
        g2 = jax.jit(jax.grad(lambda p: loss(p, True)))(params)
        for a, b in zip(jax.tree_util.tree_leaves(g1),
                        jax.tree_util.tree_leaves(g2)):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), atol=5e-3
            )

    @pytest.mark.parametrize("platform,kernel", [("cpu", False),
                                                 ("cuda", True)])
    def test_default_is_chosen_per_platform(self, platform, kernel):
        # solve(fused=None) lowers the Triton kernel for CUDA and the plain
        # RHS for the CPU; the choice is made at lowering, not by the
        # process's default backend
        model, params, x = make_model()
        text = jax.jit(lambda p, x: model.solve(p, x)).trace(
            params, x).lower(lowering_platforms=(platform,)).as_text()
        assert ("triton" in text) is kernel
        plain = jax.jit(lambda p, x: model.solve(p, x, fused=False)).trace(
            params, x).lower(lowering_platforms=("cuda",)).as_text()
        assert "triton" not in plain
        # at float32 matmul precision the plain RHS is lowered everywhere
        with jax.default_matmul_precision("float32"):
            f32 = jax.jit(lambda p, x: model.solve(p, x)).trace(
                params, x).lower(lowering_platforms=("cuda",)).as_text()
        assert "triton" not in f32

    def test_other_platforms_fail_to_lower(self):
        model, params, x = make_model()
        with pytest.raises(NotImplementedError):
            jax.jit(lambda p, x: model.solve(p, x)).trace(params, x).lower(
                lowering_platforms=("rocm",))


@pytest.mark.gpu
class TestOnCard:
    """The compiled kernel at the flagship's width and the bench's batch."""

    @pytest.mark.parametrize("precision,tol", [
        # TF32 rounding (10-bit mantissa) differs between the kernel's dot
        # and cuBLAS: ~1e-3 on these O(1) values
        ("default", 5e-3),
        ("highest", 1e-5),
    ])
    def test_kernel_matches_reference(self, gpu, precision, tol):
        h_pad, xc, p, n = packed(B=32768 + 3)
        with jax.default_matmul_precision(precision):
            got = jax.jit(
                lambda h, xc, p: fused_rhs(h, xc, p, n, 100.0, 0.02, 20.0,
                                           False, 30)
            )(h_pad, xc, p)
            want = jax.jit(
                lambda h, xc, p: rhs_reference(h, xc, p, n, 100.0, 0.02,
                                               20.0, False)
            )(h_pad, xc, p)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=tol)

    def test_fused_solve_matches_plain(self, gpu):
        model, params, x = make_model()
        with jax.default_matmul_precision("highest"):
            s1 = jax.jit(lambda p, x: model.solve(p, x, fused=False))(params, x)
            s2 = jax.jit(lambda p, x: model.solve(p, x, fused=True))(params, x)
        np.testing.assert_allclose(np.asarray(s1.ys[-1]),
                                   np.asarray(s2.ys[-1]), atol=1e-5)
        assert int(s1.nfe) == int(s2.nfe)
