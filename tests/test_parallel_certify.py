"""Sharded certification sweep: the grid-cell axis partitions across the
data mesh with no resharding of the cell-local work.

The reference certifies on one GPU with Python loops over grid batches
(certify_crown.py:122-153); here the cell axis is a sharded operand of one
jitted program, so the cards certify their chunks concurrently and the
only communication is the final per-image max reduction (an
all-reduce).  These tests pin (a) exact agreement between the sharded and
replicated sweeps and (b) that GSPMD keeps the cell axis partitioned —
no all-gather of cell-sized tensors appears in the compiled HLO."""
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from fiode_tpu.parallel.mesh import make_mesh
from fiode_tpu.verify.crown import crown_mlp_bounds
from fiode_tpu.verify.ibp_qp import ibp_cbf_qp, worst_case_vdot


def _mlp(rng, n=6, m=16):
    Ws = [
        jnp.asarray(rng.normal(size=(m, n)).astype(np.float32)) / np.sqrt(n),
        jnp.asarray(rng.normal(size=(m, m)).astype(np.float32)) / np.sqrt(m),
        jnp.asarray(rng.normal(size=(n, m)).astype(np.float32)) / np.sqrt(m),
    ]
    bs = [jnp.zeros(m), jnp.zeros(m), jnp.zeros(n)]
    x_bias = jnp.asarray(rng.normal(size=(m,)).astype(np.float32))
    return Ws, bs, x_bias


def _chunk_fn(Ws, bs, x_bias, eta):
    lb, ub = crown_mlp_bounds(Ws, bs, eta, 1.0 / 8, x_bias)
    f_lb, f_ub = ibp_cbf_qp(eta, 1.0 / 8, lb, ub, 100.0, 0.02, 20.0)
    return jnp.max(worst_case_vdot(eta, 1.0 / 8, f_lb, f_ub, 2))


class TestShardedCertSweep:
    def test_sharded_matches_replicated_and_stays_sharded(self):
        rng = np.random.default_rng(0)
        Ws, bs, x_bias = _mlp(rng)
        n_cells = 8 * 16
        eta = rng.exponential(size=(n_cells, 6)).astype(np.float32)
        eta /= eta.sum(1, keepdims=True)
        eta = jnp.asarray(eta)

        ref = float(jax.jit(_chunk_fn)(Ws, bs, x_bias, eta))

        mesh = make_mesh(8)
        eta_sh = jax.device_put(eta, NamedSharding(mesh, P("data", None)))
        jitted = jax.jit(_chunk_fn)
        out = float(jitted(Ws, bs, x_bias, eta_sh))
        np.testing.assert_allclose(out, ref, rtol=1e-6)

        # the compiled module must not gather the cell axis back onto one
        # device: cell-local math stays partitioned, only the scalar max
        # communicates
        hlo = jitted.lower(Ws, bs, x_bias, eta_sh).compile().as_text()
        assert "all-gather" not in hlo, "cell axis was replicated"

    def test_image_vmapped_sweep_shards_cells(self):
        # the Certifier's batched kernel: images vmapped, cells sharded
        rng = np.random.default_rng(1)
        Ws, bs, x_bias = _mlp(rng)
        n_img = 3
        x_biases = jnp.stack([x_bias + i for i in range(n_img)])
        labels = jnp.asarray([0, 1, 2], jnp.int32)
        eta = rng.exponential(size=(8 * 8, 6)).astype(np.float32)
        eta /= eta.sum(1, keepdims=True)
        eta = jnp.asarray(eta)

        def sweep(Ws, bs, x_biases, labels, eta):
            def one(xb, lab):
                lb, ub = crown_mlp_bounds(Ws, bs, eta, 1.0 / 8, xb)
                f_lb, f_ub = ibp_cbf_qp(eta, 1.0 / 8, lb, ub, 100.0, 0.02, 20.0)
                return jnp.max(worst_case_vdot(eta, 1.0 / 8, f_lb, f_ub, lab))

            return jax.vmap(one)(x_biases, labels)

        ref = np.asarray(jax.jit(sweep)(Ws, bs, x_biases, labels, eta))
        mesh = make_mesh(8)
        eta_sh = jax.device_put(eta, NamedSharding(mesh, P("data", None)))
        jitted = jax.jit(sweep)
        out = np.asarray(jitted(Ws, bs, x_biases, labels, eta_sh))
        np.testing.assert_allclose(out, ref, rtol=1e-6)
        # the image-vmapped program (the Certifier's real shape) must also
        # keep the cell axis partitioned — values alone would pass even if
        # GSPMD replicated it
        hlo = jitted.lower(Ws, bs, x_biases, labels, eta_sh).compile().as_text()
        assert "all-gather" not in hlo, "cell axis was replicated"

    def test_2d_mesh_shards_images_and_cells(self):
        # 2-D (img x cell) mesh: both long axes of the superchunk
        # partition; the per-image max reduces over the cell axis only
        from fiode_tpu.parallel.mesh import make_mesh2d

        rng = np.random.default_rng(2)
        Ws, bs, x_bias = _mlp(rng)
        n_img = 4
        x_biases = jnp.stack([x_bias + i for i in range(n_img)])
        labels = jnp.asarray([0, 1, 2, 0], jnp.int32)
        eta = rng.exponential(size=(4 * 16, 6)).astype(np.float32)
        eta /= eta.sum(1, keepdims=True)
        eta = jnp.asarray(eta)

        def sweep(Ws, bs, x_biases, labels, eta):
            def one(xb, lab):
                lb, ub = crown_mlp_bounds(Ws, bs, eta, 1.0 / 8, xb)
                f_lb, f_ub = ibp_cbf_qp(eta, 1.0 / 8, lb, ub, 100.0, 0.02, 20.0)
                return jnp.max(worst_case_vdot(eta, 1.0 / 8, f_lb, f_ub, lab))

            return jax.vmap(one)(x_biases, labels)

        ref = np.asarray(jax.jit(sweep)(Ws, bs, x_biases, labels, eta))
        mesh = make_mesh2d(2, 4)
        xb_sh = jax.device_put(
            x_biases, NamedSharding(mesh, P("img", None))
        )
        lab_sh = jax.device_put(labels, NamedSharding(mesh, P("img")))
        eta_sh = jax.device_put(eta, NamedSharding(mesh, P("cell", None)))
        jitted = jax.jit(sweep)
        out = np.asarray(jitted(Ws, bs, xb_sh, lab_sh, eta_sh))
        np.testing.assert_allclose(out, ref, rtol=1e-6)
        hlo = jitted.lower(Ws, bs, xb_sh, lab_sh, eta_sh).compile().as_text()
        assert "all-gather" not in hlo, "an axis was gathered back"

    def test_certifier_2d_mesh_matches_unsharded(self):
        # product path: Certifier(mesh=2-D) must produce the identical
        # verdicts, worst values and audit counts as the unsharded sweep
        from fiode_tpu.models.backbones import TinyMLPBackbone
        from fiode_tpu.models.dynamics import SimplexDynamics
        from fiode_tpu.models.ivp import NeuralODEClassifier
        from fiode_tpu.parallel.mesh import make_mesh2d
        from fiode_tpu.verify.certify import Certifier

        n, x_dim = 3, 6
        dyn = SimplexDynamics(
            n_hidden=n, mlp_size=16, x_dim=x_dim, dropout=0.0,
            alpha_1=100.0, alpha_2=20.0, sigma_1=0.02, cayley=True,
        )
        model = NeuralODEClassifier(
            backbone=TinyMLPBackbone(out_dim=x_dim, hidden=16,
                                     mu=(0.5,), std=(0.25,)),
            dynamics=dyn, n_classes=n,
        )
        x = jax.random.uniform(jax.random.PRNGKey(0), (6, 1, 8, 8))
        params = jax.jit(model.init)(jax.random.PRNGKey(1), x)
        y = np.asarray([0, 1, 2, 0, 1, 2])

        base = Certifier(model, params, T=8, eps_input=0.1, chunk=64)
        mesh = make_mesh2d(2, 4)
        shd = Certifier(model, params, T=8, eps_input=0.1, chunk=64,
                        mesh=mesh)
        for method in ("crown", "lipschitz"):
            r0 = base.certify(np.asarray(x), y, method=method,
                              early_exit=False)
            r1 = shd.certify(np.asarray(x), y, method=method,
                             early_exit=False)
            np.testing.assert_array_equal(r0.certified, r1.certified)
            np.testing.assert_array_equal(r0.clean, r1.clean)
            assert r0.cells_checked == r1.cells_checked
            if method == "lipschitz":
                np.testing.assert_array_equal(
                    r0.larger_T_certified, r1.larger_T_certified
                )

    def test_refine_on_mesh_matches_unsharded(self):
        # the BaB refinement pass shards frontier/cell rows over the mesh's
        # cell axis (verify/refine.py): verdicts and stats must match the
        # unsharded pass exactly
        from fiode_tpu.models.backbones import TinyMLPBackbone
        from fiode_tpu.models.dynamics import SimplexDynamics
        from fiode_tpu.models.ivp import NeuralODEClassifier
        from fiode_tpu.parallel.mesh import make_mesh2d
        from fiode_tpu.verify.certify import Certifier
        from fiode_tpu.verify.refine import refine_uncertified

        n, x_dim = 3, 6
        dyn = SimplexDynamics(
            n_hidden=n, mlp_size=16, x_dim=x_dim, dropout=0.0,
            alpha_1=100.0, alpha_2=20.0, sigma_1=0.02, cayley=True,
        )
        model = NeuralODEClassifier(
            backbone=TinyMLPBackbone(out_dim=x_dim, hidden=16,
                                     mu=(0.5,), std=(0.25,)),
            dynamics=dyn, n_classes=n,
        )
        x = jax.random.uniform(jax.random.PRNGKey(0), (6, 1, 8, 8))
        params = jax.jit(model.init)(jax.random.PRNGKey(1), x)
        y = np.asarray([0, 1, 2, 0, 1, 2])

        base = Certifier(model, params, T=8, eps_input=0.1, chunk=64)
        shd = Certifier(model, params, T=8, eps_input=0.1, chunk=64,
                        mesh=make_mesh2d(2, 4))
        res = base.certify(np.asarray(x), y, method="crown",
                           early_exit=False)
        kw = dict(clean=res.clean, chunk=64, superchunk=4, max_rounds=4,
                  frontier_cap=2048, box_budget=10000)
        c0, s0 = refine_uncertified(base, np.asarray(x), y, res.certified,
                                    **kw)
        c1, s1 = refine_uncertified(shd, np.asarray(x), y, res.certified,
                                    **kw)
        np.testing.assert_array_equal(c0, c1)
        assert [(-s.image, s.base_violated, s.certified) for s in s0] == [
            (-s.image, s.base_violated, s.certified) for s in s1
        ]
