"""Verification-layer oracles (SURVEY.md §4): grid counts vs an independent
recurrence, CROWN soundness by fuzzing (bounds must contain sampled values,
and be tighter than IBP), QP interval propagation soundness, and an
end-to-end certification run on a tiny model."""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fiode_tpu.models.backbones import TinyMLPBackbone
from fiode_tpu.models.dynamics import SimplexDynamics, barrier_bounds
from fiode_tpu.models.ivp import NeuralODEClassifier
from fiode_tpu.ops.simplex_qp import simplex_cone_project
from fiode_tpu.verify.certify import Certifier
from fiode_tpu.verify.crown import crown_mlp_bounds, ibp_mlp_bounds
from fiode_tpu.verify.grid import (
    count_decision_boundary,
    enumerate_decision_boundary,
    grid_for_label,
)
from fiode_tpu.verify.ibp_qp import (
    ibp_cbf_qp,
    ibp_cbf_qp_band,
    ibp_cbf_qp_individual,
    worst_case_vdot,
)


def reference_count(n, T):
    """Independent reimplementation of the reference's counting recurrence
    (eval_utils.py:72-89) as a parity oracle."""
    f = [[0] * (n + 1) for _ in range(T + 1)]
    for j in range(T + 1):
        for k in range(n + 1):
            if j == 0:
                f[j][k] = 1
            elif k < 2 or j == 1:
                f[j][k] = 0
            elif k == 2:
                f[j][k] = 1 if j % 2 == 0 else 0
            else:
                for l in range(k - 1):
                    if j - k + l >= 0:
                        f[j][k] += f[j - k + l][k - l] * math.comb(k - 1, l)
    return f[T][n]


class TestGrid:
    @pytest.mark.parametrize("n,T", [(3, 6), (4, 8), (5, 10), (10, 12)])
    def test_count_matches_reference_recurrence(self, n, T):
        assert count_decision_boundary(n, T) == reference_count(n, T)

    def test_enumeration_properties(self):
        g = enumerate_decision_boundary(5, 10)
        assert len(g) == count_decision_boundary(5, 10)
        gi = (g * 10).round().astype(int)
        np.testing.assert_array_equal(gi.sum(-1), 10)
        assert (gi[:, 0] == gi[:, 1:].max(-1)).all()
        # no duplicates
        assert len({tuple(r) for r in gi}) == len(gi)

    def test_grid_for_label_swaps(self):
        g = enumerate_decision_boundary(4, 8)
        g2 = grid_for_label(g, 2)
        gi = (g2 * 8).round().astype(int)
        others = np.delete(gi, 2, axis=1)
        assert (gi[:, 2] == others.max(-1)).all()


def random_mlp(key, n=6, m=16):
    ks = jax.random.split(key, 7)
    Ws = [
        0.5 * jax.random.normal(ks[0], (m, n)),
        0.5 * jax.random.normal(ks[1], (m, m)) / np.sqrt(m),
        0.5 * jax.random.normal(ks[2], (n, m)) / np.sqrt(m),
    ]
    bs = [
        0.1 * jax.random.normal(ks[3], (m,)),
        0.1 * jax.random.normal(ks[4], (m,)),
        0.1 * jax.random.normal(ks[5], (n,)),
    ]
    x_bias = jax.random.normal(ks[6], (m,))
    return Ws, bs, x_bias


def mlp_forward(Ws, bs, x_bias, eta):
    z = eta @ Ws[0].T + bs[0] + x_bias
    z = jax.nn.relu(z)
    z = z @ Ws[1].T + bs[1]
    z = jax.nn.relu(z)
    return z @ Ws[2].T + bs[2]


class TestCrown:
    def test_soundness_and_tighter_than_ibp(self):
        key = jax.random.PRNGKey(0)
        Ws, bs, x_bias = random_mlp(key)
        eta0 = jax.random.uniform(jax.random.PRNGKey(1), (32, 6))
        eta0 = eta0 / eta0.sum(-1, keepdims=True)
        eps = 0.05
        lb, ub = jax.jit(
            lambda: crown_mlp_bounds(Ws, bs, eta0, eps, x_bias)
        )()
        il, iu = jax.jit(
            lambda: ibp_mlp_bounds(Ws, bs, eta0, eps, x_bias)
        )()
        lb, ub, il, iu = map(np.asarray, (lb, ub, il, iu))
        # CROWN within IBP (never looser)
        assert (lb >= il - 1e-4).all()
        assert (ub <= iu + 1e-4).all()
        assert (lb <= ub + 1e-6).all()
        # fuzz: sampled values inside bounds
        key = jax.random.PRNGKey(2)
        worst_gap = np.inf
        for _ in range(20):
            key, k = jax.random.split(key)
            d = jax.random.uniform(k, eta0.shape, minval=-eps, maxval=eps)
            f = np.asarray(mlp_forward(Ws, bs, x_bias, eta0 + d))
            assert (f >= lb - 1e-4).all(), "CROWN lower bound violated"
            assert (f <= ub + 1e-4).all(), "CROWN upper bound violated"
            worst_gap = min(worst_gap, float((ub - f).min()))
        # bounds are not vacuous: something comes close to the bound
        assert worst_gap < 1.0

    def test_alpha_crown_sound_for_any_slopes_and_tighter_optimized(self):
        from fiode_tpu.verify.crown import optimize_crown_alphas

        key = jax.random.PRNGKey(3)
        Ws, bs, x_bias = random_mlp(key)
        eta0 = jax.random.uniform(jax.random.PRNGKey(4), (16, 6))
        eta0 = eta0 / eta0.sum(-1, keepdims=True)
        eps = 0.08
        lb0, ub0 = crown_mlp_bounds(Ws, bs, eta0, eps, x_bias)

        # soundness holds for ARBITRARY alpha in [0,1] (relu(z) >= alpha*z
        # globally), fuzz a few random slope choices
        for s in range(3):
            ks = jax.random.split(jax.random.PRNGKey(10 + s), 2)
            alphas = [
                jax.random.uniform(ks[0], (16, Ws[0].shape[0])),
                jax.random.uniform(ks[1], (16, Ws[1].shape[0])),
            ]
            lb, ub = crown_mlp_bounds(Ws, bs, eta0, eps, x_bias, alphas)
            key = jax.random.PRNGKey(20 + s)
            for _ in range(10):
                key, k = jax.random.split(key)
                d = jax.random.uniform(
                    k, eta0.shape, minval=-eps, maxval=eps
                )
                f = np.asarray(mlp_forward(Ws, bs, x_bias, eta0 + d))
                assert (f >= np.asarray(lb) - 1e-4).all()
                assert (f <= np.asarray(ub) + 1e-4).all()

        # optimizing the slopes against sum(ub - lb) must not be looser
        # than the heuristic on that objective, and typically tightens
        alphas = jax.jit(
            lambda: optimize_crown_alphas(
                Ws, bs, eta0, eps, x_bias,
                loss_fn=lambda lb, ub: jnp.sum(ub - lb, -1), iters=8,
            )
        )()
        lb1, ub1 = crown_mlp_bounds(Ws, bs, eta0, eps, x_bias, alphas)
        gap0 = float(jnp.sum(ub0 - lb0))
        gap1 = float(jnp.sum(ub1 - lb1))
        assert gap1 <= gap0 + 1e-4, (gap0, gap1)
        # sampled values stay inside the optimized bounds
        key = jax.random.PRNGKey(40)
        for _ in range(10):
            key, k = jax.random.split(key)
            d = jax.random.uniform(k, eta0.shape, minval=-eps, maxval=eps)
            f = np.asarray(mlp_forward(Ws, bs, x_bias, eta0 + d))
            assert (f >= np.asarray(lb1) - 1e-4).all()
            assert (f <= np.asarray(ub1) + 1e-4).all()

    def test_corner_values_tight_for_linear_net(self):
        # with no hidden relu ambiguity (positive pre-activations) CROWN is
        # exact at a box corner for a monotone path
        Ws = [jnp.eye(4), jnp.eye(4), jnp.eye(4)]
        bs = [jnp.full((4,), 5.0), jnp.zeros(4), jnp.zeros(4)]
        eta0 = jnp.zeros((1, 4))
        lb, ub = crown_mlp_bounds(Ws, bs, eta0, 0.1, jnp.zeros(4))
        np.testing.assert_allclose(np.asarray(ub)[0], 5.1, atol=1e-5)
        np.testing.assert_allclose(np.asarray(lb)[0], 4.9, atol=1e-5)


class TestIbpQp:
    def test_qp_interval_soundness(self):
        a1, a2, s1 = 100.0, 20.0, 0.02
        key = jax.random.PRNGKey(3)
        h = jax.random.uniform(key, (16, 5))
        h = h / h.sum(-1, keepdims=True)
        eps = 0.02
        mid = jax.random.normal(jax.random.PRNGKey(4), (16, 5))
        lb = mid - 0.3
        ub = mid + 0.3
        f_lb, f_ub = jax.jit(
            lambda: ibp_cbf_qp(h, eps, lb, ub, a1, s1, a2)
        )()
        f_lb, f_ub = np.asarray(f_lb), np.asarray(f_ub)
        assert (f_lb <= f_ub + 1e-5).all()
        key = jax.random.PRNGKey(5)
        for _ in range(30):
            key, k1, k2 = jax.random.split(key, 3)
            hp = h + jax.random.uniform(k1, h.shape, minval=-eps, maxval=eps)
            ft = lb + (ub - lb) * jax.random.uniform(k2, h.shape)
            lower, _ = barrier_bounds(hp, a1, s1, a2)
            v = np.asarray(simplex_cone_project(lower, ft, 40))
            assert (v >= f_lb - 2e-3).all(), (v - f_lb).min()
            assert (v <= f_ub + 2e-3).all(), (f_ub - v).min()

    def test_band_matches_center_eps_form(self):
        # ibp_cbf_qp(h, eps) must equal ibp_cbf_qp_band(h-eps, h+eps)
        a1, a2, s1 = 100.0, 20.0, 0.02
        h = jax.random.uniform(jax.random.PRNGKey(6), (8, 5))
        h = h / h.sum(-1, keepdims=True)
        mid = jax.random.normal(jax.random.PRNGKey(7), (8, 5))
        lb, ub = mid - 0.2, mid + 0.2
        eps = 0.03
        f1 = ibp_cbf_qp(h, eps, lb, ub, a1, s1, a2)
        f2 = ibp_cbf_qp_band(h - eps, h + eps, lb, ub, a1, s1, a2)
        np.testing.assert_allclose(np.asarray(f1[0]), np.asarray(f2[0]), atol=1e-6)
        np.testing.assert_allclose(np.asarray(f1[1]), np.asarray(f2[1]), atol=1e-6)

    def test_band_asymmetric_box_soundness(self):
        # an explicit non-centered band box: sampled projections must stay
        # inside the band bounds (classification.py:244-278 semantics)
        a1, a2, s1 = 100.0, 20.0, 0.02
        h = jax.random.uniform(jax.random.PRNGKey(8), (8, 5))
        h = h / h.sum(-1, keepdims=True)
        h_lb, h_ub = h - 0.01, h + 0.05
        mid = jax.random.normal(jax.random.PRNGKey(9), (8, 5))
        lb, ub = mid - 0.3, mid + 0.3
        f_lb, f_ub = jax.jit(
            lambda: ibp_cbf_qp_band(h_lb, h_ub, lb, ub, a1, s1, a2)
        )()
        f_lb, f_ub = np.asarray(f_lb), np.asarray(f_ub)
        key = jax.random.PRNGKey(10)
        for _ in range(20):
            key, k1, k2 = jax.random.split(key, 3)
            hp = h_lb + (h_ub - h_lb) * jax.random.uniform(k1, h.shape)
            ft = lb + (ub - lb) * jax.random.uniform(k2, h.shape)
            lower, _ = barrier_bounds(hp, a1, s1, a2)
            v = np.asarray(simplex_cone_project(lower, ft, 40))
            assert (v >= f_lb - 2e-3).all(), (v - f_lb).min()
            assert (v <= f_ub + 2e-3).all(), (f_ub - v).min()

    def test_individual_two_sided_linear_barrier_soundness(self):
        # the individual variant uses the LINEAR barrier pair and the
        # two-sided QP (classification.py:183-207)
        from fiode_tpu.ops.simplex_qp import simplex_box_project

        a1, a2 = 100.0, 20.0
        h = jax.random.uniform(jax.random.PRNGKey(11), (8, 5))
        h = h / h.sum(-1, keepdims=True)
        eps = 0.02
        mid = jax.random.normal(jax.random.PRNGKey(12), (8, 5))
        lb, ub = mid - 0.3, mid + 0.3
        f_lb, f_ub = jax.jit(
            lambda: ibp_cbf_qp_individual(h, eps, lb, ub, a1, 0.02, a2)
        )()
        f_lb, f_ub = np.asarray(f_lb), np.asarray(f_ub)
        assert (f_lb <= f_ub + 1e-5).all()
        key = jax.random.PRNGKey(13)
        for _ in range(20):
            key, k1, k2 = jax.random.split(key, 3)
            hp = h + jax.random.uniform(k1, h.shape, minval=-eps, maxval=eps)
            ft = lb + (ub - lb) * jax.random.uniform(k2, h.shape)
            v = np.asarray(
                simplex_box_project(-a1 * hp, a2 * (1.0 - hp), ft, 40)
            )
            assert (v >= f_lb - 2e-3).all(), (v - f_lb).min()
            assert (v <= f_ub + 2e-3).all(), (f_ub - v).min()

    def test_worst_case_vdot_brute(self):
        eta = jnp.asarray([[0.3, 0.3, 0.2, 0.2]])
        f_lb = jnp.asarray([[-1.0, -2.0, -3.0, -4.0]])
        f_ub = jnp.asarray([[1.0, 2.0, 3.0, 4.0]])
        # wide runner-up set: threshold 0.3 - 0.12 < 0.2 -> coords {1,2,3}
        v = float(worst_case_vdot(eta, 0.06, f_lb, f_ub, jnp.asarray([0]))[0])
        assert v == pytest.approx(1.0 + 4.0)
        # tight runner-up set: threshold 0.3 - 0.02 > 0.2 -> only coord {1}
        v = float(worst_case_vdot(eta, 0.01, f_lb, f_ub, jnp.asarray([0]))[0])
        assert v == pytest.approx(1.0 + 2.0)


def _eqns(jaxpr):
    """Every equation of a jaxpr, sub-jaxprs (jit, loops) included."""
    out = []
    for e in jaxpr.eqns:
        out.append(e)
        for v in e.params.values():
            sub = getattr(v, "jaxpr", None)
            if sub is not None:
                out.extend(_eqns(getattr(sub, "jaxpr", sub)))
            elif isinstance(v, (tuple, list)):
                for b in v:
                    sub = getattr(b, "jaxpr", None)
                    if sub is not None:
                        out.extend(_eqns(getattr(sub, "jaxpr", sub)))
    return out


class TestCertifierEndToEnd:
    def _make(self, tmp_path):
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
        params = model.init(jax.random.PRNGKey(1), x)
        return model, params, x

    def test_worst_values_match_verdicts(self, tmp_path):
        model, params, x = self._make(tmp_path)
        y = np.asarray([0, 1, 2, 0, 1, 2])
        cert = Certifier(model, params, T=8, eps_input=0.1, chunk=64)
        res = cert.certify(np.asarray(x), y, method="crown",
                           early_exit=False)
        assert np.isnan(res.worst[~res.clean]).all()
        clean = res.worst[res.clean]
        np.testing.assert_array_equal(clean <= 0, res.certified[res.clean])

    def test_clean_check_and_features_pin_float32(self, tmp_path):
        # the certificate starts from features computed at the certifier's
        # precision, not at the backend default (TF32 on a GPU)
        model, params, x = self._make(tmp_path)
        cert = Certifier(model, params, T=4, eps_input=0.1, chunk=64)
        for fn in (cert._features, cert._predict):
            jaxpr = jax.make_jaxpr(fn)(params, x)
            precs = [str(e.params["precision"]) for e in _eqns(jaxpr.jaxpr)
                     if e.primitive.name == "dot_general"]
            assert precs and all("HIGHEST" in p for p in precs), precs

    @pytest.mark.gpu
    def test_features_on_card_match_cpu_float32(self, gpu, tmp_path):
        model, params, x = self._make(tmp_path)
        cert = Certifier(model, params, T=4, eps_input=0.1, chunk=64)
        got = cert._features(params, x)
        cpu = jax.devices("cpu")[0]
        with jax.default_device(cpu), jax.default_matmul_precision("highest"):
            want = jax.jit(model.features)(*jax.device_put((params, x), cpu))
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-5)

    def test_certify_runs_and_is_consistent(self, tmp_path):
        model, params, x = self._make(tmp_path)
        y = np.asarray([0, 1, 2, 0, 1, 2])
        cert = Certifier(model, params, T=8, eps_input=0.1, chunk=64)
        res_c = cert.certify(np.asarray(x), y, method="crown")
        res_l = cert.certify(np.asarray(x), y, method="lipschitz")
        # certified implies clean
        assert (~res_c.certified | res_c.clean).all()
        assert (~res_l.certified | res_l.clean).all()
        assert res_c.cells_per_image == count_decision_boundary(3, 8)
        # CROWN-certified must never beat the exact-sampled (larger-T)
        # Lipschitz check on the same grid points: if CROWN certifies an
        # image, no grid point can have a positive exact violation
        assert (
            ~res_c.certified | res_l.larger_T_certified
        ).all(), "CROWN certified an image whose exact grid values violate"

    def test_scale_nominal_widens_lipschitz_kappa(self, tmp_path):
        """Under scale_nominal the sigmoid rescaling multiplies input
        sensitivity: the Lipschitz certificate must use
        Lfx = alpha_1/min(std) (certify_lipschitz.py:67-72), while CROWN's
        kappa stays 1/min(std) (certify_crown.py:65-67)."""
        model, params, x = self._make(tmp_path)
        off = Certifier(model, params, T=8, eps_input=0.1, chunk=64)
        on = Certifier(model, params, T=8, eps_input=0.1, chunk=64,
                       scale_nominal=True)
        assert off.kappa_lips == off.kappa
        assert on.kappa == off.kappa  # CROWN kappa unconditional
        a1 = model.dynamics.alpha_1
        np.testing.assert_allclose(on.kappa_lips, a1 * off.kappa, rtol=1e-6)

    def test_alpha_crown_certifier_no_looser_and_consistent(self, tmp_path):
        # alpha-CROWN refinement may only move per-image worst Vdot down:
        # its certified set contains plain CROWN's, and stays inside the
        # exact-grid (larger-T Lipschitz) certified set
        model, params, x = self._make(tmp_path)
        y = np.asarray([0, 1, 2, 0, 1, 2])
        plain = Certifier(model, params, T=8, eps_input=0.1, chunk=64)
        alpha = Certifier(
            model, params, T=8, eps_input=0.1, chunk=64, alpha_iters=3
        )
        res_p = plain.certify(np.asarray(x), y, method="crown",
                              early_exit=False)
        res_a = alpha.certify(np.asarray(x), y, method="crown",
                              early_exit=False)
        assert (~res_p.certified | res_a.certified).all(), (
            "alpha-CROWN lost a certificate plain CROWN had"
        )
        res_l = plain.certify(np.asarray(x), y, method="lipschitz",
                              early_exit=False)
        assert (~res_a.certified | res_l.larger_T_certified).all(), (
            "alpha-CROWN certified an image with exact grid violations"
        )

    def test_alpha_width_objective_sound_and_no_looser(self, tmp_path):
        # the cheap pre-QP "width" objective (no QP bisection in the
        # differentiated graph) must obey the same soundness containments
        model, params, x = self._make(tmp_path)
        y = np.asarray([0, 1, 2, 0, 1, 2])
        plain = Certifier(model, params, T=8, eps_input=0.1, chunk=64)
        width = Certifier(
            model, params, T=8, eps_input=0.1, chunk=64, alpha_iters=3,
            alpha_objective="width",
        )
        res_p = plain.certify(np.asarray(x), y, method="crown",
                              early_exit=False)
        res_w = width.certify(np.asarray(x), y, method="crown",
                              early_exit=False)
        res_l = plain.certify(np.asarray(x), y, method="lipschitz",
                              early_exit=False)
        assert (~res_w.certified | res_l.larger_T_certified).all(), (
            "width-objective alpha-CROWN certified an image with exact "
            "grid violations"
        )
        # the width surrogate drives the gradient but iterates are
        # SELECTED by the certified quantity (plain CROWN is iterate 0),
        # so certificates can only be gained, never lost
        assert (~res_p.certified | res_w.certified).all()

    def test_certify_stream_matches_batch_and_logs(self, tmp_path):
        # the streamed protocol sweep must agree with the one-shot batched
        # sweep and leave a per-batch audit log + summary
        import json

        model, params, x = self._make(tmp_path)
        y = np.asarray([0, 1, 2, 0, 1, 2])
        cert = Certifier(model, params, T=8, eps_input=0.1, chunk=64)
        out = tmp_path / "stream.jsonl"
        res_s = cert.certify_stream(
            np.asarray(x), y, method="crown", image_batch=2,
            out_path=str(out), start_ind=100,
        )
        res_b = cert.certify(np.asarray(x), y, method="crown",
                             early_exit=False)
        np.testing.assert_array_equal(res_s.clean, res_b.clean)
        np.testing.assert_array_equal(res_s.certified, res_b.certified)
        lines = [json.loads(l) for l in out.read_text().splitlines()]
        assert len(lines) == 3 and lines[-1]["n"] == 6
        assert lines[0]["idx_from"] == 100
        summary = json.loads((tmp_path / "stream.jsonl.json").read_text())
        assert summary["certified_acc"] == res_b.certified_acc
        assert summary["matmul_precision"] == "float32"
        assert all(i >= 100 for i in summary["certified_idx"])

    def test_summarize_stream_merges_resumed_segments(self, tmp_path):
        # a killed-and-resumed sweep leaves two cumulative-counter segments
        # in one jsonl; the summarizer must fold them into single-run totals
        import json

        from fiode_tpu.verify.certify import summarize_stream

        def rec(i0, i1, clean, cert, n, idx, cells, secs):
            return {"idx_from": i0, "idx_to": i1, "clean": clean,
                    "certified": cert, "n": n, "batch_certified_idx": idx,
                    "cells_checked": cells, "seconds": secs,
                    "matmul_precision": "float32"}

        out = tmp_path / "s.jsonl"
        out.write_text("\n".join(json.dumps(r) for r in [
            # segment 1: images 0-3 in two batches (counters cumulative)
            rec(0, 1, 2, 1, 2, [0], 100, 1.0),
            rec(2, 3, 4, 3, 4, [2, 3], 200, 2.0),
            # segment 2 (resume): images 4-5, counters restart
            rec(4, 5, 1, 1, 2, [5], 50, 0.5),
        ]) + "\n")
        s = summarize_stream(str(out), out_path=str(tmp_path / "sum.json"))
        assert s["n_images"] == 6 and s["segments"] == 2
        assert s["clean"] == 5 and s["certified"] == 4
        assert s["certified_idx"] == [0, 2, 3, 5]
        assert s["cells_checked"] == 250 and s["seconds"] == 2.5
        assert json.loads((tmp_path / "sum.json").read_text()) == s
        # overlapping segments would double-count clean images: reject
        out2 = tmp_path / "bad.jsonl"
        out2.write_text("\n".join(json.dumps(r) for r in [
            rec(0, 1, 2, 1, 2, [0], 100, 1.0),
            rec(1, 2, 2, 2, 2, [1, 2], 80, 1.0),
        ]) + "\n")
        with pytest.raises(ValueError):
            summarize_stream(str(out2))

    def test_summarize_stream_resume_with_larger_batch(self, tmp_path):
        # regression: the old boundary rule (n <= last n) missed a resumed
        # segment whose first cumulative n exceeds the prior segment's
        # total, silently merging counters and then rejecting a valid log
        import json

        from fiode_tpu.verify.certify import summarize_stream

        def rec(i0, i1, clean, cert, n, idx, cells, secs):
            return {"idx_from": i0, "idx_to": i1, "clean": clean,
                    "certified": cert, "n": n, "batch_certified_idx": idx,
                    "cells_checked": cells, "seconds": secs,
                    "matmul_precision": "float32"}

        out = tmp_path / "s.jsonl"
        out.write_text("\n".join(json.dumps(r) for r in [
            # segment 1: one batch of 2 (killed after)
            rec(0, 1, 2, 1, 2, [0], 100, 1.0),
            # segment 2 (resume from idx 2) with batch size 4 > 2
            rec(2, 5, 3, 2, 4, [2, 4], 200, 2.0),
            rec(6, 7, 5, 3, 6, [7], 300, 3.0),
        ]) + "\n")
        s = summarize_stream(str(out))
        assert s["segments"] == 2
        assert s["n_images"] == 8 and s["clean"] == 7
        assert s["certified_idx"] == [0, 2, 4, 7]
        assert s["cells_checked"] == 400 and s["seconds"] == 4.0
        # single-precision logs summarize to the per-run scalar shape
        assert s["matmul_precision"] == "float32"

    def test_certify_stream_lipschitz_logs_larger_T(self, tmp_path):
        # the audit log must carry the larger-T verdicts (headline
        # lipschitz metric) so a killed sweep's batches are recoverable
        import json

        from fiode_tpu.verify.certify import summarize_stream

        model, params, x = self._make(tmp_path)
        y = np.asarray([0, 1, 2, 0, 1, 2])
        cert = Certifier(model, params, T=8, eps_input=0.1, chunk=64)
        out = tmp_path / "lips.jsonl"
        res = cert.certify_stream(
            np.asarray(x), y, method="lipschitz", image_batch=2,
            out_path=str(out), start_ind=10,
        )
        lines = [json.loads(l) for l in out.read_text().splitlines()]
        assert all("batch_larger_T_idx" in l for l in lines)
        merged = set()
        for l in lines:
            merged.update(l["batch_larger_T_idx"])
        expect = set((10 + np.nonzero(res.larger_T_certified)[0]).tolist())
        assert merged == expect
        summary = json.loads((tmp_path / "lips.jsonl.json").read_text())
        assert summary["larger_T_certified_idx"] == sorted(expect)
        folded = summarize_stream(str(out))
        assert folded["larger_T_certified_idx"] == sorted(expect)
        # mixed-generation logs (some records missing the field) must be
        # rejected, not silently understated
        lines[0].pop("batch_larger_T_idx")
        mixed = tmp_path / "mixed.jsonl"
        mixed.write_text("\n".join(json.dumps(l) for l in lines) + "\n")
        with pytest.raises(ValueError, match="mixed-generation"):
            summarize_stream(str(mixed))

    def test_exact_witness_matches_bruteforce_and_larger_T(self, tmp_path):
        """exact_witness returns the argmax of the exact grid sweep — the
        refutation witness when positive.  Oracle: brute-force exact Vdot
        over the full grid per image; consistency: witness < 0 iff the
        image passes the larger-T certificate (same quantity, pass/fail
        form — certify_lipschitz.py:131,142-143)."""
        model, params, x = self._make(tmp_path)
        y = np.asarray([0, 1, 2, 0, 1, 2])
        cert = Certifier(model, params, T=8, eps_input=0.1, chunk=64)
        vals, idxs, clean = cert.exact_witness(np.asarray(x), y)
        grid = cert.grid
        feats = np.asarray(cert._features(cert.params, jnp.asarray(x)))
        for k in range(len(y)):
            label = int(y[k])
            perm = np.arange(3)
            perm[0], perm[label] = label, 0
            eta_l = grid[:, perm]
            f = np.asarray(model.eval_dot(
                params, jnp.asarray(eta_l),
                jnp.broadcast_to(jnp.asarray(feats[k]),
                                 (len(grid), feats.shape[-1])),
                scale_nominal=False,
            ))
            onehot = np.arange(3) == label
            wrong = np.where(onehot, -np.inf, eta_l)
            mw = wrong.max(-1, keepdims=True)
            runner = (eta_l == mw) & ~onehot
            f_y = np.where(onehot, f, 0.0).sum(-1)
            f_w = np.where(runner, f, -np.inf).max(-1)
            v = -f_y + f_w + cert.kappa_lips
            assert np.isclose(vals[k], v.max(), rtol=1e-5, atol=1e-6)
            assert np.isclose(v[idxs[k]], vals[k], rtol=1e-5, atol=1e-6)
        res_l = cert.certify(np.asarray(x), y, method="lipschitz",
                             early_exit=False)
        np.testing.assert_array_equal(
            res_l.larger_T_certified[clean], (vals < 0)[clean]
        )

    def test_empty_grid_rejected(self, tmp_path):
        model, params, x = self._make(tmp_path)
        with pytest.raises(ValueError):
            Certifier(model, params, T=8, grid=np.zeros((0, 3), np.float32))

    def test_lips_early_exit_matches_full_sweep(self, tmp_path):
        # Early exit may only fire once BOTH certificates are decided for
        # every image; a truncated sweep must never flip a larger-T verdict
        # (regression: early_exit used to break on the full-T certificate
        # alone, emitting larger-T results from a partial sweep).
        model, params, x = self._make(tmp_path)
        y = np.asarray([0, 1, 2, 0, 1, 2])
        cert = Certifier(model, params, T=8, eps_input=0.1, chunk=16)
        kw = dict(method="lipschitz")
        res_ee = cert.certify(np.asarray(x), y, early_exit=True, **kw)
        res_full = cert.certify(np.asarray(x), y, early_exit=False, **kw)
        np.testing.assert_array_equal(res_ee.certified, res_full.certified)
        np.testing.assert_array_equal(
            res_ee.larger_T_certified, res_full.larger_T_certified
        )


class TestRefinement:
    """BaB cell refinement (verify/refine.py) — vector-eps bound paths,
    frontier mechanics on an analytic bound, and end-to-end soundness
    containment on a tiny model (capability beyond the reference, which
    stops at the one-shot CROWN sweep, certify_crown.py:149-153)."""

    def _rand_mlp(self, key, n=4, m=16):
        ks = jax.random.split(key, 6)
        Ws = [
            jax.random.normal(ks[0], (m, n)) * 0.5,
            jax.random.normal(ks[1], (m, m)) * 0.3,
            jax.random.normal(ks[2], (n, m)) * 0.5,
        ]
        bs = [
            jax.random.normal(ks[3], (m,)) * 0.1,
            jax.random.normal(ks[4], (m,)) * 0.1,
            jax.random.normal(ks[5], (n,)) * 0.1,
        ]
        return Ws, bs

    def test_vector_eps_matches_scalar_crown(self):
        Ws, bs = self._rand_mlp(jax.random.PRNGKey(0))
        eta = jax.random.uniform(jax.random.PRNGKey(1), (32, 4))
        xb = jax.random.normal(jax.random.PRNGKey(2), (16,))
        lb_s, ub_s = crown_mlp_bounds(Ws, bs, eta, 0.05, xb)
        eps_v = jnp.full((32, 4), 0.05)
        lb_v, ub_v = crown_mlp_bounds(Ws, bs, eta, eps_v, xb)
        np.testing.assert_allclose(lb_s, lb_v, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ub_s, ub_v, rtol=1e-5, atol=1e-6)

    def test_vector_eps_crown_sound_and_anisotropic(self):
        # bounds with per-dim widths must contain sampled values from the
        # anisotropic box, and tighten when one dim's width shrinks
        Ws, bs = self._rand_mlp(jax.random.PRNGKey(3))
        eta = jax.random.uniform(jax.random.PRNGKey(4), (8, 4))
        xb = jax.random.normal(jax.random.PRNGKey(5), (16,))
        eps_v = jnp.asarray(
            np.tile([0.08, 0.02, 0.05, 0.01], (8, 1)).astype(np.float32)
        )
        lb, ub = crown_mlp_bounds(Ws, bs, eta, eps_v, xb)

        def fwd(e):
            z = e @ Ws[0].T + bs[0] + xb
            z = jax.nn.relu(z) @ Ws[1].T + bs[1]
            return jax.nn.relu(z) @ Ws[2].T + bs[2]

        u = jax.random.uniform(jax.random.PRNGKey(6), (64, 8, 4)) * 2 - 1
        pts = eta[None] + u * eps_v[None]
        vals = jax.vmap(fwd)(pts.reshape(-1, 4).reshape(64 * 8, 4))
        vals = vals.reshape(64, 8, 4)
        assert bool((vals <= ub[None] + 1e-5).all())
        assert bool((vals >= lb[None] - 1e-5).all())
        # shrinking dim 0's width can only tighten
        eps_t = eps_v.at[:, 0].set(0.02)
        lb_t, ub_t = crown_mlp_bounds(Ws, bs, eta, eps_t, xb)
        assert bool((ub_t <= ub + 1e-6).all())
        assert bool((lb_t >= lb - 1e-6).all())

    def test_worst_case_vdot_vector_eps(self):
        eta = jnp.asarray([[0.3, 0.3, 0.2, 0.2]])
        f_lb = jnp.asarray([[-1.0, -2.0, -3.0, -4.0]])
        f_ub = jnp.asarray([[1.0, 2.0, 3.0, 4.0]])
        lab = jnp.asarray([0])
        # constant vector == scalar semantics
        for e in (0.06, 0.01):
            v_s = float(worst_case_vdot(eta, e, f_lb, f_ub, lab)[0])
            v_v = float(worst_case_vdot(
                eta, jnp.full((1, 4), e), f_lb, f_ub, lab)[0])
            assert v_v == pytest.approx(v_s)
        # anisotropic: wide coord 3 joins the runner-up set, narrow stays out
        eps_v = jnp.asarray([[0.0, 0.001, 0.001, 0.12]])
        v = float(worst_case_vdot(eta, eps_v, f_lb, f_ub, lab)[0])
        assert v == pytest.approx(1.0 + 4.0)  # 0.2+0.12 >= 0.3-0.001
        eps_n = jnp.asarray([[0.0, 0.001, 0.001, 0.01]])
        v = float(worst_case_vdot(eta, eps_n, f_lb, f_ub, lab)[0])
        assert v == pytest.approx(1.0 + 2.0)  # 0.2+0.01 < 0.3-0.001

    def test_bab_mechanics_on_analytic_bound(self):
        # analytic "bound": val = sum(eps) - 0.3 (loose for wide boxes,
        # exactly refinable) -> BaB must close it; val = sum(eps) + 0.1
        # can never close -> budget trip, not an infinite loop.
        # step fns return (vals, split_dims): widest-dim splits here
        # (the constant-gradient score of the real kernel)
        from fiode_tpu.verify.refine import _bab

        def fake_step(c, e, xb, lab):
            return (jnp.sum(e, -1) - 0.3,
                    jnp.argmax(e, -1).astype(jnp.int32))

        centers = np.zeros((3, 4), np.float32)
        ok, rounds, boxes, gave = _bab(
            fake_step, None, 0, centers, 0.2, 4, chunk=8,
            max_rounds=30, frontier_cap=1 << 16, box_budget=1 << 20,
        )
        assert ok and gave == ""
        # sum(eps)=0.8 must halve dims until < 0.3: reachable, few rounds
        assert rounds < 20

        def fake_step_hopeless(c, e, xb, lab):
            return (jnp.sum(e, -1) + 0.1,
                    jnp.argmax(e, -1).astype(jnp.int32))

        ok, rounds, boxes, gave = _bab(
            fake_step_hopeless, None, 0, centers, 0.2, 4,
            chunk=8, max_rounds=10, frontier_cap=1 << 12,
            box_budget=1 << 16,
        )
        assert not ok and gave in ("rounds", "frontier_cap", "budget")

    def test_refine_sound_and_only_adds(self, tmp_path):
        # refined certificates must stay inside the exact-grid (larger-T)
        # certified set and never drop an image plain CROWN certified
        from fiode_tpu.verify.refine import refine_uncertified

        maker = TestCertifierEndToEnd()
        model, params, x = maker._make(tmp_path)
        y = np.asarray([0, 1, 2, 0, 1, 2])
        cert = Certifier(model, params, T=8, eps_input=0.1, chunk=64)
        res_c = cert.certify(np.asarray(x), y, method="crown",
                             early_exit=False)
        res_l = cert.certify(np.asarray(x), y, method="lipschitz",
                             early_exit=False)
        new_cert, stats = refine_uncertified(
            cert, np.asarray(x), y, res_c.certified, clean=res_c.clean,
            chunk=64, superchunk=4, max_rounds=6, frontier_cap=4096,
            box_budget=20000,
        )
        assert (~res_c.certified | new_cert).all(), "refinement lost one"
        assert (~new_cert | res_l.larger_T_certified).all(), (
            "refinement certified an image with exact grid violations"
        )
        assert len(stats) == int((res_c.clean & ~res_c.certified).sum())
        for s in stats:
            assert s.certified == bool(new_cert[s.image])

    def test_lips_box_bound_sound_fuzz(self, tmp_path):
        """The hybrid min(CROWN, exact-center + local-Lipschitz) box bound
        must upper-bound the exact Vdot at every sampled point of every
        box — including points whose argmax-wrong class differs from the
        center's (the box-wide runner-candidate rule covers switching)."""
        from fiode_tpu.verify.refine import _kernels

        maker = TestCertifierEndToEnd()
        model, params, x = maker._make(tmp_path)
        y = np.asarray([0, 1, 2, 0, 1, 2])
        cert = Certifier(model, params, T=8, eps_input=0.1, chunk=64)
        _, box_step_fn, _, _ = _kernels(cert, lips_box=True)
        feats = np.asarray(cert._features(cert.params, jnp.asarray(x)))
        x_biases = feats @ np.asarray(cert.U).T + np.asarray(cert.bU)
        rng = np.random.default_rng(0)
        n = cert.n
        for k in (0, 3):
            label = int(y[k])
            perm = np.arange(n)
            perm[0], perm[label] = label, 0
            # random boxes near the simplex, anisotropic widths
            C = 16
            centers = rng.dirichlet(np.ones(n), C).astype(np.float32)
            epss = (rng.uniform(0.01, 0.15, (C, n))).astype(np.float32)
            vals, _ = box_step_fn(
                jnp.asarray(centers[None]), jnp.asarray(epss[None]),
                jnp.asarray(x_biases[k]), label,
            )
            vals = np.asarray(vals)[0]
            # sample points inside each box, exact Vdot with argmax-at-h
            u = rng.uniform(-1.0, 1.0, (C, 8, n)).astype(np.float32)
            pts = centers[:, None, :] + u * epss[:, None, :]
            flat = pts.reshape(-1, n)
            x_in = np.broadcast_to(feats[k], (len(flat), feats.shape[-1]))
            f = np.asarray(model.eval_dot(
                params, jnp.asarray(flat), jnp.asarray(x_in),
                scale_nominal=False,
            ))
            onehot = np.arange(n) == label
            wrong = np.where(onehot, -np.inf, flat)
            mw = wrong.max(-1, keepdims=True)
            tie = (wrong == mw)
            f_y = np.where(onehot, f, 0.0).sum(-1)
            f_w = np.where(tie, f, -np.inf).max(-1)
            vdot = (-f_y + f_w + cert.kappa).reshape(C, 8)
            assert (vdot.max(-1) <= vals + 1e-4).all(), (
                "hybrid box bound below an exact sampled Vdot"
            )

    def test_hybrid_base_sweep_dominates_and_consistent(self, tmp_path):
        """hybrid_base_sweep (min of the CROWN and exact+Lipschitz cell
        bounds) must certify a superset of the plain CROWN certifier, have
        per-image violated counts <= the plain sweep's, and stay inside
        the exact-grid (larger-T) certified oracle."""
        from fiode_tpu.verify.refine import hybrid_base_sweep

        maker = TestCertifierEndToEnd()
        model, params, x = maker._make(tmp_path)
        y = np.asarray([0, 1, 2, 0, 1, 2])
        cert = Certifier(model, params, T=8, eps_input=0.1, chunk=64)
        res_c = cert.certify(np.asarray(x), y, method="crown",
                             early_exit=False)
        res_l = cert.certify(np.asarray(x), y, method="lipschitz",
                             early_exit=False)
        hyb = hybrid_base_sweep(cert, np.asarray(x), y,
                                chunk=32, superchunk=2)
        plain = hybrid_base_sweep(cert, np.asarray(x), y, lips_box=False,
                                  chunk=32, superchunk=2)
        assert [s.image for s in hyb] == list(range(6))
        for h, p in zip(hyb, plain):
            assert h.clean == bool(res_c.clean[h.image])
            # dominates the plain CROWN sweep cell-by-cell
            assert h.n_violated <= p.n_violated
            assert h.worst <= p.worst + 1e-5
            # plain sweep agrees with the Certifier's own CROWN verdict
            assert p.certified == bool(res_c.certified[p.image])
            # hybrid certifies a superset of BOTH base certificates
            if res_c.certified[h.image] or res_l.certified[h.image]:
                assert h.certified
            # consistency: certified implies no exact grid violation
            if h.certified:
                assert bool(res_l.larger_T_certified[h.image])
        # skip mask excludes images from the sweep
        sk = np.array([True, False, True, True, True, True])
        part = hybrid_base_sweep(cert, np.asarray(x), y, skip=sk,
                                 chunk=32, superchunk=2)
        assert [s.image for s in part] == [1]

    def test_refine_lips_box_sound_and_never_looser(self, tmp_path):
        # lips_box=True: same soundness containment as plain refinement,
        # and (same budgets, same split choices) never certifies fewer
        from fiode_tpu.verify.refine import refine_uncertified

        maker = TestCertifierEndToEnd()
        model, params, x = maker._make(tmp_path)
        y = np.asarray([0, 1, 2, 0, 1, 2])
        cert = Certifier(model, params, T=8, eps_input=0.1, chunk=64)
        res_c = cert.certify(np.asarray(x), y, method="crown",
                             early_exit=False)
        res_l = cert.certify(np.asarray(x), y, method="lipschitz",
                             early_exit=False)
        kw = dict(clean=res_c.clean, chunk=64, superchunk=4, max_rounds=6,
                  frontier_cap=4096, box_budget=20000)
        plain_cert, _ = refine_uncertified(
            cert, np.asarray(x), y, res_c.certified, **kw)
        hyb_cert, stats = refine_uncertified(
            cert, np.asarray(x), y, res_c.certified, lips_box=True, **kw)
        assert (~plain_cert | hyb_cert).all(), "hybrid lost a plain verdict"
        assert (~hyb_cert | res_l.larger_T_certified).all(), (
            "hybrid certified an image with exact grid violations"
        )

    def test_refine_skip_and_on_image_resume(self, tmp_path):
        # the resume hooks: on_image streams every verdict; a second call
        # with skip= set from the stream processes nothing new and the
        # merged verdicts equal the single-pass run
        from fiode_tpu.verify.refine import refine_uncertified

        maker = TestCertifierEndToEnd()
        model, params, x = maker._make(tmp_path)
        y = np.asarray([0, 1, 2, 0, 1, 2])
        cert = Certifier(model, params, T=8, eps_input=0.1, chunk=64)
        res_c = cert.certify(np.asarray(x), y, method="crown",
                             early_exit=False)
        kw = dict(clean=res_c.clean, chunk=64, superchunk=4, max_rounds=6,
                  frontier_cap=4096, box_budget=20000)
        streamed = []
        full_cert, full_stats = refine_uncertified(
            cert, np.asarray(x), y, res_c.certified,
            on_image=streamed.append, **kw)
        assert [s.image for s in streamed] == [s.image for s in full_stats]
        # resume with every streamed image skipped: nothing left to do
        skip = np.zeros(len(y), bool)
        base = res_c.certified.copy()
        for s in streamed:
            skip[s.image] = True
            if s.certified:
                base[s.image] = True
        re_cert, re_stats = refine_uncertified(
            cert, np.asarray(x), y, base, skip=skip, **kw)
        assert re_stats == []
        np.testing.assert_array_equal(re_cert, full_cert)

    def test_refine_order_schedules_but_does_not_change_verdicts(
            self, tmp_path):
        # order= (witness-margin scheduling) must only permute processing:
        # on_image fires in the given order (unlisted todo images after,
        # index order), and the final certified set is order-invariant
        from fiode_tpu.verify.refine import refine_uncertified

        maker = TestCertifierEndToEnd()
        model, params, x = maker._make(tmp_path)
        y = np.asarray([0, 1, 2, 0, 1, 2])
        cert = Certifier(model, params, T=8, eps_input=0.1, chunk=64)
        res_c = cert.certify(np.asarray(x), y, method="crown",
                             early_exit=False)
        kw = dict(clean=res_c.clean, chunk=64, superchunk=4, max_rounds=6,
                  frontier_cap=4096, box_budget=20000)
        base_cert, base_stats = refine_uncertified(
            cert, np.asarray(x), y, res_c.certified, **kw)
        todo = [s.image for s in base_stats]
        if len(todo) < 2:
            import pytest
            pytest.skip("fixture certified too much to exercise ordering")
        # reversed explicit order, with the first todo image left unlisted
        order = todo[::-1][:-1]
        seen = []
        ord_cert, _ = refine_uncertified(
            cert, np.asarray(x), y, res_c.certified,
            order=order, on_image=lambda s: seen.append(s.image), **kw)
        assert seen == order + [todo[0]]
        np.testing.assert_array_equal(ord_cert, base_cert)
        # order entries outside the todo set are ignored, not processed
        seen2 = []
        ord2_cert, _ = refine_uncertified(
            cert, np.asarray(x), y, res_c.certified,
            order=np.asarray(todo[::-1] + todo),
            on_image=lambda s: seen2.append(s.image), **kw)
        assert seen2 == todo[::-1]
        np.testing.assert_array_equal(ord2_cert, base_cert)

    def test_device_bab_matches_host_on_analytic_bound(self):
        # the device-resident rounds (eval -> compact -> split on device)
        # must reach the same verdict as the host path on the analytic
        # bound, exercise capacity growth (tiny m_min forces overflow) and
        # trip budgets on the hopeless bound instead of looping
        from fiode_tpu.verify.refine import (
            _bab, _device_bab, _device_round_factory,
        )

        def step_body(c, e, xb, lab):
            return (jnp.sum(e, -1) - 0.3,
                    jnp.argmax(e, -1).astype(jnp.int32))

        factory = _device_round_factory(step_body, 4, 0.2, eval_chunk=8)
        centers = np.zeros((3, 4), np.float32)
        # ample capacity: no overflow re-evals, so the deterministic split
        # schedule matches the host path round for round
        ok_d, r_d, b_d, gave_d, left_d = _device_bab(
            factory, None, 0, centers, 0.2, 4, max_rounds=30,
            frontier_cap=1 << 12, box_budget=1 << 20, m_min=1 << 11,
        )
        assert left_d is None
        ok_h, r_h, b_h, gave_h = _bab(
            lambda c, e, xb, lab: jax.vmap(
                lambda cc, ee: step_body(cc, ee, xb, lab))(c, e),
            None, 0, centers, 0.2, 4, chunk=8, max_rounds=30,
            frontier_cap=1 << 12, box_budget=1 << 20,
        )
        assert ok_d and gave_d == "" and ok_h
        assert r_d == r_h  # same deterministic split schedule
        # tiny capacity: overflow -> grow -> still closes (extra re-eval
        # rounds are expected, not failures)
        ok_g, r_g, _, gave_g, _lg = _device_bab(
            factory, None, 0, centers, 0.2, 4, max_rounds=40,
            frontier_cap=1 << 12, box_budget=1 << 20, m_min=8,
        )
        assert ok_g and gave_g == "" and r_g >= r_h

        def hopeless(c, e, xb, lab):
            return (jnp.sum(e, -1) + 0.1,
                    jnp.argmax(e, -1).astype(jnp.int32))

        fac2 = _device_round_factory(hopeless, 4, 0.2, eval_chunk=8)
        ok, rounds, boxes, gave, left = _device_bab(
            fac2, None, 0, centers, 0.2, 4, max_rounds=10,
            frontier_cap=1 << 10, box_budget=1 << 14, m_min=8,
            m_cap=1 << 10,
        )
        assert not ok and gave in ("rounds", "frontier_cap", "budget",
                                   "m_cap")
        # an m_cap give-up must hand back the compacted open parents for
        # host partitioning; every other give-up hands back nothing
        if gave == "m_cap":
            assert left is not None and 0 < len(left[0]) <= (1 << 10)
            assert left[0].shape == left[1].shape
        else:
            assert left is None

        # NaN fails closed on the device path too
        def nan_body(c, e, xb, lab):
            return (jnp.full(e.shape[:-1], jnp.nan),
                    jnp.zeros(e.shape[:-1], jnp.int32))

        fac3 = _device_round_factory(nan_body, 4, 0.2, eval_chunk=8)
        ok, rounds, boxes, gave, _ = _device_bab(
            fac3, None, 0, centers, 0.2, 4, max_rounds=4,
            frontier_cap=1 << 8, box_budget=1 << 12, m_min=8,
            m_cap=1 << 8,
        )
        assert not ok and gave != ""

    def test_device_bab_partitions_past_capacity(self):
        # a frontier that transiently outgrows the device capacity must be
        # host-partitioned into independent sub-frontiers and still close —
        # capacity overflow is a scheduling event, not a verdict (_bab)
        from fiode_tpu.verify.refine import _bab, _device_round_factory

        def step_body(c, e, xb, lab):
            # closes only after several splits: frontier grows well past
            # the tiny m_cap below before collapsing
            return (jnp.sum(e, -1) - 0.45,
                    jnp.argmax(e, -1).astype(jnp.int32))

        factory = _device_round_factory(step_body, 4, 0.2, eval_chunk=8)

        def host_fn(c, e, xb, lab):
            return jax.vmap(lambda cc, ee: step_body(cc, ee, xb, lab))(c, e)

        centers = np.zeros((3, 4), np.float32)
        ok_h, r_h, b_h, gave_h = _bab(
            host_fn, None, 0, centers, 0.2, 4, chunk=8, max_rounds=40,
            frontier_cap=1 << 16, box_budget=1 << 22,
        )
        assert ok_h and gave_h == ""
        ok_d, r_d, b_d, gave_d = _bab(
            host_fn, None, 0, centers, 0.2, 4, chunk=8, max_rounds=40,
            frontier_cap=1 << 16, box_budget=1 << 22,
            device_factory=factory, device_min=1, device_cap=16,
        )
        assert ok_d and gave_d == ""
        # partitioning re-evaluates overflow parents: never cheaper than
        # the single-frontier host schedule
        assert b_d >= b_h

    def test_refine_device_path_matches_host_end_to_end(self, tmp_path):
        # forcing every frontier through the device-resident rounds must
        # reproduce the host path's verdicts on the real model
        from fiode_tpu.verify.refine import refine_uncertified

        maker = TestCertifierEndToEnd()
        model, params, x = maker._make(tmp_path)
        y = np.asarray([0, 1, 2, 0, 1, 2])
        cert = Certifier(model, params, T=8, eps_input=0.1, chunk=64)
        res_c = cert.certify(np.asarray(x), y, method="crown",
                             early_exit=False)
        kw = dict(clean=res_c.clean, chunk=64, superchunk=4, max_rounds=6,
                  frontier_cap=4096, box_budget=20000)
        host_cert, host_stats = refine_uncertified(
            cert, np.asarray(x), y, res_c.certified, **kw)
        dev_cert, dev_stats = refine_uncertified(
            cert, np.asarray(x), y, res_c.certified, device_min=1, **kw)
        np.testing.assert_array_equal(host_cert, dev_cert)
        for h, d in zip(host_stats, dev_stats):
            assert h.image == d.image and h.certified == d.certified

    def test_refine_image_time_budget(self, tmp_path):
        # image_seconds=0: every image with a nonempty violated set must
        # give up with "time_budget" before evaluating a single BaB box
        # (the deadline is checked ahead of each round), and no image may
        # be newly certified through the BaB path
        from fiode_tpu.verify.refine import refine_uncertified

        maker = TestCertifierEndToEnd()
        model, params, x = maker._make(tmp_path)
        y = np.asarray([0, 1, 2, 0, 1, 2])
        cert = Certifier(model, params, T=8, eps_input=0.1, chunk=64)
        res_c = cert.certify(np.asarray(x), y, method="crown",
                             early_exit=False)
        new_cert, stats = refine_uncertified(
            cert, np.asarray(x), y, res_c.certified, clean=res_c.clean,
            chunk=64, superchunk=4, max_rounds=6, frontier_cap=4096,
            box_budget=20000, image_seconds=0.0)
        for s in stats:
            if s.base_violated > 0:
                assert not s.certified and s.gave_up == "time_budget"
                assert s.boxes_evaluated == 0
            else:
                # a clean re-sweep with no violated cells still certifies
                assert s.certified
        assert set(np.nonzero(new_cert & ~res_c.certified)[0]) == {
            s.image for s in stats if s.certified
        }

    def test_refine_alpha_evaluator_sound_and_no_looser(self, tmp_path):
        # alpha-CROWN box evaluator (alpha_iters > 0): the refined set must
        # still be inside the exact-grid certified set (soundness), never
        # below the plain-evaluator refinement on the same budgets (the
        # alpha bound is pointwise <= plain — its violated sets and
        # frontiers are subsets), and the stats must record the plain
        # violated count alongside the post-filter frontier size
        from fiode_tpu.verify.refine import refine_uncertified

        maker = TestCertifierEndToEnd()
        model, params, x = maker._make(tmp_path)
        y = np.asarray([0, 1, 2, 0, 1, 2])
        cert = Certifier(model, params, T=8, eps_input=0.1, chunk=64)
        res_c = cert.certify(np.asarray(x), y, method="crown",
                             early_exit=False)
        res_l = cert.certify(np.asarray(x), y, method="lipschitz",
                             early_exit=False)
        kw = dict(clean=res_c.clean, chunk=64, superchunk=4, max_rounds=6,
                  frontier_cap=4096, box_budget=20000)
        plain_cert, _ = refine_uncertified(
            cert, np.asarray(x), y, res_c.certified, **kw)
        a_cert, a_stats = refine_uncertified(
            cert, np.asarray(x), y, res_c.certified, alpha_iters=2, **kw)
        assert (~res_c.certified | a_cert).all(), "alpha refinement lost one"
        assert (~plain_cert | a_cert).all(), (
            "alpha evaluator certified fewer than plain on same budgets"
        )
        assert (~a_cert | res_l.larger_T_certified).all(), (
            "alpha refinement certified an image with exact grid violations"
        )
        for s in a_stats:
            # the alpha filter can only shrink the frontier vs plain sweep
            assert s.pre_alpha_violated >= s.base_violated >= 0

    def test_lips_box_evaluator_consistent_with_sweep(self, tmp_path):
        # at a base grid cell (on-lattice center, uniform 1/T widths) the
        # box bound must dominate the sweep value (its P-runner max is a
        # superset of the exact-tie runner max; slack and eta_ub match),
        # and a box far off the simplex plane must be masked infeasible
        from fiode_tpu.verify.refine_lips import _lips_kernels

        maker = TestCertifierEndToEnd()
        model, params, x = maker._make(tmp_path)
        cert = Certifier(model, params, T=8, eps_input=0.1, chunk=32)
        sweep_fn, box_step_fn, _, _ = _lips_kernels(cert)
        box_vals_fn = lambda *a: box_step_fn(*a)[0]
        feats = jnp.asarray(
            np.asarray(cert._features(cert.params, jnp.asarray(x)))[0]
        )
        g = cert.grid.copy()  # label 0: identity perm
        C = len(g)
        etas = jnp.asarray(g.reshape(1, C, 3))
        sweep = np.asarray(sweep_fn(etas, feats, 0)).reshape(-1)
        eps_u = np.full_like(g, cert.eps)
        epss = jnp.asarray(eps_u.reshape(1, C, 3))
        box = np.asarray(box_vals_fn(etas, epss, feats, 0)).reshape(-1)
        assert (box >= sweep - 1e-5).all(), (
            "box bound fell below the base sweep value it must dominate"
        )
        # off-plane box: sum(lo) > 1 -> provably no boundary point inside
        far = jnp.asarray((g + 1.0).reshape(1, C, 3))
        small = jnp.asarray(np.full_like(g, 1e-4).reshape(1, C, 3))
        vals = np.asarray(box_vals_fn(far, small, feats, 0)).reshape(-1)
        assert (vals == -np.inf).all(), "infeasible box not masked"
        # split dims exist and are valid coordinates (heuristic output)
        dims = np.asarray(box_step_fn(etas, epss, feats, 0)[1])
        assert ((dims >= 0) & (dims < 3)).all()

    def test_refine_lips_sound_and_only_adds(self, tmp_path):
        # Lipschitz refinement may only add certificates, must stay inside
        # the exact-grid (larger-T) certified set, and must mark images
        # with exact lattice violations as unrefinable without work
        from fiode_tpu.verify.refine_lips import refine_lips_uncertified

        maker = TestCertifierEndToEnd()
        model, params, x = maker._make(tmp_path)
        y = np.asarray([0, 1, 2, 0, 1, 2])
        cert = Certifier(model, params, T=8, eps_input=0.1, chunk=64)
        res_l = cert.certify(np.asarray(x), y, method="lipschitz",
                             early_exit=False)
        new_cert, stats = refine_lips_uncertified(
            cert, np.asarray(x), y, res_l.certified,
            exact_ok=res_l.larger_T_certified, clean=res_l.clean,
            chunk=64, superchunk=4, max_rounds=8, frontier_cap=4096,
            box_budget=40000,
        )
        assert (~res_l.certified | new_cert).all(), "lips refinement lost one"
        assert (~new_cert | res_l.larger_T_certified).all(), (
            "lips refinement certified an image with exact grid violations"
        )
        assert len(stats) == int((res_l.clean & ~res_l.certified).sum())
        for s in stats:
            assert s.certified == bool(new_cert[s.image])
            if not res_l.larger_T_certified[s.image]:
                assert s.gave_up == "exact_violation" and not s.certified
                assert s.boxes_evaluated == 0

    def test_split_children_cover_parent_in_fp32(self):
        # the children's union must cover the parent box exactly in fp32 —
        # no sliver at the split plane or the outer edges (regression for
        # fl(c -+ h) landing strictly inside the parent)
        from fiode_tpu.verify.refine import _split_children

        rng = np.random.default_rng(7)
        N, n = 4096, 6
        oc = (rng.uniform(-1.0, 1.0, (N, n)) * 10 ** rng.uniform(
            -3, 0, (N, 1))).astype(np.float32)
        oe = (10.0 ** rng.uniform(-7, -1, (N, n))).astype(np.float32)
        d = rng.integers(0, n, N)
        lo, hi, ce_lo, ce_hi = _split_children(oc, oe, d)
        rows = np.arange(N)
        c, e = oc[rows, d], oe[rows, d]
        # outer edges: children extend at least to the parent's edges
        assert (lo[rows, d] - ce_lo[rows, d] <= c - e).all()
        assert (hi[rows, d] + ce_hi[rows, d] >= c + e).all()
        # split plane: the two children overlap (or touch) at the center
        assert (lo[rows, d] + ce_lo[rows, d] >= hi[rows, d]
                - ce_hi[rows, d]).all()
        assert (lo[rows, d] + ce_lo[rows, d] >= c).all()
        assert (hi[rows, d] - ce_hi[rows, d] <= c).all()
        # non-split dims are untouched
        keep = np.ones((N, n), bool)
        keep[rows, d] = False
        np.testing.assert_array_equal(lo[keep], oc[keep])
        np.testing.assert_array_equal(ce_lo[keep], oe[keep])

    def test_bab_nan_fails_closed(self):
        # a NaN bound is an OPEN box: it must never certify through
        # (vals > 0 would treat NaN as closed)
        from fiode_tpu.verify.refine import _bab

        def nan_step(c, e, xb, lab):  # (K, C, n) -> ((K, C), (K, C))
            return (jnp.full(e.shape[:-1], jnp.nan),
                    jnp.zeros(e.shape[:-1], jnp.int32))

        centers = np.zeros((2, 4), np.float32)
        ok, rounds, boxes, gave = _bab(
            nan_step, None, 0, centers, 0.2, 4, chunk=8,
            max_rounds=4, frontier_cap=1 << 10, box_budget=1 << 14,
        )
        assert not ok and gave != ""
