"""Attack oracles on a cheap differentiable victim: a linear classifier whose
exact adversarial behaviour is analytic, plus suite-composition invariants."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fiode_tpu.attacks.apgd import apgd_ce, apgd_targeted, dlr_loss_targeted
from fiode_tpu.attacks.autoattack import AutoAttackSuite
from fiode_tpu.attacks.fab import fab_targeted
from fiode_tpu.attacks.pgd import pgd_attack
from fiode_tpu.attacks.square import square_attack


def make_victim(key, n_cls=5, shape=(3, 8, 8)):
    """Linear victim logits = W flatten(x) + b."""
    d = int(np.prod(shape))
    W = jax.random.normal(key, (n_cls, d)) / np.sqrt(d)
    b = jnp.zeros((n_cls,))

    def logits_fn(x):
        return x.reshape(x.shape[0], -1) @ W.T + b

    return logits_fn, W


@pytest.fixture(scope="module")
def victim():
    key = jax.random.PRNGKey(0)
    logits_fn, W = make_victim(key)
    x = jax.random.uniform(jax.random.PRNGKey(1), (16, 3, 8, 8))
    y = jnp.argmax(logits_fn(x), -1)  # consistent labels: clean acc = 100%
    return logits_fn, W, x, y


def _acc(logits_fn, x, y):
    return float(jnp.mean((jnp.argmax(logits_fn(x), -1) == y)))


class TestPGD:
    def test_linf_ball_and_effect(self, victim):
        logits_fn, W, x, y = victim
        eps = 0.1

        def ce(xa):
            return -jax.nn.log_softmax(logits_fn(xa))[jnp.arange(16), y]

        xa = jax.jit(
            lambda x, k: pgd_attack(ce, x, k, eps=eps, norm="Linf", steps=10)
        )(x, jax.random.PRNGKey(2))
        d = np.abs(np.asarray(xa - x))
        assert d.max() <= eps + 1e-5
        assert np.asarray(xa).min() >= 0 and np.asarray(xa).max() <= 1
        assert _acc(logits_fn, xa, y) < _acc(logits_fn, x, y)

    def test_l2_ball(self, victim):
        logits_fn, W, x, y = victim
        eps = 1.0

        def ce(xa):
            return -jax.nn.log_softmax(logits_fn(xa))[jnp.arange(16), y]

        xa = jax.jit(
            lambda x, k: pgd_attack(ce, x, k, eps=eps, norm="L2", steps=10)
        )(x, jax.random.PRNGKey(3))
        d = np.linalg.norm(np.asarray(xa - x).reshape(16, -1), axis=-1)
        assert d.max() <= eps + 1e-4


class TestAPGD:
    def test_apgd_ce_breaks_linear_victim(self, victim):
        logits_fn, W, x, y = victim
        xa, succ = jax.jit(
            lambda x, k: apgd_ce(
                logits_fn, x, y, k, eps=2.0, norm="L2", n_iter=30
            )
        )(x, jax.random.PRNGKey(4))
        d = np.linalg.norm(np.asarray(xa - x).reshape(16, -1), axis=-1)
        assert d.max() <= 2.0 + 1e-3
        # an L2 ball of radius 2 is huge for this victim: most should break
        assert float(jnp.mean(succ)) > 0.5

    def test_apgd_targeted_runs(self, victim):
        logits_fn, W, x, y = victim
        xa, succ = jax.jit(
            lambda x, k: apgd_targeted(
                logits_fn, x, y, k, eps=2.0, norm="L2", n_iter=20,
                n_target_classes=3,
            )
        )(x, jax.random.PRNGKey(5))
        assert xa.shape == x.shape
        assert float(jnp.mean(succ)) > 0.3

    def test_dlr_loss_values(self):
        logits = jnp.asarray([[4.0, 3.0, 2.0, 1.0, 0.0]])
        y = jnp.asarray([0])
        t = jnp.asarray([1])
        # -(z_y - z_t)/(z_p1 - (z_p3+z_p4)/2) = -(4-3)/(4-1.5)
        v = float(dlr_loss_targeted(logits, y, t)[0])
        assert v == pytest.approx(-1.0 / 2.5)


class TestSquareFab:
    def test_square_linf(self, victim):
        logits_fn, W, x, y = victim
        xa, succ = jax.jit(
            lambda x, k: square_attack(
                logits_fn, x, y, k, eps=0.2, norm="Linf", n_queries=300
            )
        )(x, jax.random.PRNGKey(6))
        assert np.abs(np.asarray(xa - x)).max() <= 0.2 + 1e-5
        assert float(jnp.mean(succ)) > 0.2

    def test_square_segments_match_single_program(self, victim):
        # the host-chunked segment path must be bit-identical to the
        # single fori_loop program: the carry
        # (xa, loss, key) IS the fori_loop carry
        from fiode_tpu.attacks.square import square_attack_chunked

        logits_fn, W, x, y = victim
        k = jax.random.PRNGKey(11)
        xa_one, succ_one = jax.jit(
            lambda x, k: square_attack(
                logits_fn, x, y, k, eps=0.5, norm="L2", n_queries=70
            )
        )(x, k)
        # segment=30 forces 2 full segments + a 10-query remainder program
        chunked = square_attack_chunked(
            logits_fn, eps=0.5, norm="L2", n_queries=70, segment=30
        )
        xa, succ = chunked(x, y, k)
        np.testing.assert_array_equal(np.asarray(xa_one), np.asarray(xa))
        np.testing.assert_array_equal(np.asarray(succ_one), np.asarray(succ))
        # n_queries=0 degenerates to the random init (fori_loop(0,0) parity)
        xa0, succ0 = square_attack_chunked(
            logits_fn, eps=0.5, norm="L2", n_queries=0
        )(x, y, k)
        assert xa0.shape == x.shape and succ0.shape == y.shape

    def test_fab_finds_small_perturbations(self, victim):
        logits_fn, W, x, y = victim
        xa, succ = jax.jit(
            lambda x, k: fab_targeted(
                logits_fn, x, y, k, eps=3.0, norm="L2", n_iter=20,
                n_target_classes=2,
            )
        )(x, jax.random.PRNGKey(7))
        adv = np.asarray(succ)
        assert adv.mean() > 0.5
        # successful ones are actually misclassified
        pred = np.asarray(jnp.argmax(logits_fn(xa), -1))
        assert (pred[adv] != np.asarray(y)[adv]).all()


class TestSuite:
    def test_standard_composition(self, victim):
        logits_fn, W, x, y = victim
        suite = AutoAttackSuite(
            logits_fn, eps=1.5, norm="L2",
            attacks_to_run=("apgd-ce", "apgd-t", "fab-t", "square"),
            n_iter=15, square_queries=100,
        )
        xa, robust = suite.run(x, y, jax.random.PRNGKey(8))
        robust = np.asarray(robust)
        pred = np.asarray(jnp.argmax(logits_fn(xa), -1))
        # every non-robust example has a working adversarial stored
        assert (pred[~robust] != np.asarray(y)[~robust]).all()
        # robust ones were not modified
        d = np.linalg.norm(np.asarray(xa - x).reshape(16, -1), axis=-1)
        assert (d[robust] == 0).all()
