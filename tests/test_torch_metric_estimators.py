"""The port's metric estimators against the JAX package's, in f64.

Draws and gradients are made with numpy and fed to both. Eigen- and singular
vectors are defined up to sign (and within a degenerate eigenspace up to a
rotation), and LAPACK and PyTorch choose differently, so a low-rank payload
is held through what it does: ``sigma``, the sorted ``lam`` and the inverse
mass matrix it reconstructs, ``D (I + U (Lam - I) U^T) D``, to rtol 1e-9.
Everything else agrees to rtol 1e-12.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from blackjax_tpu.adaptation import metric_estimators as jest  # noqa: E402
from blackjax_tpu_torch.adaptation import metric_estimators as est  # noqa: E402

def reference(fn, *arrays):
    """``fn`` of the JAX package on numpy ``arrays``, compiled once at XLA's
    optimization level 0 (eagerly, each primitive compiles apart)."""
    compiled = jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0})
    return compiled(*(None if a is None else jnp.asarray(a) for a in arrays))


RTOL = 1e-12
PAYLOAD_RTOL = 1e-9
D = 9


def correlated_draws(n, d=D, seed=0):
    """Draws of a correlated Gaussian and their scores ``-P x``."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((d, d)) / np.sqrt(d)
    cov = A @ A.T + np.diag(rng.uniform(0.05, 3.0, d))
    x = rng.multivariate_normal(np.linspace(-1, 1, d), cov, size=n)
    return x, -(x - np.linspace(-1, 1, d)) @ np.linalg.inv(cov)


def reconstruct(payload):
    sigma, U, lam = (np.asarray(a, np.float64) for a in payload)
    return np.diag(sigma) @ (np.eye(len(sigma)) + U @ np.diag(lam - 1.0) @ U.T) @ np.diag(sigma)


def assert_same_payload(got, want):
    got = tuple(a.numpy() for a in got)
    np.testing.assert_allclose(got[0], np.asarray(want.sigma), rtol=PAYLOAD_RTOL)
    np.testing.assert_allclose(np.sort(got[2]), np.sort(np.asarray(want.lam)), rtol=PAYLOAD_RTOL)
    assert got[1].shape == np.asarray(want.U).shape
    np.testing.assert_allclose(reconstruct(got), reconstruct(want), rtol=PAYLOAD_RTOL,
                               atol=PAYLOAD_RTOL * np.abs(reconstruct(want)).max())


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float64))


def test_informativeness():
    vals = np.array([0.1, 1.0, 3.0, 0.7])
    np.testing.assert_allclose(est.eigenvalue_informativeness(_t(vals)).numpy(),
                               np.asarray(reference(jest.eigenvalue_informativeness, vals)))


@pytest.mark.parametrize("tail_handling", ["mask_pad", "raw"])
@pytest.mark.parametrize("max_rank", [2, 4, 7])
def test_select_top_eigenvalues_with_ties_and_padding(tail_handling, max_rank):
    """The identity as the eigenvectors shows which pairs were taken, in
    which order: ties (|0.5 - 1| = |1.5 - 1|) break as the reference's
    stable argsort breaks them; fewer pairs than ``max_rank`` pad with inert
    ones."""
    vals = np.array([1.5, 0.5, 3.0, 1.0, 0.25])
    vecs = np.eye(5)
    want = reference(lambda v, u: jest.select_top_eigenvalues_by_informativeness(
        v, u, max_rank, tail_handling=tail_handling), vals, vecs)
    got = est.select_top_eigenvalues_by_informativeness(
        _t(vals), _t(vecs), max_rank, tail_handling=tail_handling)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="tail_handling"):
        est.select_top_eigenvalues_by_informativeness(_t(vals), _t(vecs), 2, tail_handling="x")


def test_spd_mean():
    rng = np.random.default_rng(1)
    a, b = rng.standard_normal((2, D, D))
    A, B = a @ a.T + np.eye(D), b @ b.T + 0.5 * np.eye(D)
    got = est._spd_mean(_t(A), _t(B)).numpy()
    np.testing.assert_allclose(got, np.asarray(reference(jest._spd_mean, A, B)),
                               rtol=1e-10, atol=1e-12)
    # A # B is the SPD solution of X B^{-1} X = A
    np.testing.assert_allclose(got @ np.linalg.inv(B) @ got, A, rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("n, capacity", [(400, 400), (60, 80), (150, 100)], ids=[
    "full", "partial", "wrapped"])
def test_compute_low_rank_metric_on_a_masked_buffer(n, capacity):
    """A buffer whose first ``n`` rows are valid (and every row when the
    count passed the capacity): sigma, mu* and the payload."""
    x, g = correlated_draws(capacity)
    x[min(n, capacity):] = 0.0
    g[min(n, capacity):] = 0.0
    want = reference(lambda x, g: jest._compute_low_rank_metric(x, g, n, 3, 1e-5, 2.0), x, g)
    got = est._compute_low_rank_metric(_t(x), _t(g), n, 3, 1e-5, 2.0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-9, atol=1e-12)
    assert_same_payload((got[0], got[2], got[3]),
                        jest.LowRankInverseMassMatrix(want[0], want[2], want[3]))


def test_compute_low_rank_metric_runs_in_float64_and_casts_back():
    x, g = correlated_draws(200)
    got = est._compute_low_rank_metric(_t(x).float(), _t(g).float(), 200, 3, 1e-5, 2.0)
    assert all(a.dtype == torch.float32 for a in got)
    want = est._compute_low_rank_metric(_t(x).float().double(), _t(g).float().double(), 200, 3,
                                        1e-5, 2.0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.float().numpy())


@pytest.mark.parametrize("max_rank", [1, 4])
def test_fisher_score_low_rank(max_rank):
    x, g = correlated_draws(300, seed=2)
    want = reference(lambda x, g: jest.fisher_score_low_rank(x, g, max_rank), x, g)
    assert_same_payload(est.fisher_score_low_rank(_t(x), _t(g), max_rank), want)


def test_fisher_score_low_rank_recovers_a_gaussian_covariance():
    """With every informative direction kept, the Fisher metric of a
    Gaussian's draws and scores is close to its covariance."""
    x, g = correlated_draws(4000, seed=3)
    payload = est.fisher_score_low_rank(_t(x), _t(g), D, cutoff=1.0)
    cov = np.cov(x.T)
    err = np.linalg.norm(reconstruct(payload) - cov) / np.linalg.norm(cov)
    assert err < 0.05


@pytest.mark.parametrize("masked", [False, True])
def test_draws_singular_value_low_rank(masked):
    x, _ = correlated_draws(120, seed=4)
    mask = np.arange(120) < 90 if masked else None
    want = reference(lambda x, m: jest.draws_singular_value_low_rank(x, 4, m), x, mask)
    got = est.draws_singular_value_low_rank(_t(x), 4, None if mask is None else torch.from_numpy(mask))
    assert_same_payload(got, want)


def test_sample_covariance_eigh_low_rank():
    x, _ = correlated_draws(200, seed=5)
    c = x - x.mean(0)
    m2 = c.T @ c
    for count in (200, 200.0):
        want = reference(lambda m: jest.sample_covariance_eigh_low_rank(m, count, 3), m2)
        assert_same_payload(est.sample_covariance_eigh_low_rank(_t(m2), count, 3), want)


def test_welford_and_diagonal_estimators():
    x, g = correlated_draws(64, seed=6)
    pairs = [
        (est.welford_diagonal(_t(x)), reference(jest.welford_diagonal, x)),
        (est.welford_dense(_t(x)), reference(jest.welford_dense, x)),
        (est.fisher_score_diagonal(_t(x), _t(g)), reference(jest.fisher_score_diagonal, x, g)),
        (est.fisher_score_diagonal_from_moments(_t(x[0] ** 2), _t(g[0] ** 2)),
         reference(jest.fisher_score_diagonal_from_moments, x[0] ** 2, g[0] ** 2)),
        (est.sample_variance_diagonal(_t(x)), reference(jest.sample_variance_diagonal, x)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-11, atol=1e-13)
