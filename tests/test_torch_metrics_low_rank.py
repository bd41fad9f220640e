"""The port's low-rank Euclidean metric against the JAX package's, in f64.

``M^{-1} = D (I + U (Lam - I) U^T) D`` with an orthonormal ``U`` made with
numpy: the same payload and the same inputs go through both. Values agree to
rtol 1e-12 (summation order only); U-turn decisions agree exactly. The
momentum is held on the same noise: ``sample_momentum`` draws ``eps`` from
the generator and maps it by ``M^{1/2}``, the map that ``scale(inv=False,
trans=False)`` applies.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from blackjax_tpu.mcmc import metrics as jmetrics  # noqa: E402
from blackjax_tpu_torch import interop  # noqa: E402
from blackjax_tpu_torch.mcmc import metrics  # noqa: E402

RTOL = 1e-12
D, K = 7, 3


def _payload(k=K, seed=4):
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((D, k)))
    return rng.uniform(0.5, 2.0, D), U, np.array([4.0, 0.2, 2.5, 0.6][:k])


@pytest.fixture(scope="module", params=[K, 1], ids=["rank3", "rank1"])
def pair(request):
    sigma, U, lam = _payload(request.param)
    ref = jmetrics.gaussian_euclidean_low_rank(*(jnp.asarray(a) for a in (sigma, U, lam)))
    port = metrics.gaussian_euclidean_low_rank(*(torch.from_numpy(a) for a in (sigma, U, lam)))
    return (sigma, U, lam), ref, port


def _close(a, b):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=1e-13)


def test_low_rank_matvec():
    sigma, U, lam = _payload()
    y = np.random.default_rng(0).standard_normal((5, D))
    ref = jax.vmap(lambda v: jmetrics._low_rank_matvec(v, jnp.asarray(U), jnp.asarray(lam)))(
        jnp.asarray(y))
    _close(metrics._low_rank_matvec(torch.from_numpy(y), torch.from_numpy(U),
                                    torch.from_numpy(lam)), ref)


def test_kinetic_energy(pair):
    _, ref, port = pair
    p = np.random.default_rng(1).standard_normal((9, D))
    _close(port.kinetic_energy(torch.from_numpy(p)), jax.vmap(ref.kinetic_energy)(jnp.asarray(p)))
    # one (d,) chain as well as a batch
    _close(port.kinetic_energy(torch.from_numpy(p[0])), ref.kinetic_energy(jnp.asarray(p[0])))


@pytest.mark.parametrize("inv", [False, True])
@pytest.mark.parametrize("trans", [False, True])
def test_scale(pair, inv, trans):
    _, ref, port = pair
    e = np.random.default_rng(2).standard_normal((6, D))
    want = jax.vmap(lambda v: ref.scale(None, v, inv=inv, trans=trans))(jnp.asarray(e))
    _close(port.scale(None, torch.from_numpy(e), inv=inv, trans=trans), want)


def test_scales_are_the_square_roots(pair):
    """``M^{1/2} M^{1/2, T} = M`` and ``M^{-1/2, T} M^{-1/2} ... = M^{-1}``,
    composed from ``scale``: the momentum map has covariance ``M``."""
    (sigma, U, lam), _, port = pair
    eye = torch.eye(D, dtype=torch.float64)
    imm = np.diag(sigma) @ (np.eye(D) + U @ np.diag(lam - 1.0) @ U.T) @ np.diag(sigma)
    # rows of the result are the columns of the factor applied to e_i
    half = port.scale(None, eye, inv=False, trans=False).T  # M^{1/2}
    np.testing.assert_allclose((half @ half.T).numpy(), np.linalg.inv(imm), rtol=1e-10, atol=1e-12)
    inv_half = port.scale(None, eye, inv=True, trans=False).T  # M^{-1/2}
    np.testing.assert_allclose((inv_half @ inv_half.T).numpy(), imm, rtol=1e-10, atol=1e-12)


def test_momentum_on_the_same_noise(pair):
    _, ref, port = pair
    g = torch.Generator().manual_seed(3)
    position = torch.zeros(5, D, dtype=torch.float64)
    draw = port.sample_momentum(g, position)
    eps = torch.randn(position.shape, generator=torch.Generator().manual_seed(3),
                      dtype=torch.float64)
    want = jax.vmap(lambda v: ref.scale(None, v, inv=False, trans=False))(jnp.asarray(eps.numpy()))
    assert draw.shape == (5, D) and draw.dtype == torch.float64
    _close(draw, want)


def test_check_turning_and_batched(pair):
    _, ref, port = pair
    rng = np.random.default_rng(3)
    C, S = 64, 6
    ml, mr, ms = (rng.standard_normal((C, D)) for _ in range(3))
    want = jax.vmap(ref.check_turning)(jnp.asarray(ml), jnp.asarray(mr), jnp.asarray(ms))
    got = port.check_turning(*(torch.from_numpy(a) for a in (ml, mr, ms)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < np.asarray(want).sum() < C  # both outcomes exercised

    ck_m, ck_s = rng.standard_normal((C, S, D)), rng.standard_normal((C, S, D))
    active = rng.random((C, S)) < 0.4
    want = jax.vmap(ref.check_turning_batched)(
        *(jnp.asarray(a) for a in (ck_m, ck_s, mr, ms, active)))
    got = port.check_turning_batched(*(torch.from_numpy(a) for a in (ck_m, ck_s, mr, ms, active)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < np.asarray(want).sum() < C


def test_default_metric_dispatches_the_payload():
    sigma, U, lam = _payload()
    payload = interop.low_rank_inverse_mass_matrix(
        jmetrics.LowRankInverseMassMatrix(*(jnp.asarray(a) for a in (sigma, U, lam))))
    assert isinstance(payload, metrics.LowRankInverseMassMatrix)
    metric = metrics.default_metric(payload)
    direct = metrics.gaussian_euclidean_low_rank(*payload)
    p = torch.from_numpy(np.random.default_rng(5).standard_normal((4, D)))
    assert torch.equal(metric.kinetic_energy(p), direct.kinetic_energy(p))
    # a Metric passes through; a dense matrix is Euclidean; a callable is refused
    assert metrics.default_metric(metric) is metric
    dense = metrics.default_metric(torch.eye(D, dtype=torch.float64))
    _close(dense.kinetic_energy(p), 0.5 * (p * p).sum(-1).numpy())
    with pytest.raises(NotImplementedError, match="Riemannian"):
        metrics.default_metric(lambda x: x)
