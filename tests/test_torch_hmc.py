"""The port's static HMC against the JAX package.

The transition is deterministic given its draws: the reference's momenta
and accept uniforms (recovered from its keys) go into the port's proposal,
and positions, log densities, gradients and the info record agree to rtol
1e-12 in f64, with identical accept decisions. The warmup on top of it is
held statistically, as ``tests/adaptation/test_window_adaptation.py`` holds
the reference: the inverse mass matrix within rtol 0.5 of the known
variances and a step size in (0.05, 5).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from blackjax_tpu.mcmc import hmc as jhmc  # noqa: E402
from blackjax_tpu.mcmc import integrators as jintegrators  # noqa: E402
from blackjax_tpu.mcmc import metrics as jmetrics  # noqa: E402
from blackjax_tpu.mcmc import trajectory as jtrajectory  # noqa: E402
import blackjax_tpu_torch  # noqa: E402
from blackjax_tpu_torch import interop  # noqa: E402
from blackjax_tpu_torch.mcmc import hmc, integrators, metrics, trajectory  # noqa: E402

RTOL = 1e-12
D, C = 6, 32
VAR = np.array([0.25, 1.0, 4.0, 9.0, 0.5, 2.0])


def _jld(x):
    return -0.5 * jnp.sum(x**2 / jnp.asarray(VAR) + 0.1 * x**4)


def _tld(x):
    return -0.5 * (x**2 / torch.from_numpy(VAR) + 0.1 * x**4).sum(-1)


def _imm(kind):
    if kind == "diag":
        return np.random.default_rng(1).uniform(0.5, 2.0, D)
    a = np.random.default_rng(1).standard_normal((D, D))
    return a @ a.T / D + np.eye(D)


def _x0():
    return np.random.default_rng(0).standard_normal((C, D))


@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_static_integration_matches_reference(kind):
    imm = _imm(kind)
    jm, tm = jmetrics.gaussian_euclidean(jnp.asarray(imm)), metrics.gaussian_euclidean(
        torch.from_numpy(imm)
    )
    m0 = np.random.default_rng(2).standard_normal((C, D))
    j_roll = jtrajectory.static_integration(jintegrators.velocity_verlet(_jld, jm.kinetic_energy))
    t_roll = trajectory.static_integration(integrators.velocity_verlet(_tld, tm.kinetic_energy))
    js = jax.vmap(lambda x, m: j_roll(
        jintegrators.new_integrator_state(_jld, x, m), 0.1, 9))(jnp.asarray(_x0()), jnp.asarray(m0))
    ts = t_roll(
        integrators.new_integrator_state(_tld, torch.from_numpy(_x0()), torch.from_numpy(m0)),
        0.1, 9,
    )
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=1e-13)


@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_hmc_transition_on_the_reference_draws(kind):
    imm = _imm(kind)
    step_size, L = 0.45, 7
    kernel = jhmc.build_kernel()
    keys = jax.random.split(jax.random.key(3), C)
    state = jax.vmap(lambda x: jhmc.init(x, _jld))(jnp.asarray(_x0()))
    ref_state, ref_info = jax.vmap(
        lambda k, s: kernel(k, s, _jld, step_size, jnp.asarray(imm), L)
    )(keys, state)
    # the accept is bernoulli(key_propose, p) = uniform(key_propose) < p
    uniforms = jax.vmap(
        lambda k: jax.random.uniform(jax.random.split(k)[1], (), jnp.float64)
    )(keys)
    accepted = np.asarray(ref_info.is_accepted)
    np.testing.assert_array_equal(np.asarray(uniforms < ref_info.acceptance_rate), accepted)
    assert 0 < accepted.sum() < C  # both outcomes exercised

    metric = metrics.default_metric(torch.from_numpy(imm))
    generate = hmc.hmc_proposal(
        integrators.velocity_verlet(_tld, metric.kinetic_energy),
        metric.kinetic_energy, step_size, L,
    )
    port_state = interop.hmc_state(state)
    head = integrators.IntegratorState(
        port_state.position, interop.to_tensor(ref_info.momentum),
        port_state.logdensity, port_state.logdensity_grad,
    )
    landed, info, _ = generate(interop.to_tensor(uniforms), head)
    for a, b in zip(landed[:1] + landed[2:], [ref_state.position, ref_state.logdensity,
                                              ref_state.logdensity_grad]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=1e-13)
    np.testing.assert_array_equal(info.is_accepted.numpy(), accepted)
    np.testing.assert_array_equal(info.is_divergent.numpy(), np.asarray(ref_info.is_divergent))
    for name in ["momentum", "energy"]:
        np.testing.assert_allclose(
            getattr(info, name).numpy(), np.asarray(getattr(ref_info, name)), rtol=RTOL
        )
    # exp(H0 - H1) turns the energies' last-bit differences into relative
    # errors |H0 - H1| times larger (up to ~90 here)
    np.testing.assert_allclose(
        info.acceptance_rate.numpy(), np.asarray(ref_info.acceptance_rate), rtol=100 * RTOL
    )
    for a, b in zip(info.proposal, ref_info.proposal):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=1e-13)
    assert info.num_integration_steps == L


def test_kernel_draws_momentum_then_uniforms():
    """The kernel's two draws, in order, from the caller's generator: the
    same draws fed to the proposal give the same transition."""
    imm = torch.from_numpy(_imm("diag"))
    state = hmc.init(torch.from_numpy(_x0()), _tld)
    out, info = hmc.build_kernel()(torch.Generator().manual_seed(4), state, _tld, 0.45, imm, 5)

    g = torch.Generator().manual_seed(4)
    metric = metrics.default_metric(imm)
    momentum = metric.sample_momentum(g, state.position)
    u = torch.rand(C, generator=g, dtype=torch.float64)
    generate = hmc.hmc_proposal(
        integrators.velocity_verlet(_tld, metric.kinetic_energy), metric.kinetic_energy, 0.45, 5
    )
    landed, expected, _ = generate(u, integrators.IntegratorState(
        state.position, momentum, state.logdensity, state.logdensity_grad))
    assert torch.equal(out.position, landed.position)
    assert torch.equal(info.momentum, momentum) and torch.equal(info.is_accepted, expected.is_accepted)


def test_top_level_hmc_samples_the_target():
    algo = blackjax_tpu_torch.hmc(
        lambda x: -0.5 * (x**2 / torch.from_numpy(VAR)).sum(-1),
        0.5, torch.from_numpy(VAR), 8,
    )
    _, (xs, acc) = blackjax_tpu_torch.util.run_inference_algorithm(
        torch.Generator().manual_seed(5), algo, 300,
        initial_position=torch.from_numpy(2.0 * _x0()),
        transform=lambda s, i: (s.position, i.acceptance_rate),
    )
    assert xs.shape == (300, C, D) and 0.6 < float(acc.mean()) <= 1.0
    np.testing.assert_allclose(xs[100:].reshape(-1, D).var(0).numpy(), VAR, rtol=0.25)


def _window_logdensity(x):
    return -0.5 * (x**2 / torch.tensor([0.25, 1.0, 4.0, 9.0], dtype=x.dtype)).sum(-1)


def test_window_adaptation_hmc_diagonal():
    warmup = blackjax_tpu_torch.window_adaptation(
        hmc, _window_logdensity, num_integration_steps=10
    )
    (state, params), _ = warmup.run(
        torch.Generator().manual_seed(0), torch.zeros(4, dtype=torch.float64), 500
    )
    imm = params["inverse_mass_matrix"].numpy()
    assert imm.ndim == 1
    np.testing.assert_allclose(imm, [0.25, 1.0, 4.0, 9.0], rtol=0.5)
    assert 0.05 < params["step_size"] < 5.0
    assert params["num_integration_steps"] == 10


def test_window_adaptation_hmc_multichain_pooled():
    n_chains = 16
    warmup = blackjax_tpu_torch.window_adaptation(
        hmc, _window_logdensity, n_chains=n_chains, num_integration_steps=10
    )
    g = torch.Generator().manual_seed(1)
    positions = torch.randn(n_chains, 4, generator=g, dtype=torch.float64)
    (state, params), info = warmup.run(g, positions, 400)
    np.testing.assert_allclose(
        params["inverse_mass_matrix"].numpy(), [0.25, 1.0, 4.0, 9.0], rtol=0.5
    )
    assert 0.05 < params["step_size"] < 5.0
    assert state.position.shape == (n_chains, 4)
    assert info.info.acceptance_rate.shape == (400, n_chains)
