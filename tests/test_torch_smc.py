"""The port's SMC core (``blackjax_tpu_torch.smc``) and its tracked
configuration against the JAX package, in float64, on the same keys
(``interop.prng_key``).

- Each resampling scheme draws the reference's ancestors, identical, for
  random, one-hot and uniform weights and for ``num_samples`` other than n.
- ``log_ess`` and ``ess_solver`` agree to 1e-12; ``dichotomy`` gives the
  reference's root, NaN or ``max_delta`` on its three branches.
- ``update_and_take_last`` gives the same particles and infos whole and in
  chunks, infos ``(n, num_mcmc_steps)``.
- The slice: adaptive tempered SMC with MALA on the tracked target
  (``benchmarks/tracked.py:584-616``, the run of ``chip_smoke.smc_run``) at
  256 particles to lambda = 1, step by step: the same number of steps,
  lambda within 1e-10, ancestors identical, particles within 1e-8,
  log-increments within 1e-10, accept flags identical.

The JAX side is compiled once per function, at XLA's optimization level 0
(it compiles in half the time, and is a reference here, never timed).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import blackjax_tpu  # noqa: E402
import chip_smoke  # noqa: E402
from blackjax_tpu.mcmc import mala as jmala  # noqa: E402
from blackjax_tpu.smc import ess as jess  # noqa: E402
from blackjax_tpu.smc import resampling as jresampling  # noqa: E402
from blackjax_tpu.smc import solver as jsolver  # noqa: E402
from blackjax_tpu.smc.waste_free import waste_free_smc as jwaste_free_smc  # noqa: E402
from blackjax_tpu_torch import interop, prng  # noqa: E402
from blackjax_tpu_torch.mcmc import mala  # noqa: E402
from blackjax_tpu_torch.smc import base, ess, resampling, solver  # noqa: E402

N = 256
SCHEMES = ["systematic", "stratified", "multinomial", "residual"]
SEEDS = 3


def jit(fn, **kwargs):
    """``jax.jit`` at XLA's optimization level 0."""
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0}, **kwargs)


def _weights(kind, n=N):
    if kind == "random":
        w = np.random.default_rng(5).dirichlet(np.full(n, 0.3))
    elif kind == "one-hot":
        w = np.zeros(n)
        w[n // 3] = 1.0
    else:
        w = np.full(n, 1.0 / n)
    return w


@pytest.fixture(scope="module")
def reference_resampling():
    """Each scheme of the JAX package over SEEDS keys, compiled once per
    scheme and sample count."""
    compiled = {}

    def ancestors(scheme, keys, w, num_samples):
        if (scheme, num_samples) not in compiled:
            compiled[scheme, num_samples] = jit(
                jax.vmap(getattr(jresampling, scheme), in_axes=(0, None, None)),
                static_argnums=2)
        return np.asarray(compiled[scheme, num_samples](keys, jnp.asarray(w), num_samples))

    return ancestors


@pytest.mark.parametrize("num_samples", [N, 100])
@pytest.mark.parametrize("kind", ["random", "one-hot", "uniform"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_resampling_draws_the_reference_ancestors(reference_resampling, scheme, kind,
                                                  num_samples):
    w = _weights(kind)
    keys = jax.random.split(jax.random.key(100), SEEDS)
    expected = reference_resampling(scheme, keys, w, num_samples)
    words = interop.prng_key(jax.random.key_data(keys))
    for seed in range(SEEDS):
        got = getattr(resampling, scheme)(words[seed], torch.from_numpy(w), num_samples)
        assert got.shape == (num_samples,)
        np.testing.assert_array_equal(got.numpy(), expected[seed])


def test_log_ess_and_solver_match_the_reference():
    loglik = -0.5 * np.random.default_rng(6).standard_normal(N) ** 2 * 40.0
    for delta in [0.0, 1e-3, 0.1, 1.0]:
        np.testing.assert_allclose(
            float(ess.log_ess(torch.from_numpy(delta * loglik))),
            float(jess.log_ess(jnp.asarray(delta * loglik))), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(float(ess.ess(torch.from_numpy(loglik))),
                               float(jess.ess(jnp.asarray(loglik))), rtol=1e-12)
    solve = jit(lambda loglik, target_ess, max_delta: jess.ess_solver(
        lambda x: x, loglik, target_ess, max_delta, jsolver.dichotomy))
    for target_ess, max_delta in [(0.5, 1.0), (0.9, 0.3), (0.01, 1.0)]:
        expected = solve(jnp.asarray(loglik), target_ess, max_delta)
        got = ess.ess_solver(lambda x: x, torch.from_numpy(loglik), target_ess,
                             torch.tensor(max_delta, dtype=torch.float64), solver.dichotomy)
        np.testing.assert_allclose(float(got), float(expected), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("branch, root", [
    ("bisect", 2.3), ("whole interval", 12.0), ("no root", -1.0)])
def test_dichotomy_takes_the_reference_branches(branch, root):
    expected = float(jsolver.dichotomy(lambda x: jnp.tanh(root - x), 0.0, jnp.asarray(10.0)))
    got = solver.dichotomy(lambda x: torch.tanh(root - x), 0.0,
                           torch.tensor(10.0, dtype=torch.float64))
    assert got.dtype == torch.float64 and got.dim() == 0
    if branch == "no root":
        assert np.isnan(expected) and bool(torch.isnan(got))
    else:
        assert float(got) == expected
        assert (float(got) == 10.0) == (branch == "whole interval")


def _tracked_target(obs):
    def logprior(x):
        return -0.5 * (x**2).sum(-1) / 9.0

    def loglik(x):
        return -0.5 * ((x - obs) ** 2).sum(-1)

    return logprior, loglik


def test_update_and_take_last_whole_and_in_chunks():
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((50, chip_smoke.SMC_D)))
    logprior, loglik = _tracked_target(torch.from_numpy(chip_smoke.SMC_OBS))

    def target(x):
        return logprior(x) + 0.3 * loglik(x)

    keys = prng.split(prng.key(8), 50)
    out = []
    for batch_size in [0, 16]:
        update, n = base.update_and_take_last(
            mala.init, target, lambda k, s, fn: mala.build_kernel()(k, s, fn, 0.2), 3, 50,
            batch_size=batch_size)
        out.append(update(keys, x, {}))
        assert n == 50
    (x0, info0), (x1, info1) = out
    assert torch.equal(x0, x1)
    assert info0.acceptance_rate.shape == info0.is_accepted.shape == (50, 3)
    assert torch.equal(info0.acceptance_rate, info1.acceptance_rate)
    assert torch.equal(info0.is_accepted, info1.is_accepted)


def reference_tracked_run(update_strategy=None, max_steps=chip_smoke.SMC_MAX_STEPS):
    """The tracked SMC configuration by the JAX package, from
    ``chip_smoke.smc_init`` and key 18 as ``chip_smoke.smc_run`` runs it,
    its step compiled once: each step's ``(state, info)``."""
    obs = jnp.asarray(chip_smoke.SMC_OBS)
    strategy = {} if update_strategy is None else {"update_strategy": update_strategy}
    algo = blackjax_tpu.adaptive_tempered_smc(
        lambda x: -0.5 * jnp.sum(x**2) / 9.0,
        lambda x: -0.5 * jnp.sum((x - obs) ** 2),
        jmala.build_kernel(), jmala.init,
        {"step_size": jnp.full((1,), chip_smoke.SMC_STEP_SIZE)},
        jresampling.systematic, target_ess=chip_smoke.SMC_TARGET_ESS,
        num_mcmc_steps=None if update_strategy else chip_smoke.SMC_MCMC_STEPS, **strategy)
    step = jit(algo.step)
    state = algo.init(jnp.asarray(chip_smoke.smc_init(torch, N, "cpu", torch.float64)))
    key, steps = jax.random.key(18), []
    while float(state.tempering_param) < 1.0 and len(steps) < max_steps:
        key, step_key = jax.random.split(key)
        state, info = step(step_key, state)
        steps.append((state, info))
    return steps


def port_tracked_run(waste_free=False, max_steps=chip_smoke.SMC_MAX_STEPS):
    x0 = chip_smoke.smc_init(torch, N, "cpu", torch.float64)
    key = interop.prng_key(jax.random.key_data(jax.random.key(18)))
    return chip_smoke.smc_run(torch, x0, key, waste_free, max_steps)[1]


def assert_steps_match(steps, ref_steps):
    """Step by step: lambda and log-increments within 1e-10, particles
    within 1e-8, ancestors and accept flags identical."""
    assert len(steps) == len(ref_steps)
    for (state, info), (ref_state, ref_info) in zip(steps, ref_steps):
        np.testing.assert_allclose(float(state.tempering_param),
                                   float(ref_state.tempering_param), rtol=0, atol=1e-10)
        np.testing.assert_allclose(state.particles.numpy(), np.asarray(ref_state.particles),
                                   rtol=0, atol=1e-8)
        np.testing.assert_allclose(state.weights.numpy(), np.asarray(ref_state.weights),
                                   rtol=1e-8, atol=1e-12)
        np.testing.assert_array_equal(info.ancestors.numpy(), np.asarray(ref_info.ancestors))
        np.testing.assert_allclose(float(info.log_likelihood_increment),
                                   float(ref_info.log_likelihood_increment), rtol=0, atol=1e-10)
        np.testing.assert_array_equal(info.update_info.is_accepted.numpy(),
                                      np.asarray(ref_info.update_info.is_accepted))
        assert info.update_info.acceptance_rate.shape == ref_info.update_info.acceptance_rate.shape


@pytest.fixture(scope="module")
def slice_runs():
    """The tracked SMC configuration at N particles to lambda = 1, by the JAX
    package and by the port, from the same particles and keys."""
    return reference_tracked_run(), port_tracked_run()


def test_tracked_smc_step_by_step(slice_runs):
    ref_steps, steps = slice_runs
    assert float(steps[-1][0].tempering_param) == 1.0
    assert 4 <= len(steps) < chip_smoke.SMC_MAX_STEPS
    assert_steps_match(steps, ref_steps)


def test_waste_free_form_step_by_step():
    """Two steps of the tracked configuration's waste-free form
    (``waste_free_smc(N, 8)``, ``num_mcmc_steps=None``): infos ``(N/8, 7)``."""
    ref_steps = reference_tracked_run(
        jwaste_free_smc(N, chip_smoke.SMC_WASTE_FREE_P), max_steps=2)
    steps = port_tracked_run(waste_free=True, max_steps=2)
    assert_steps_match(steps, ref_steps)
    assert steps[0][1].update_info.is_accepted.shape == (N // 8, 7)


def test_tracked_smc_state_round_trips_through_interop(slice_runs):
    ref_state, ref_info = slice_runs[0][-1]
    state = interop.tempered_smc_state(ref_state)
    info = interop.smc_info(ref_info)
    assert type(state).__name__ == "TemperedSMCState" and state.tempering_param.dim() == 0
    np.testing.assert_array_equal(state.particles.numpy(), np.asarray(ref_state.particles))
    assert float(state.tempering_param) == float(ref_state.tempering_param)
    assert isinstance(info.update_info, mala.MALAInfo)
    np.testing.assert_array_equal(info.ancestors.numpy(), np.asarray(ref_info.ancestors))
